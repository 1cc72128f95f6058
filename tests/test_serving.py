"""Serving front-end: plan bucketing, tail padding, order preservation."""
import numpy as np

from srsran_ce import serving
from srsran_ce.models import estimator
from srsran_ce.utils import synthetic


def _problem(case):
    return serving.Problem(
        received_rg=case.received_rg.astype(np.complex64),
        pilots=case.pilots.astype(np.complex64),
        beta=float(case.beta),
        hop1=case.hop1,
        hop2=case.hop2,
        config=case.config,
    )


def test_heterogeneous_stream_matches_single_calls():
    """A shuffled mix of three plan signatures must return per-problem results in
    submission order, each matching the one-shot estimator."""
    specs = [
        dict(n_prbs=24, n_layers=1),
        dict(n_prbs=24, n_layers=2),
        dict(n_prbs=12, n_layers=1, two_hops=True),
        # beyond-parity modes flow through the same plan-signature bucketing
        dict(n_prbs=24, n_layers=1, time_interp="linear", doppler_hz=250.0),
        dict(n_prbs=24, n_layers=2, smoothing="wiener", cfo_estimator="wls"),
    ]
    cases = []
    for j, sp in enumerate(specs):
        for i in range(3):
            cases.append(synthetic.make_case(seed=37 + 10 * j + i, snr_db=30.0, **sp))
    rng = np.random.default_rng(0)
    order = rng.permutation(len(cases))
    problems = [_problem(cases[i]) for i in order]

    results = serving.process(problems, batch_size=4, matmul_precision=None)
    assert len(results) == len(problems)
    for r, i in zip(results, order):
        c = cases[i]
        ref = estimator.estimate(
            c.received_rg.astype(np.complex64),
            c.pilots.astype(np.complex64),
            np.float32(c.beta),
            c.hop1,
            c.hop2,
            c.config,
        )
        ch_ref = np.asarray(ref.channel_est_rg)
        nmse = np.sum(np.abs(r.channel_est_rg - ch_ref) ** 2) / (
            np.sum(np.abs(ch_ref) ** 2) + 1e-30
        )
        assert nmse < 1e-12, nmse
        np.testing.assert_allclose(r.noise_est, float(ref.noise_est), rtol=1e-6)
        np.testing.assert_allclose(r.cfo_hz, float(ref.cfo_hz), rtol=1e-6)


def test_tail_padding_shares_executable():
    """A bucket larger than batch_size must not compile a second shape for its
    tail chunk (repeat-padding) and must still return exact per-problem results."""
    cases = [synthetic.make_case(seed=100 + i, n_prbs=16, n_layers=1) for i in range(5)]
    problems = [_problem(c) for c in cases]
    results = serving.process(problems, batch_size=2, matmul_precision=None)
    for r, c in zip(results, cases):
        ref = estimator.estimate(
            c.received_rg.astype(np.complex64),
            c.pilots.astype(np.complex64),
            np.float32(c.beta),
            c.hop1,
            c.hop2,
            c.config,
        )
        ch_ref = np.asarray(ref.channel_est_rg)
        nmse = np.sum(np.abs(r.channel_est_rg - ch_ref) ** 2) / (
            np.sum(np.abs(ch_ref) ** 2) + 1e-30
        )
        assert nmse < 1e-12, nmse


def test_pipelined_dispatch_matches_serial():
    """inflight > 1 (async pipelined dispatch) must be bit-identical to the strict
    pack -> run -> fetch serialization (inflight=1), across mixed signatures and
    tail-padded chunks."""
    specs = [dict(n_prbs=16, n_layers=1), dict(n_prbs=24, n_layers=2)]
    cases = []
    for j, sp in enumerate(specs):
        for i in range(5):
            cases.append(synthetic.make_case(seed=500 + 10 * j + i, snr_db=25.0, **sp))
    problems = [_problem(c) for c in cases]
    serial = serving.process(problems, batch_size=2, matmul_precision=None, inflight=1)
    piped = serving.process(problems, batch_size=2, matmul_precision=None, inflight=4)
    for a, b in zip(serial, piped):
        np.testing.assert_array_equal(a.channel_est_rg, b.channel_est_rg)
        assert a.noise_est == b.noise_est and a.cfo_hz == b.cfo_hz


def test_delay_spread_estimator():
    """Flat channels read ~0; the default dispersive TDL reads in the plausible
    range; 2-layer OCC'd problems work through the pair-averaged lattice."""
    flat = synthetic.make_case(seed=1, n_prbs=52, n_layers=1, n_taps=1, snr_db=10.0)
    tau_flat = serving.estimate_delay_spread(_problem(flat))
    assert tau_flat < 5e-8, tau_flat
    disp = synthetic.make_case(seed=2, n_prbs=52, n_layers=1, snr_db=10.0)
    tau_disp = serving.estimate_delay_spread(_problem(disp))
    assert 3e-8 < tau_disp < 1e-6, tau_disp
    disp2 = synthetic.make_case(seed=3, n_prbs=52, n_layers=2, snr_db=10.0)
    tau_2l = serving.estimate_delay_spread(_problem(disp2))
    assert 3e-8 < tau_2l < 1e-6, tau_2l


def test_wiener_auto_delay_matches_prior_to_channel():
    """On flat channels at low SNR, the auto-matched MMSE prior must beat the
    default 250 ns prior clearly (a flat channel supports maximal smoothing)."""
    import dataclasses

    grid = (2e-8, 1e-7, 2.5e-7, 1e-6)
    cases = [
        synthetic.make_case(seed=20 + i, n_prbs=52, n_layers=1, n_taps=1,
                            snr_db=0.0, cfo_hz=0.0, smoothing="wiener")
        for i in range(4)
    ]
    problems = [_problem(c) for c in cases]
    fixed = serving.process(problems, batch_size=4, matmul_precision=None)
    auto = serving.process(problems, batch_size=4, matmul_precision=None,
                           wiener_auto_delay=grid)

    def nmse_db(r, c):
        sym = 4
        err = r.channel_est_rg[:, sym, :] - c.true_channel[:, sym, :]
        e = np.sum(np.abs(err) ** 2) / np.sum(np.abs(c.true_channel[:, sym, :]) ** 2)
        return 10.0 * np.log10(e)

    f = np.mean([nmse_db(r, c) for r, c in zip(fixed, cases)])
    a = np.mean([nmse_db(r, c) for r, c in zip(auto, cases)])
    assert a < f - 2.0, f"auto {a:.2f} dB vs fixed {f:.2f} dB"
    # non-wiener problems pass through wiener_auto_delay untouched
    plain = _problem(synthetic.make_case(seed=9, n_prbs=24, n_layers=1))
    r1 = serving.process([plain], batch_size=2, matmul_precision=None)
    r2 = serving.process([plain], batch_size=2, matmul_precision=None,
                         wiener_auto_delay=grid)
    np.testing.assert_array_equal(r1[0].channel_est_rg, r2[0].channel_est_rg)


def test_doppler_estimator_and_auto_time_interp():
    """Static channels read ~0 Hz and stay on the broadcast path; Doppler
    channels read high, get switched to time_interp, and track better."""
    static = synthetic.make_case(seed=4, n_prbs=52, n_layers=1, snr_db=30.0, cfo_hz=0.0)
    moving = synthetic.make_case(seed=5, n_prbs=52, n_layers=1, snr_db=30.0,
                                 cfo_hz=0.0, doppler_hz=600.0)
    f_static = serving.estimate_doppler(_problem(static))
    f_moving = serving.estimate_doppler(_problem(moving))
    assert f_static < 120.0, f_static
    assert f_moving > 250.0, f_moving

    problems = [_problem(static), _problem(moving)]
    plain = serving.process(problems, batch_size=2, matmul_precision=None)
    auto = serving.process(problems, batch_size=2, matmul_precision=None,
                           auto_time_interp_hz=150.0)
    # static problem: config untouched (same estimate up to batch-shape float
    # reassociation — the bucket composition changes when the moving problem
    # switches signature)
    np.testing.assert_allclose(
        plain[0].channel_est_rg, auto[0].channel_est_rg, rtol=2e-5, atol=1e-6
    )

    def nmse_db(r, c, sym):
        err = r.channel_est_rg[:, sym, :] - c.true_channel[:, sym, :]
        e = np.sum(np.abs(err) ** 2) / np.sum(np.abs(c.true_channel[:, sym, :]) ** 2)
        return 10.0 * np.log10(e)

    # moving problem: time interpolation must track far better at a mid-slot
    # symbol (6 sits between DM-RS symbols 4 and 9)
    gain = nmse_db(plain[1], moving, 6) - nmse_db(auto[1], moving, 6)
    assert gain > 5.0, f"time-interp gain only {gain:.2f} dB"


def test_tracked_server_gains_across_soundings():
    """TrackedServer threads per-stream state: re-sounding the same channels with
    fresh noise must reduce NMSE vs truth across calls (multi-slot tracking)."""
    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    streams = {
        "ue0": [synthetic.make_case(seed=80, snr_db=0.0, noise_seed=200 + s, **kw) for s in range(6)],
        "ue1": [synthetic.make_case(seed=81, snr_db=0.0, noise_seed=300 + s, **kw) for s in range(6)],
    }
    server = serving.TrackedServer(batch_size=4, matmul_precision=None)
    nmse_first = {}
    nmse_last = {}
    for s in range(6):
        probs, sids = [], []
        for sid, cases in streams.items():
            probs.append(_problem(cases[s]))
            sids.append(sid)
        res = server.process(probs, sids)
        for sid, cases, r in zip(streams.keys(), streams.values(), res):
            truth = cases[0].true_channel
            n = float(
                np.sum(np.abs(r.channel_est_rg - truth) ** 2) / np.sum(np.abs(truth) ** 2)
            )
            if s == 0:
                nmse_first[sid] = n
            nmse_last[sid] = n
    for sid in streams:
        assert nmse_last[sid] < 0.4 * nmse_first[sid], (sid, nmse_first[sid], nmse_last[sid])
    # reset drops the state: next call behaves like a first sounding again
    server.reset()
    assert not server._state


def test_serving_learned_smoothing_with_params():
    """serving.process supports learned modes: params pytree shared per call."""
    from srsran_ce.models import training
    import dataclasses as dc

    case = synthetic.make_case(seed=44, n_prbs=16, n_layers=1, snr_db=15.0, smoothing="none")
    cfg = dc.replace(case.config, smoothing="learned")
    n_re = case.pilots.shape[0]
    state, _ = training.init_state(seed=0, n_re=n_re)
    probs = [serving.Problem(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, cfg)]
    res = serving.process(probs, batch_size=2, matmul_precision=None, params=state.params)
    # zero-init residual == smoothing 'none'
    ref = estimator.estimate(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        np.float32(case.beta), case.hop1, case.hop2, case.config,
    )
    np.testing.assert_allclose(
        res[0].channel_est_rg, np.asarray(ref.channel_est_rg), atol=1e-6
    )


def test_factored_serving_matches_dense():
    """out='factored' returns rank-1 results whose .dense() matches grid serving;
    mixed signatures, shuffled order, tail padding."""
    import pytest

    specs = [
        dict(n_prbs=24, n_layers=1),
        dict(n_prbs=24, n_layers=2, smoothing="wiener"),
        dict(n_prbs=12, n_layers=1, two_hops=True),
    ]
    cases = []
    for j, sp in enumerate(specs):
        for i in range(3):
            cases.append(synthetic.make_case(seed=91 + 10 * j + i, snr_db=30.0, **sp))
    rng = np.random.default_rng(1)
    order = rng.permutation(len(cases))
    problems = [_problem(cases[i]) for i in order]

    dense = serving.process(problems, batch_size=4, matmul_precision=None)
    fact = serving.process(problems, batch_size=4, matmul_precision=None, out="factored")
    assert len(fact) == len(dense)
    for rf, rd in zip(fact, dense):
        assert isinstance(rf, serving.FactoredServeResult)
        np.testing.assert_allclose(rf.dense(), rd.channel_est_rg, rtol=2e-6, atol=1e-7)
        for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
            np.testing.assert_allclose(getattr(rf, f), getattr(rd, f), rtol=1e-6)
        # the factored payload really is ~n_sym x smaller
        assert rf.profiles.size + rf.sym_rot.size < rd.channel_est_rg.size / 3

    # time-interp problems are rejected in factored mode
    c = synthetic.make_case(seed=5, n_prbs=24, n_layers=1, time_interp="linear",
                            doppler_hz=200.0)
    with pytest.raises(ValueError):
        serving.process([_problem(c)], out="factored")
    with pytest.raises(ValueError):
        serving.process(problems, out="factored", auto_time_interp_hz=100.0)


def test_equalized_serving_matches_receiver_calls():
    """out="equalized" over a shuffled mix of single-RX and 2-RX problems,
    dense (time_interp) and factored (static) buckets: submission order, and
    every result matches a direct build_receiver_ri call on that problem."""
    from srsran_ce.models import receiver

    specs = [
        dict(n_rx=1, kw=dict(n_prbs=24, n_layers=1)),
        dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2)),
        dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2, time_interp="linear")),
        dict(n_rx=2, kw=dict(n_prbs=12, n_layers=1, two_hops=True)),
    ]
    cases, rgs = [], []
    for j, sp in enumerate(specs):
        for i in range(3):
            seed = 300 + 10 * j + i
            ports = [
                synthetic.make_case(seed=seed, noise_seed=500 + r, snr_db=30.0, **sp["kw"])
                for r in range(sp["n_rx"])
            ]
            cases.append(ports[0])
            rg = np.stack([p.received_rg for p in ports]).astype(np.complex64)
            rgs.append(rg[0] if sp["n_rx"] == 1 and j == 0 else rg)  # mix 2-D/3-D forms
    rng = np.random.default_rng(1)
    order = rng.permutation(len(cases))
    problems = []
    for i in order:
        c = cases[i]
        problems.append(
            serving.Problem(rgs[i], c.pilots.astype(np.complex64), float(c.beta),
                            c.hop1, c.hop2, c.config)
        )

    data_beta = 1.1
    results = serving.process(
        problems, batch_size=4, matmul_precision=None, out="equalized",
        data_beta=data_beta,
    )
    assert len(results) == len(problems)
    for r, i in zip(results, order):
        c = cases[i]
        rg = rgs[i] if rgs[i].ndim == 3 else rgs[i][None]
        n_rx, nL = rg.shape[0], c.pilots.shape[-1]
        fn = receiver.build_receiver_ri(
            c.hop1, c.hop2, c.config, nL, n_rx, data_beta=data_beta
        )
        ref = fn(estimator.split_ri(rg), estimator.split_ri(c.pilots.astype(np.complex64)),
                 np.float32(c.beta))
        x_ref = np.moveaxis(estimator.merge_ri(np.asarray(ref.x)), (0, 1, 2), (2, 1, 0))
        nmse = np.sum(np.abs(r.x - x_ref) ** 2) / (np.sum(np.abs(x_ref) ** 2) + 1e-30)
        # vmapped (served) vs single (reference) f32 programs reassociate the
        # equalizer's tiny-axis sums -> ~1e-9 NMSE drift, not an ordering bug
        assert nmse < 1e-7, nmse
        np.testing.assert_allclose(r.noise_est, float(ref.noise_est), rtol=1e-6)
        # SINR: factored buckets expand (hop, nL, sc) onto the grid host-side
        sinr_ref = np.asarray(ref.sinr)
        if c.config.time_interp == "none":
            hops = [c.hop1] + ([c.hop2] if c.hop2 is not None else [])
            for h, hc in enumerate(hops):
                s0 = hc.start_symbol
                blk = r.sinr[:, s0 : s0 + hc.n_allocated_symbols, :]
                np.testing.assert_allclose(
                    blk, np.broadcast_to(sinr_ref[h].T[:, None, :], blk.shape),
                    rtol=1e-3, atol=1e-3,  # f32 drift amplified where sinr ~ 0
                )
        else:
            np.testing.assert_allclose(
                r.sinr, np.moveaxis(sinr_ref, (0, 1, 2), (2, 1, 0)),
                rtol=1e-3, atol=1e-3,
            )


def test_multi_rx_requires_equalized():
    case = synthetic.make_case(seed=3, n_prbs=12)
    rg = np.stack([case.received_rg, case.received_rg]).astype(np.complex64)
    p = serving.Problem(rg, case.pilots.astype(np.complex64), 1.0,
                        case.hop1, case.hop2, case.config)
    import pytest

    with pytest.raises(ValueError, match="equalized"):
        serving.process([p])


def test_llr_serving_matches_receiver_calls():
    """out="llrs": a mixed dense/factored, 1-RX/2-RX stream comes back as int8
    soft bits in submission order, each matching a direct fused-LLR receiver
    call on that problem to within one quantization step."""
    import pytest

    from srsran_ce.models import receiver

    specs = [
        dict(n_rx=1, kw=dict(n_prbs=24, n_layers=1)),
        dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2, time_interp="linear")),
        dict(n_rx=2, kw=dict(n_prbs=12, n_layers=1, two_hops=True)),
    ]
    cases, rgs = [], []
    for j, sp in enumerate(specs):
        for i in range(2):
            ports = [
                synthetic.make_case(
                    seed=700 + 10 * j + i, noise_seed=800 + r, snr_db=30.0, **sp["kw"]
                )
                for r in range(sp["n_rx"])
            ]
            cases.append(ports[0])
            rgs.append(np.stack([p.received_rg for p in ports]).astype(np.complex64))
    rng = np.random.default_rng(2)
    order = rng.permutation(len(cases))
    problems = [
        serving.Problem(
            rgs[i], cases[i].pilots.astype(np.complex64), float(cases[i].beta),
            cases[i].hop1, cases[i].hop2, cases[i].config,
        )
        for i in order
    ]

    scale = 8.0
    results = serving.process(
        problems, batch_size=4, matmul_precision=None, out="llrs",
        modulation="16qam", llr_scale=scale,
    )
    assert len(results) == len(problems)
    for r, i in zip(results, order):
        c = cases[i]
        rg = rgs[i]
        n_rx, nL = rg.shape[0], c.pilots.shape[-1]
        assert r.llr.dtype == np.int8
        n_sc, n_sym = rg.shape[1], rg.shape[2]
        assert r.llr.shape == (n_sc, n_sym, nL, 4)
        fn = receiver.build_receiver_ri(
            c.hop1, c.hop2, c.config, nL, n_rx, modulation="16qam", llr_scale=scale
        )
        ref = fn(
            estimator.split_ri(rg),
            estimator.split_ri(c.pilots.astype(np.complex64)),
            np.float32(c.beta),
        )
        ref_stack = np.stack([np.asarray(p) for p in ref.llr])  # (nbits, nL, sym, sc)
        ref_llr = np.moveaxis(ref_stack, (0, 1, 2, 3), (3, 2, 1, 0))
        d = np.abs(r.llr.astype(np.int64) - ref_llr.astype(np.int64))
        assert d.max() <= 1, d.max()  # vmap reassociation can flip round()
        np.testing.assert_allclose(r.noise_est, float(ref.noise_est), rtol=1e-6)
        # dequantization helper round-trips
        np.testing.assert_allclose(r.llrs_float(), r.llr / scale, rtol=0)

    with pytest.raises(ValueError, match="modulation"):
        serving.process(problems, out="llrs")
