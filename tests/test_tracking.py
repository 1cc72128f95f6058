"""Multi-slot tracking (models/tracking.py) — recursive refinement across soundings.

The reference is stateless per slot; the tracker blends successive soundings of
the same channel with an adaptive gain (running average on static channels,
snap-back on movement). No reference counterpart."""
import numpy as np
import jax.numpy as jnp

from srsran_ce.models import estimator, tracking
from srsran_ce.utils import synthetic


def _slots(n_slots, seed=5, snr_db=0.0, **kw):
    """Same channel/pilots re-sounded with independent noise per slot."""
    return [
        synthetic.make_case(seed=seed, snr_db=snr_db, noise_seed=1000 + s, **kw)
        for s in range(n_slots)
    ]


def _nmse(ch, truth):
    return float(np.sum(np.abs(ch - truth) ** 2) / (np.sum(np.abs(truth) ** 2) + 1e-30))


def _run_sequence(cases, fn, state):
    outs = []
    for c in cases:
        res, h, w = fn(
            estimator.split_ri(c.received_rg.astype(np.complex64)),
            estimator.split_ri(c.pilots.astype(np.complex64)),
            np.float32(c.beta),
            state[0],
            state[1],
        )
        state = (h, w)
        outs.append(res)
    return outs, state


def test_first_slot_matches_stateless():
    case = synthetic.make_case(seed=5, n_prbs=24, n_layers=2, snr_db=10.0)
    fn = tracking.build_tracked_ri(case.hop1, case.hop2, case.config, 2)
    state = tracking.init_state(case.hop1, case.hop2, case.config, 2)
    res, _, w = fn(
        estimator.split_ri(case.received_rg.astype(np.complex64)),
        estimator.split_ri(case.pilots.astype(np.complex64)),
        np.float32(case.beta),
        state[0],
        state[1],
    )
    ref = estimator.build_ri(case.hop1, case.hop2, case.config, 2)(
        estimator.split_ri(case.received_rg.astype(np.complex64)),
        estimator.split_ri(case.pilots.astype(np.complex64)),
        np.float32(case.beta),
    )
    np.testing.assert_allclose(
        np.asarray(res.channel_est_rg), np.asarray(ref.channel_est_rg), rtol=1e-5, atol=1e-6
    )
    assert float(w) >= 0.9  # first observation taken at full weight


def test_tracking_gains_on_static_channel():
    """8 soundings of a static channel at 0 dB: the tracked estimate must beat the
    single-slot estimate by several dB (running average ~ 9 dB at N=8)."""
    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    cases = _slots(8, snr_db=0.0, **kw)
    c0 = cases[0]
    fn = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 1)
    state = tracking.init_state(c0.hop1, c0.hop2, c0.config, 1)
    outs, _ = _run_sequence(cases, fn, state)
    truth = c0.true_channel
    single = estimator.estimate(
        c0.received_rg.astype(np.complex64), c0.pilots.astype(np.complex64),
        np.float32(c0.beta), c0.hop1, c0.hop2, c0.config,
    )
    nmse_single = _nmse(np.asarray(single.channel_est_rg).astype(np.complex128), truth)
    ch_last = estimator.merge_ri(np.asarray(outs[-1].channel_est_rg)).astype(np.complex128)
    nmse_tracked = _nmse(ch_last, truth)
    gain_db = 10 * np.log10(nmse_single / nmse_tracked)
    assert gain_db > 4.0, (nmse_single, nmse_tracked, gain_db)


def test_tracking_does_not_lag_changing_channel():
    """Independent channels per sounding (worst case): the tracker's gain must
    snap back toward 1, keeping NMSE within ~2x of single-slot."""
    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    cases = [
        synthetic.make_case(seed=50 + s, snr_db=20.0, **kw) for s in range(4)
    ]
    c0 = cases[0]
    fn = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 1)
    state = tracking.init_state(c0.hop1, c0.hop2, c0.config, 1)
    outs, _ = _run_sequence(cases, fn, state)
    for c, res in list(zip(cases, outs))[1:]:
        single = estimator.estimate(
            c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
            np.float32(c.beta), c.hop1, c.hop2, c.config,
        )
        n_s = _nmse(np.asarray(single.channel_est_rg).astype(np.complex128), c.true_channel)
        n_t = _nmse(
            estimator.merge_ri(np.asarray(res.channel_est_rg)).astype(np.complex128),
            c.true_channel,
        )
        assert n_t < 2.5 * n_s, (n_t, n_s)


def test_batched_tracking_independent_problems():
    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    seq_a = _slots(3, seed=5, snr_db=5.0, **kw)
    seq_b = _slots(3, seed=6, snr_db=5.0, **kw)
    c0 = seq_a[0]
    fn_b = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 1, batched=True)
    fn_1 = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 1)
    state_b = tracking.init_state(c0.hop1, c0.hop2, c0.config, 1, batch=2)
    states_1 = [
        tracking.init_state(c0.hop1, c0.hop2, c0.config, 1) for _ in range(2)
    ]
    for ca, cb in zip(seq_a, seq_b):
        rg = np.stack([
            estimator.split_ri(ca.received_rg.astype(np.complex64)),
            estimator.split_ri(cb.received_rg.astype(np.complex64)),
        ])
        pil = np.stack([
            estimator.split_ri(ca.pilots.astype(np.complex64)),
            estimator.split_ri(cb.pilots.astype(np.complex64)),
        ])
        beta = np.ones(2, np.float32)
        res_b, h_b, w_b = fn_b(rg, pil, beta, state_b[0], state_b[1])
        state_b = (h_b, w_b)
        for i, (c, st) in enumerate(zip((ca, cb), states_1)):
            r1, h1, w1 = fn_1(
                estimator.split_ri(c.received_rg.astype(np.complex64)),
                estimator.split_ri(c.pilots.astype(np.complex64)),
                np.float32(1.0),
                st[0],
                st[1],
            )
            states_1[i] = (h1, w1)
            np.testing.assert_allclose(
                np.asarray(res_b.channel_est_rg)[i],
                np.asarray(r1.channel_est_rg),
                rtol=1e-5,
                atol=1e-6,
            )


def test_tracked_factored_layout():
    """Tracking composes with the factored output: the reconstructed grid matches
    the ref-layout tracked result, and the threaded state is identical."""
    case = synthetic.make_case(seed=60, n_prbs=24, n_layers=2, snr_db=10.0, cfo_hz=200.0)
    args = (
        estimator.split_ri(case.received_rg.astype(np.complex64)),
        estimator.split_ri(case.pilots.astype(np.complex64)),
        np.float32(case.beta),
    )
    state = tracking.init_state(case.hop1, case.hop2, case.config, 2)
    f_ref = tracking.build_tracked_ri(case.hop1, case.hop2, case.config, 2)
    f_fac = tracking.build_tracked_ri(
        case.hop1, case.hop2, case.config, 2, out_layout="factored"
    )
    r_ref, h_ref, w_ref = f_ref(*args, state[0], state[1])
    r_fac, h_fac, w_fac = f_fac(*args, state[0], state[1])
    grid = estimator.reconstruct_factored(
        estimator.merge_ri(np.asarray(r_fac.profiles)),
        estimator.merge_ri(np.asarray(r_fac.sym_rot)),
        case.hop1,
        case.hop2,
    )
    ch_ref = estimator.merge_ri(np.asarray(r_ref.channel_est_rg))
    np.testing.assert_allclose(grid, ch_ref, rtol=1e-5, atol=1e-7)
    for a, b in zip(h_ref, h_fac):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(w_ref), np.asarray(w_fac))


def test_tracked_receiver_first_slot_matches_plain_and_then_improves():
    """models/receiver.build_tracked_receiver_ri: slot 0 (weight 0) must match
    the plain receiver (up to the phase-anchor multiply round trip, ~1 ulp);
    after several soundings of a static channel at low SNR the tracked
    receiver's hard-decision BER must not exceed the single-slot receiver's
    on the SAME input — with CFO compensation ON (the case that exposed the
    phase-anchor bug: un-anchored tracked profiles measured WORSE BER than
    single-slot despite 12 dB better channel NMSE)."""
    import numpy as np

    from srsran_ce.models import estimator, receiver, tracking
    from srsran_ce.utils.synthetic import make_mimo_case

    n_slots, n_rx, nL = 8, 2, 1
    mk = dict(n_rx=n_rx, modulation="qpsk", scramble=False, n_prbs=12,
              n_layers=nL, cfo_hz=200.0, cfo_compensate=True)
    cases = [
        make_mimo_case(seed=41, snr_db=0.0, noise_seed=500 + s, **mk)
        for s in range(n_slots)
    ]
    c0 = cases[0]
    fn_t = receiver.build_tracked_receiver_ri(
        c0.hop1, c0.hop2, c0.config, nL, n_rx, modulation="qpsk"
    )
    fn_p = receiver.build_receiver_ri(
        c0.hop1, c0.hop2, c0.config, nL, n_rx, modulation="qpsk"
    )
    state = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL, batch=n_rx)

    def ber(res, c):
        llr = np.stack([np.asarray(pl) for pl in res.llr], axis=-1)
        dec = (np.transpose(llr, (2, 1, 0, 3)) < 0).astype(np.uint8)
        m = np.broadcast_to(c.data_mask[:, :, None, None], c.bits.shape)
        return float(np.mean((dec != c.bits)[m]))

    res = rp = None
    for s, c in enumerate(cases):
        rg = estimator.split_ri(c.received_rg.astype(np.complex64))
        pil = estimator.split_ri(c.pilots.astype(np.complex64))
        beta = np.float32(c.beta)
        res, h, w = fn_t(rg, pil, beta, state[0], state[1])
        state = (h, w)
        rp = fn_p(rg, pil, beta)
        if s == 0:
            assert ber(res, c) == ber(rp, c), "slot 0 must equal the plain receiver"
    # the tracker accumulated the full running average on the static channel
    assert float(np.asarray(state[1]).min()) > n_slots - 2, np.asarray(state[1])
    # and the tracked receiver is at least as good in bits on the same input
    bt, bp = ber(res, cases[-1]), ber(rp, cases[-1])
    assert bt <= bp, (bt, bp)


def test_tracked_server_receiver_llrs():
    """serving.TrackedServer(out='llrs'): the stateful tracked multi-RX
    receiver served per stream — state advances across soundings and the
    final-slot hard decisions are at least as good as the stateless path."""
    import numpy as np

    from srsran_ce import serving
    from srsran_ce.utils.synthetic import make_mimo_case

    n_slots, n_rx, nL = 5, 2, 1
    mk = dict(n_rx=n_rx, modulation="qpsk", scramble=False, n_prbs=12,
              n_layers=nL, cfo_hz=200.0)
    cases = [
        make_mimo_case(seed=43, snr_db=0.0, noise_seed=900 + s, **mk)
        for s in range(n_slots)
    ]
    srv = serving.TrackedServer(batch_size=4, matmul_precision=None)
    res = None
    for c in cases:
        prob = serving.Problem(
            c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
            c.beta, c.hop1, c.hop2, c.config,
        )
        res = srv.process([prob], ["ue7"], out="llrs", modulation="qpsk")[0]
    assert isinstance(res, serving.LlrServeResult)
    c = cases[-1]
    plain = serving.process(
        [serving.Problem(c.received_rg.astype(np.complex64),
                         c.pilots.astype(np.complex64), c.beta,
                         c.hop1, c.hop2, c.config)],
        batch_size=4, out="llrs", modulation="qpsk", matmul_precision=None,
    )[0]

    def ber(r):
        dec = (r.llr < 0).astype(np.uint8)
        m = np.broadcast_to(c.data_mask[:, :, None, None], c.bits.shape)
        return float(np.mean((dec != c.bits)[m]))

    assert ber(res) <= ber(plain) + 1e-9, (ber(res), ber(plain))
    # stream state really accumulated (weight near the slot count)
    key = next(k for k in srv._state if k[1] == "ue7")
    assert float(np.asarray(srv._state[key][1]).min()) > n_slots - 2
    srv.reset("ue7")
    assert not any(k[1] == "ue7" for k in srv._state)


def test_tracked_server_mode_switch_resets_stream():
    """Switching a live stream between the grid and receiver mode families
    resets its tracking state (different state shapes — it cannot carry over,
    and must not silently fork into two per-mode states)."""
    import numpy as np

    from srsran_ce import serving
    from srsran_ce.utils.synthetic import make_case, make_mimo_case

    kw = dict(n_prbs=6, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    srv = serving.TrackedServer(batch_size=2, matmul_precision=None)
    for s in range(2):
        c = make_case(seed=91, snr_db=5.0, noise_seed=50 + s, **kw)
        prob = serving.Problem(
            c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
            c.beta, c.hop1, c.hop2, c.config,
        )
        srv.process([prob], ["s0"])
    assert any(k[1] == "s0" for k in srv._state)
    grid_keys = {k for k in srv._state if k[1] == "s0"}
    # switch the SAME stream to the receiver family: old state must be dropped
    m = make_mimo_case(seed=92, n_rx=2, modulation="qpsk", n_prbs=6, n_layers=1)
    prob = serving.Problem(
        m.received_rg.astype(np.complex64), m.pilots.astype(np.complex64),
        m.beta, m.hop1, m.hop2, m.config,
    )
    srv.process([prob], ["s0"], out="equalized")
    assert not (grid_keys & set(srv._state)), "grid-mode state survived the switch"
    new_keys = {k for k in srv._state if k[1] == "s0"}
    assert new_keys and new_keys.isdisjoint(grid_keys)
    # switching back resets again (fresh first sounding)
    c = make_case(seed=91, snr_db=5.0, noise_seed=60, **kw)
    prob = serving.Problem(
        c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
        c.beta, c.hop1, c.hop2, c.config,
    )
    srv.process([prob], ["s0"])
    assert not (new_keys & set(srv._state)), "receiver-mode state survived the switch back"
