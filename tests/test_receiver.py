"""Joint multi-RX MMSE receiver (models/receiver) — estimate + equalize fused.

Coverage, in order of increasing integration depth:
  1. the serve-layout equalizer cores are pure relayouts of the oracle-tested
     reference-layout ones (ops/equalize), including the multi-RX per-port-CFO
     factored form's Gram-cancellation claim checked against an explicit dense
     construction;
  2. the dense receiver program == composing the public estimator per RX port
     with equalize.mmse_equalize on the host (same inputs, same combine rules);
  3. the factored receiver == the dense receiver when time_interp="none", with
     CFO on and two frequency hops (the per-subcarrier filter must be exact);
  4. end-to-end 2x2 MIMO: QPSK payload through two independent true channels
     with CFO is recovered symbol-exactly at high SNR;
  5. batched == single, problem by problem.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srsran_ce.models import estimator, receiver
from srsran_ce.ops import equalize
from srsran_ce.utils import synthetic


def _rand_cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_serve_core_matches_reference_layout():
    rng = np.random.default_rng(3)
    n_rx, nL, n_sc, n_sym = 4, 2, 48, 14
    h = _rand_cplx(rng, (n_rx, n_sc, n_sym, nL))
    y = _rand_cplx(rng, (n_rx, n_sc, n_sym))
    noise, beta = 0.05, 1.3
    x_ref, sinr_ref = equalize.mmse_equalize(
        jnp.asarray(y), jnp.asarray(h), jnp.asarray(noise), beta=beta
    )
    x_s, sinr_s = equalize.mmse_equalize_serve(
        jnp.asarray(np.moveaxis(y, 1, 2)),  # (n_rx, n_sym, n_sc)
        jnp.asarray(np.transpose(h, (0, 3, 2, 1))),  # (n_rx, nL, n_sym, n_sc)
        jnp.asarray(noise),
        beta=beta,
    )
    np.testing.assert_allclose(
        np.transpose(np.asarray(x_s), (2, 1, 0)), np.asarray(x_ref), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.transpose(np.asarray(sinr_s), (2, 1, 0)), np.asarray(sinr_ref), rtol=1e-9
    )


def test_factored_serve_gram_cancellation():
    """Per-RX unit-modulus rotations must cancel exactly in the Gram matrix:
    the factored serve core (one filter inverse per subcarrier) equals the dense
    per-RE solve on the explicit channel H[r, sc, sym] = P[r, :, sc]*rot[r, sym]."""
    rng = np.random.default_rng(11)
    n_rx, nL, n_sc, n_sym = 3, 2, 36, 14
    sym_start, n_alloc = 2, 9
    prof = _rand_cplx(rng, (n_rx, nL, n_sc))
    rot = np.exp(1j * rng.uniform(-np.pi, np.pi, (n_rx, n_sym)))  # per-port CFO phases
    y = _rand_cplx(rng, (n_rx, n_sc, n_sym))
    noise, beta = 0.02, 0.9

    h = np.einsum("rlc,rs->rcsl", prof, rot)  # (n_rx, n_sc, n_sym, nL) dense
    x_d, sinr_d = equalize.mmse_equalize(
        jnp.asarray(y), jnp.asarray(h), jnp.asarray(noise), beta=beta
    )
    x_f, sinr_f = equalize.mmse_equalize_factored_serve(
        jnp.asarray(np.moveaxis(y, 1, 2)),
        jnp.asarray(prof),
        jnp.asarray(rot),
        jnp.asarray(noise),
        sym_start,
        n_alloc,
        beta=beta,
    )
    x_d = np.asarray(x_d)[:, sym_start : sym_start + n_alloc, :]  # (n_sc, t, nL)
    np.testing.assert_allclose(
        np.transpose(np.asarray(x_f), (2, 1, 0)), x_d, rtol=1e-10
    )
    # dense SINR is time-invariant here (unit-modulus rotations): every symbol
    # must match the factored per-subcarrier SINR
    sinr_d = np.asarray(sinr_d)
    for t in range(n_sym):
        np.testing.assert_allclose(
            np.asarray(sinr_f).T, sinr_d[:, t, :], rtol=1e-9
        )


def _mimo_inputs(n_rx, n_layers=2, seeds=(0,), **kw):
    """Per-seed multi-RX parity inputs: each RX port is an independent synthetic
    case (its own channel + noise), all relabeled to share seed-derived case 0's
    pilots — parity tests feed both paths identical inputs, so physical
    consistency of the relabeled grid is irrelevant."""
    probs = []
    for s in seeds:
        cases = [
            synthetic.make_case(
                seed=1000 * s + r, n_layers=n_layers,
                **{"n_prbs": 24, **kw},
            )
            for r in range(n_rx)
        ]
        rg = np.stack([c.received_rg for c in cases])  # (n_rx, n_sc, n_sym)
        probs.append((rg, cases[0].pilots, cases[0]))
    return probs


@pytest.mark.parametrize("time_interp", ["none", "linear"])
def test_dense_receiver_matches_host_composition(time_interp):
    n_rx, nL = 2, 2
    ((rg, pil, case),) = _mimo_inputs(n_rx, nL, cfo_hz=250.0, time_interp=time_interp)
    data_beta = 1.2
    fn = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, mode="dense", data_beta=data_beta
    )
    out = fn(
        estimator.split_ri(rg), estimator.split_ri(pil), np.float64(case.beta)
    )

    # Host composition: public estimator per port, then the oracle-tested
    # reference-layout equalizer with the port-mean noise.
    res = [
        estimator.estimate(rg[r], pil, case.beta, case.hop1, case.hop2, case.config)
        for r in range(n_rx)
    ]
    h = np.stack([np.asarray(r.channel_est_rg) for r in res])  # (n_rx, n_sc, n_sym, nL)
    noise = np.mean([float(r.noise_est) for r in res])
    x_o, sinr_o = equalize.mmse_equalize(
        jnp.asarray(rg), jnp.asarray(h), jnp.asarray(noise), beta=data_beta
    )

    x = estimator.merge_ri(np.asarray(out.x))  # (nL, n_sym, n_sc)
    np.testing.assert_allclose(np.transpose(x, (2, 1, 0)), np.asarray(x_o), rtol=1e-8)
    np.testing.assert_allclose(
        np.transpose(np.asarray(out.sinr), (2, 1, 0)), np.asarray(sinr_o), rtol=1e-7
    )
    assert np.isclose(float(out.noise_est), noise)
    assert np.isclose(
        float(out.cfo_hz), np.mean([float(r.cfo_hz) for r in res]), rtol=1e-9
    )


def test_factored_receiver_matches_dense_two_hops():
    n_rx, nL = 2, 2
    ((rg, pil, case),) = _mimo_inputs(
        n_rx, nL, cfo_hz=300.0, two_hops=True, time_interp="none"
    )
    args = (estimator.split_ri(rg), estimator.split_ri(pil), np.float64(case.beta))
    f_d = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, mode="dense"
    )
    f_f = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, mode="factored"
    )
    out_d, out_f = f_d(*args), f_f(*args)
    x_d = estimator.merge_ri(np.asarray(out_d.x))
    x_f = estimator.merge_ri(np.asarray(out_f.x))
    np.testing.assert_allclose(x_f, x_d, rtol=1e-8, atol=1e-12)
    # factored sinr (n_hops, nL, n_sc) == dense sinr at each hop's symbols
    sinr_d = np.asarray(out_d.sinr)  # (nL, n_sym, n_sc)
    sinr_f = np.asarray(out_f.sinr)
    for h, hop in enumerate([case.hop1, case.hop2]):
        s0 = hop.start_symbol
        for t in range(s0, s0 + hop.n_allocated_symbols):
            np.testing.assert_allclose(sinr_f[h], sinr_d[:, t, :], rtol=1e-7)
    for name in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(
            float(getattr(out_f, name)), float(getattr(out_d, name)), rtol=1e-10
        )


def _synth_mimo_rx(cases, payload, cfo_hz, snr_db):
    """Rebuild each port's received grid from ITS true channel with a shared
    multi-layer payload + shared pilots (synthetic.make_case's payload model is
    single-port; this is the same construction with x summed over layers).
    payload: (n_sc, n_sym, nL) unit-energy symbols. Returns (n_rx, n_sc, n_sym)."""
    case = cases[0]
    pil = case.pilots
    nL = payload.shape[-1]
    n_sym = case.received_rg.shape[1]
    dmrs_syms = np.nonzero(case.hop1.dmrs_symbol_mask_np)[0]
    cfo_norm = cfo_hz / case.config.scs_hz
    cpds = case.config.cp_durations_np * case.config.scs_hz / 1000.0
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    cfo_rot = np.exp(1j * 2.0 * np.pi * np.cumsum(vec) * cfo_norm)
    noise_std = 10.0 ** (-snr_db / 20.0)
    rgs = []
    for r, c in enumerate(cases):
        H = c.true_channel  # (n_sc, n_sym, nL)
        rx = np.einsum("ksl,ksl->ks", H, payload)
        for cdm in range((nL + 1) // 2):
            re_full = np.kron(case.hop1.prb_mask_np, case.hop1.dmrs_re_mask_np[:, cdm])
            re_idx = np.nonzero(re_full)[0]
            l0, l1 = cdm * 2, min(nL, (cdm + 1) * 2)
            for j, s in enumerate(dmrs_syms):
                tx = np.zeros(re_idx.size, np.complex128)
                for l in range(l0, l1):
                    tx += case.beta * pil[:, j, l] * H[re_idx, s, l]
                rx[re_idx, s] = tx
        rx *= cfo_rot[None, :n_sym]
        nrng = np.random.default_rng(1234 + r)
        rx += noise_std * (
            nrng.standard_normal(rx.shape) + 1j * nrng.standard_normal(rx.shape)
        ) / np.sqrt(2.0)
        rgs.append(rx)
    return np.stack(rgs)


def test_end_to_end_mimo_qpsk_recovery():
    """2 RX ports, 2 layers: QPSK payload through two independent true channels
    (+CFO, 40 dB SNR) must come back symbol-exact after the joint receiver."""
    n_rx, nL, seed = 2, 2, 7
    cases = [
        synthetic.make_case(
            seed=seed + r, n_layers=nL, n_prbs=24, snr_db=40.0, cfo_hz=300.0
        )
        for r in range(n_rx)
    ]
    case = cases[0]
    pil = case.pilots
    n_sc, n_sym = case.received_rg.shape
    rng = np.random.default_rng(99)
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, (n_sc, n_sym, nL))))
    dmrs_syms = np.nonzero(case.hop1.dmrs_symbol_mask_np)[0]
    rg = _synth_mimo_rx(cases, qpsk, cfo_hz=300.0, snr_db=40.0)

    fn = receiver.build_receiver_ri(case.hop1, None, case.config, nL, n_rx)
    out = fn(estimator.split_ri(rg), estimator.split_ri(pil), np.float64(case.beta))
    x = estimator.merge_ri(np.asarray(out.x))  # (nL, n_sym, n_sc)
    x = np.transpose(x, (2, 1, 0))  # (n_sc, n_sym, nL)

    data_syms = np.setdiff1d(np.arange(n_sym), dmrs_syms)
    sent = qpsk[:, data_syms, :]
    got = x[:, data_syms, :]
    dec = np.sign(got.real) + 1j * np.sign(got.imag)
    ref = np.sign(sent.real) + 1j * np.sign(sent.imag)
    ser = float(np.mean(dec != ref))
    assert ser < 5e-3, f"{ser:.4f} symbol error rate"
    # Where the receiver itself reports good post-MMSE SINR (>20 dB — random
    # 2x2 channels are near-singular at a few subcarriers, where errors are
    # physics, not bugs), decisions must be exact and EVM consistent with SINR.
    sinr = np.asarray(out.sinr)[0].T  # factored: (nL, n_sc) -> (n_sc, nL)
    good = np.broadcast_to(sinr[:, None, :] > 100.0, sent.shape)
    assert good.mean() > 0.7  # the threshold must not mask the whole test away
    assert np.array_equal(dec[good], ref[good])
    evm = np.sqrt(
        np.mean(np.abs(got[good] - sent[good]) ** 2) / np.mean(np.abs(sent[good]) ** 2)
    )
    assert evm < 0.1, evm


def test_batched_matches_single():
    n_rx, nL = 2, 2
    probs = _mimo_inputs(n_rx, nL, seeds=(0, 1, 2), cfo_hz=150.0)
    case = probs[0][2]
    f1 = receiver.build_receiver_ri(case.hop1, case.hop2, case.config, nL, n_rx)
    fb = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, batched=True
    )
    rg_b = np.stack([estimator.split_ri(rg) for rg, _, _ in probs])
    pil_b = np.stack([estimator.split_ri(pil) for _, pil, _ in probs])
    beta_b = np.asarray([c.beta for _, _, c in probs], np.float64)
    out_b = fb(rg_b, pil_b, beta_b)
    for k, (rg, pil, c) in enumerate(probs):
        out1 = f1(estimator.split_ri(rg), estimator.split_ri(pil), np.float64(c.beta))
        np.testing.assert_allclose(
            np.asarray(out_b.x)[k], np.asarray(out1.x), rtol=1e-9, atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(out_b.sinr)[k], np.asarray(out1.sinr), rtol=1e-9
        )
        assert np.isclose(float(out_b.noise_est[k]), float(out1.noise_est))


def test_dp_receiver_matches_unsharded():
    """Batch-sharded receiver on the 8-virtual-device CPU mesh == the unsharded
    batched receiver, problem for problem (both factored-auto and dense)."""
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.data_parallel import build_dp_receiver

    n_rx, nL, B = 2, 2, 8
    probs = _mimo_inputs(n_rx, nL, seeds=tuple(range(B)), cfo_hz=200.0)
    case = probs[0][2]
    rg_b = np.stack([estimator.split_ri(rg) for rg, _, _ in probs])
    pil_b = np.stack([estimator.split_ri(pil) for _, pil, _ in probs])
    beta_b = np.asarray([c.beta for _, _, c in probs], np.float64)

    mesh = mesh_lib.make_mesh((8, 1), ("dp", "sp"))
    fn_dp = build_dp_receiver(case.hop1, case.hop2, case.config, nL, mesh)
    fn = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, batched=True
    )
    out_dp = fn_dp(rg_b, pil_b, beta_b)
    out = fn(rg_b, pil_b, beta_b)
    np.testing.assert_allclose(
        np.asarray(out_dp.x), np.asarray(out.x), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_allclose(
        np.asarray(out_dp.sinr), np.asarray(out.sinr), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(out_dp.noise_est), np.asarray(out.noise_est), rtol=1e-12
    )


@pytest.mark.parametrize("two_hops", [False, True])
def test_sp_receiver_matches_unsharded(two_hops):
    """Subcarrier-sharded receiver (dp=2 x sp=2) == unsharded batched receiver
    on single-hop and frequency-hopped geometries: the factored SP front plus
    shard-local equalization must be exact at every shard seam."""
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.subcarrier import build_sp_receiver

    n_rx, nL, B = 2, 2, 2
    kw = dict(cfo_hz=250.0)
    if two_hops:
        kw.update(two_hops=True, n_prbs=12)
    probs = _mimo_inputs(n_rx, nL, seeds=(0, 1), **kw)
    case = probs[0][2]
    rg_b = np.stack([estimator.split_ri(rg) for rg, _, _ in probs])
    pil_b = np.stack([estimator.split_ri(pil) for _, pil, _ in probs])
    beta_b = np.asarray([c.beta for _, _, c in probs], np.float64)

    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    fn_sp = build_sp_receiver(case.hop1, case.hop2, case.config, nL, mesh)
    fn = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, batched=True
    )
    out_sp = fn_sp(rg_b, pil_b, beta_b)
    out = fn(rg_b, pil_b, beta_b)
    np.testing.assert_allclose(
        np.asarray(out_sp.x), np.asarray(out.x), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_sp.sinr), np.asarray(out.sinr), rtol=1e-9, atol=1e-12
    )
    for name in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_sp, name)), np.asarray(getattr(out, name)),
            rtol=1e-9,
        )


@pytest.mark.parametrize("mode", ["dense", "factored"])
def test_llr_receiver_matches_host_demap(mode):
    """The fused LLR receiver == host-side demap.llrs on the equalized
    receiver's own outputs, to within one int8 quantization step (identical
    float math up to fusion reassociation; round() can flip at boundaries)."""
    from srsran_ce.ops import demap

    n_rx, nL = 2, 2
    kw = dict(cfo_hz=200.0, two_hops=True, n_prbs=12)
    if mode == "dense":
        kw["time_interp"] = "linear"  # forces the dense (per-RE) filter
    ((rg, pil, case),) = _mimo_inputs(n_rx, nL, **kw)
    hops = [h for h in (case.hop1, case.hop2) if h is not None]
    args = (estimator.split_ri(rg), estimator.split_ri(pil), np.float64(case.beta))
    scale = 8.0
    f_x = receiver.build_receiver_ri(case.hop1, case.hop2, case.config, nL, n_rx)
    f_l = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx,
        modulation="64qam", llr_scale=scale,
    )
    out_x, out_l = f_x(*args), f_l(*args)
    llr_l = np.stack([np.asarray(p) for p in out_l.llr])  # (nbits, nL, sym, sc)
    assert llr_l.dtype == np.int8

    x = estimator.merge_ri(np.asarray(out_x.x))  # (nL, n_sym, n_sc)
    sinr = np.asarray(out_x.sinr)
    if mode == "factored":  # (n_hops, nL, n_sc) -> per-RE grid
        sg = np.zeros(x.shape, np.float32)
        for h, hop in enumerate(hops):
            s0 = hop.start_symbol
            sg[:, s0 : s0 + hop.n_allocated_symbols, :] = sinr[h][:, None, :]
        sinr = sg
    ref = np.asarray(demap.llrs(jnp.asarray(x), jnp.asarray(sinr), "64qam"))
    ref_q = np.clip(np.round(ref * scale), -127, 127).astype(np.int64)
    got = np.moveaxis(llr_l, 0, -1).astype(np.int64)
    assert np.abs(got - ref_q).max() <= 1
    # measurements + sinr identical to the symbol receiver's
    np.testing.assert_allclose(np.asarray(out_l.sinr), np.asarray(out_x.sinr), rtol=1e-7)
    for name in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(
            float(getattr(out_l, name)), float(getattr(out_x, name)), rtol=1e-9
        )
    # outside the hop allocations: erasures (exact zeros)
    alloc = np.zeros(x.shape[1], bool)
    for hop in hops:
        alloc[hop.start_symbol : hop.start_symbol + hop.n_allocated_symbols] = True
    assert not np.any(llr_l[:, :, ~alloc, :])


def test_end_to_end_mimo_llr_bits():
    """Bits in -> soft bits out: a 16QAM payload's transmitted bits must match
    the fused receiver's LLR hard decisions wherever it reports good SINR."""
    from srsran_ce.ops import demap

    n_rx, nL, seed = 2, 2, 21
    cases = [
        synthetic.make_case(
            seed=seed + r, n_layers=nL, n_prbs=24, snr_db=35.0, cfo_hz=200.0
        )
        for r in range(n_rx)
    ]
    case = cases[0]
    n_sc, n_sym = case.received_rg.shape
    nbits = demap.bits_per_symbol("16qam")
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (n_sc, n_sym, nL, nbits))
    payload = demap.modulate(bits.reshape(n_sc, n_sym * nL * nbits), "16qam").reshape(
        n_sc, n_sym, nL
    )
    rg = _synth_mimo_rx(cases, payload, cfo_hz=200.0, snr_db=35.0)

    fn = receiver.build_receiver_ri(
        case.hop1, None, case.config, nL, n_rx, modulation="16qam"
    )
    out = fn(
        estimator.split_ri(rg), estimator.split_ri(case.pilots), np.float64(case.beta)
    )
    llr = np.stack([np.asarray(p) for p in out.llr], axis=-1)  # (nL, sym, sc, nbits)
    llr = np.moveaxis(llr, (0, 1, 2), (2, 1, 0))  # (n_sc, n_sym, nL, nbits)
    dec = (llr < 0).astype(np.int64)  # positive LLR = bit 0

    data_syms = np.setdiff1d(
        np.arange(n_sym), np.nonzero(case.hop1.dmrs_symbol_mask_np)[0]
    )
    sinr = np.asarray(out.sinr)[0].T  # (n_sc, nL)
    good = sinr > 100.0  # >20 dB post-MMSE SINR: decisions must be exact
    assert good.mean() > 0.6
    sel = np.ix_(np.arange(n_sc), data_syms, np.arange(nL))
    mask = np.broadcast_to(good[:, None, :, None], bits[sel].shape)
    assert np.array_equal(dec[sel][mask], bits[sel][mask])
    ber = float(np.mean(dec[sel] != bits[sel]))
    assert ber < 0.02, ber


def test_llr_receiver_batched_matches_single():
    probs = _mimo_inputs(2, 2, seeds=(0, 1), cfo_hz=150.0)
    case = probs[0][2]
    f1 = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, 2, 2, modulation="qpsk"
    )
    fb = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, 2, 2, batched=True, modulation="qpsk"
    )
    rg_b = np.stack([estimator.split_ri(rg) for rg, _, _ in probs])
    pil_b = np.stack([estimator.split_ri(pil) for _, pil, _ in probs])
    beta_b = np.asarray([c.beta for _, _, c in probs], np.float64)
    out_b = fb(rg_b, pil_b, beta_b)
    lb = np.stack([np.asarray(p) for p in out_b.llr], axis=1)  # (B, nbits, ...)
    for k, (rg, pil, c) in enumerate(probs):
        out1 = f1(estimator.split_ri(rg), estimator.split_ri(pil), np.float64(c.beta))
        l1 = np.stack([np.asarray(p) for p in out1.llr])
        d = np.abs(lb[k].astype(np.int64) - l1.astype(np.int64))
        assert d.max() <= 1  # vmap reassociation can flip round() at boundaries


def test_dp_llr_receiver_matches_unsharded():
    """DP-sharded fused-LLR receiver == unsharded batched one (int8, <=1 ulp
    of quantization from cross-program reassociation)."""
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.data_parallel import build_dp_receiver

    n_rx, nL, B = 2, 2, 8
    probs = _mimo_inputs(n_rx, nL, seeds=tuple(range(B)), cfo_hz=200.0)
    case = probs[0][2]
    rg_b = np.stack([estimator.split_ri(rg) for rg, _, _ in probs])
    pil_b = np.stack([estimator.split_ri(pil) for _, pil, _ in probs])
    beta_b = np.asarray([c.beta for _, _, c in probs], np.float64)

    mesh = mesh_lib.make_mesh((8, 1), ("dp", "sp"))
    fn_dp = build_dp_receiver(
        case.hop1, case.hop2, case.config, nL, mesh, modulation="64qam"
    )
    fn = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, batched=True, modulation="64qam"
    )
    out_dp, out = fn_dp(rg_b, pil_b, beta_b), fn(rg_b, pil_b, beta_b)
    ldp = np.stack([np.asarray(p) for p in out_dp.llr], axis=1)
    lu = np.stack([np.asarray(p) for p in out.llr], axis=1)
    assert ldp.dtype == np.int8
    d = np.abs(ldp.astype(np.int64) - lu.astype(np.int64))
    assert d.max() <= 1
    np.testing.assert_allclose(
        np.asarray(out_dp.sinr), np.asarray(out.sinr), rtol=1e-10
    )


@pytest.mark.parametrize("two_hops", [False, True])
def test_sp_llr_receiver_matches_unsharded(two_hops):
    """Subcarrier-sharded fused-LLR receiver == unsharded batched one (demap is
    shard-local; int8 outputs within one quantization step across programs)."""
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.subcarrier import build_sp_receiver

    n_rx, nL = 2, 2
    kw = dict(cfo_hz=250.0)
    if two_hops:
        kw.update(two_hops=True, n_prbs=12)
    probs = _mimo_inputs(n_rx, nL, seeds=(0, 1), **kw)
    case = probs[0][2]
    rg_b = np.stack([estimator.split_ri(rg) for rg, _, _ in probs])
    pil_b = np.stack([estimator.split_ri(pil) for _, pil, _ in probs])
    beta_b = np.asarray([c.beta for _, _, c in probs], np.float64)

    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    fn_sp = build_sp_receiver(
        case.hop1, case.hop2, case.config, nL, mesh, modulation="16qam"
    )
    fn = receiver.build_receiver_ri(
        case.hop1, case.hop2, case.config, nL, n_rx, batched=True, modulation="16qam"
    )
    out_sp, out = fn_sp(rg_b, pil_b, beta_b), fn(rg_b, pil_b, beta_b)
    lsp = np.stack([np.asarray(p) for p in out_sp.llr], axis=1)
    lu = np.stack([np.asarray(p) for p in out.llr], axis=1)
    assert lsp.dtype == np.int8
    d = np.abs(lsp.astype(np.int64) - lu.astype(np.int64))
    assert d.max() <= 1, d.max()
    np.testing.assert_allclose(
        np.asarray(out_sp.sinr), np.asarray(out.sinr), rtol=1e-9, atol=1e-12
    )
