"""Estimation-quality evaluation: channel NMSE vs ground truth across SNR.

The reference can only be validated against srsRAN's dumped estimates (its own
output), so it has no way to ask "which smoothing strategy estimates the channel
*better*?". The synthetic generator carries the true channel
(utils/synthetic.SyntheticCase.true_channel), so this module measures end-to-end
estimation quality directly — and demonstrates the trainable denoiser
(smoothing="learned", no reference counterpart) beating the reference's fixed
RC-filter chain at low SNR.

Used by `python -m srsran_ce.validation.cli quality`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..config import NRE
from ..models import estimator
from ..utils import synthetic


def channel_nmse_vs_truth(
    smoothing: str,
    snr_db: float,
    params=None,
    n_cases: int = 12,
    seed0: int = 900,
    **case_kwargs,
) -> float:
    """Mean channel NMSE (linear) vs ground truth over `n_cases` synthetic problems.

    Compares only the allocated block (the estimate is defined as zero outside the
    hop allocation, reference ce_rule_baseline.py:806).
    """
    errs = []
    for i in range(n_cases):
        case = synthetic.make_case(
            seed=seed0 + i, snr_db=snr_db, smoothing=smoothing, **case_kwargs
        )
        nL = case.pilots.shape[2]
        fn = estimator.build_ri(case.hop1, case.hop2, case.config, nL)
        rg = estimator.split_ri(case.received_rg)
        pil = estimator.split_ri(case.pilots)
        if smoothing in ("learned", "learned2d"):
            assert params is not None, f"smoothing={smoothing!r} needs denoiser params"
            res = fn(rg, pil, jnp.asarray(case.beta), params)
        else:
            res = fn(rg, pil, jnp.asarray(case.beta))
        ch = estimator.merge_ri(np.asarray(res.channel_est_rg))
        err = den = 0.0
        for hop in [case.hop1] + ([case.hop2] if case.hop2 is not None else []):
            sc = slice(NRE * hop.prb_start, NRE * (hop.prb_start + hop.n_prbs))
            sy = slice(hop.start_symbol, hop.start_symbol + hop.n_allocated_symbols)
            est = ch[sc, sy, :]
            tru = case.true_channel[sc, sy, :]
            err += float(np.sum(np.abs(est - tru) ** 2))
            den += float(np.sum(np.abs(tru) ** 2))
        errs.append(err / (den + 1e-300))
    return float(np.mean(errs))


def geometry_sweep(
    params,
    snr_db: float = 0.0,
    n_prbs_list=(4, 52, 273),
    n_cases: int = 4,
    **case_kwargs,
) -> dict:
    """Learned-vs-filter channel NMSE (dB) across pilot-lattice geometries.

    The denoiser is fully convolutional, so ONE checkpoint must cover every
    serving geometry — narrowband 4 PRB (24 pilot REs at comb 2) through
    wideband 273 PRB (1638 REs). Returns
    {n_prbs: {"n_re", "learned_db", "filter_db", "gain_db", "learned_wins"}}.
    """
    import math

    out = {}
    for p in n_prbs_list:
        l_lin = channel_nmse_vs_truth(
            "learned", snr_db, params=params, n_cases=n_cases, n_prbs=int(p), **case_kwargs
        )
        f_lin = channel_nmse_vs_truth(
            "filter", snr_db, n_cases=n_cases, n_prbs=int(p), **case_kwargs
        )
        out[int(p)] = {
            "n_re": int(p) * 6,
            "learned_db": 10.0 * math.log10(l_lin + 1e-300),
            "filter_db": 10.0 * math.log10(f_lin + 1e-300),
            "gain_db": 10.0 * (math.log10(f_lin + 1e-300) - math.log10(l_lin + 1e-300)),
            "learned_wins": bool(l_lin <= f_lin),
        }
    return out


def doppler_sweep(
    dopplers_hz: Sequence[float] = (0.0, 100.0, 300.0, 600.0),
    snr_db: float = 30.0,
    n_cases: int = 8,
    params2d=None,
    **case_kwargs,
) -> Dict[str, Dict[float, float]]:
    """NMSE (dB) vs ground truth across Doppler for the time strategies:
    the reference's time-averaged broadcast (time_interp="none"), per-DM-RS-symbol
    linear time interpolation (time_interp="linear", no reference counterpart),
    and — when `params2d` is given — the trained 2-D time-frequency denoiser
    (smoothing="learned2d") on the same time-interp path.

    CFO injection is disabled: a per-tap Doppler spread is not a common frequency
    offset, and letting the CFO estimator chase it would measure the CFO model,
    not the time tracking.
    """
    rows = [("none", "filter", None), ("linear", "filter", None)]
    if params2d is not None:
        rows.append(("learned2d", "learned2d", params2d))
    out: Dict[str, Dict[float, float]] = {}
    for label, smoothing, params in rows:
        row = {}
        for dop in dopplers_hz:
            nmse = channel_nmse_vs_truth(
                smoothing,
                snr_db,
                params=params,
                n_cases=n_cases,
                doppler_hz=float(dop),
                time_interp="none" if label == "none" else "linear",
                cfo_hz=0.0,
                **case_kwargs,
            )
            row[float(dop)] = 10.0 * float(np.log10(nmse + 1e-300))
        out[label] = row
    return out


def delay_adapt_sweep(
    snr_db: float = 10.0,
    n_cases: int = 6,
    grid: Sequence[float] = (1e-9, 5e-8, 1.25e-7, 2.5e-7, 5e-7, 1e-6),
    **case_kwargs,
) -> Dict[str, Dict[str, float]]:
    """Fixed-prior vs auto-matched MMSE prior (serving.wiener_auto_delay), NMSE
    (dB) vs ground truth across channel dispersion classes (tap counts span
    flat -> rich multipath; the fixed prior is the 250 ns default)."""
    from .. import serving

    kw = dict(n_prbs=52, n_layers=1, cfo_hz=0.0)
    kw.update(case_kwargs)
    out: Dict[str, Dict[str, float]] = {}
    for label, taps in (("flat_1tap", 1), ("default_6tap", 6), ("rich_12tap", 12)):
        cases = [
            synthetic.make_case(
                seed=940 + i, snr_db=snr_db, smoothing="wiener", n_taps=taps, **kw
            )
            for i in range(n_cases)
        ]
        probs = [
            serving.Problem(
                c.received_rg.astype(np.complex64),
                c.pilots.astype(np.complex64),
                1.0,
                c.hop1,
                c.hop2,
                c.config,
            )
            for c in cases
        ]

        def nmse_db(results) -> float:
            err = den = 0.0
            for r, c in zip(results, cases):
                hop = c.hop1
                sc = slice(NRE * hop.prb_start, NRE * (hop.prb_start + hop.n_prbs))
                est = r.channel_est_rg[sc, :, :]
                tru = c.true_channel[sc, :, :]
                err += float(np.sum(np.abs(est - tru) ** 2))
                den += float(np.sum(np.abs(tru) ** 2))
            return 10.0 * float(np.log10(err / den + 1e-300))

        fixed = serving.process(probs, batch_size=max(4, n_cases), matmul_precision=None)
        auto = serving.process(
            probs, batch_size=max(4, n_cases), matmul_precision=None,
            wiener_auto_delay=tuple(grid),
        )
        out[label] = {"fixed_db": nmse_db(fixed), "auto_db": nmse_db(auto)}
    return out


def tracking_sweep(
    n_slots: int = 8,
    snr_db: float = 0.0,
    n_cases: int = 6,
    smoothing: str = "filter",
    **case_kwargs,
) -> Dict[str, float]:
    """Multi-slot tracking gain on a static channel: NMSE (dB) of the single-slot
    estimate vs the tracked estimate after `n_slots` soundings (models/tracking.py,
    no reference counterpart)."""
    from ..models import tracking

    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    kw.update(case_kwargs)
    single_err = tracked_err = 0.0
    den = 0.0
    for i in range(n_cases):
        cases = [
            synthetic.make_case(
                seed=7000 + i, snr_db=snr_db, smoothing=smoothing, noise_seed=100 * i + s, **kw
            )
            for s in range(n_slots)
        ]
        c0 = cases[0]
        nL = c0.pilots.shape[2]
        fn = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL)
        state = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL)
        res = None
        for c in cases:
            res, h, w = fn(
                estimator.split_ri(c.received_rg),
                estimator.split_ri(c.pilots),
                jnp.asarray(c.beta),
                state[0],
                state[1],
            )
            state = (h, w)
        single = estimator.estimate(
            c0.received_rg, c0.pilots, c0.beta, c0.hop1, c0.hop2, c0.config
        )
        truth = c0.true_channel
        single_err += float(np.sum(np.abs(np.asarray(single.channel_est_rg) - truth) ** 2))
        ch = estimator.merge_ri(np.asarray(res.channel_est_rg))
        tracked_err += float(np.sum(np.abs(ch - truth) ** 2))
        den += float(np.sum(np.abs(truth) ** 2))
    return {
        "single_slot_db": 10.0 * float(np.log10(single_err / den + 1e-300)),
        f"tracked_{n_slots}slots_db": 10.0 * float(np.log10(tracked_err / den + 1e-300)),
    }


def cfo_rmse_sweep(
    snrs_db: Sequence[float] = (0.0, 5.0, 10.0),
    cfo_hz: float = 220.0,
    n_cases: int = 24,
    n_dmrs_syms: int = 4,
    **case_kwargs,
) -> Dict[str, Dict[float, float]]:
    """CFO estimation RMS error (Hz) across SNR for the two CFO estimators:
    the reference's first-pair inner product vs the WLS phase-slope fit over all
    consecutive DM-RS pairs (cfo_estimator="wls", no reference counterpart)."""
    out: Dict[str, Dict[float, float]] = {}
    for mode in ("first_pair", "wls"):
        row = {}
        for snr in snrs_db:
            errs = []
            for i in range(n_cases):
                case = synthetic.make_case(
                    seed=3000 + i,
                    snr_db=float(snr),
                    cfo_hz=cfo_hz,
                    n_dmrs_syms=n_dmrs_syms,
                    cfo_estimator=mode,
                    **case_kwargs,
                )
                nL = case.pilots.shape[2]
                fn = estimator.build_ri(case.hop1, case.hop2, case.config, nL)
                res = fn(
                    estimator.split_ri(case.received_rg),
                    estimator.split_ri(case.pilots),
                    jnp.asarray(case.beta),
                )
                errs.append(float(res.cfo_hz) - cfo_hz)
            row[float(snr)] = float(np.sqrt(np.mean(np.square(errs))))
        out[mode] = row
    return out


def sweep(
    snrs_db: Sequence[float] = (0.0, 5.0, 10.0, 20.0),
    smoothings: Sequence[str] = ("filter", "wiener", "learned", "mean", "none"),
    params=None,
    n_cases: int = 12,
    **case_kwargs,
) -> Dict[str, Dict[float, float]]:
    """NMSE (dB) table {smoothing: {snr_db: nmse_db}}."""
    out: Dict[str, Dict[float, float]] = {}
    for sm in smoothings:
        row = {}
        for snr in snrs_db:
            nmse = channel_nmse_vs_truth(sm, snr, params=params, n_cases=n_cases, **case_kwargs)
            row[float(snr)] = 10.0 * float(np.log10(nmse + 1e-300))
        out[sm] = row
    return out


def ber_sweep(
    snrs_db: Sequence[float] = (0.0, 5.0, 10.0, 15.0, 20.0),
    modulation: str = "16qam",
    n_rx: int = 2,
    n_layers: int = 2,
    n_prbs: int = 24,
    n_cases: int = 4,
    seed0: int = 4200,
    scramble: bool = True,
    **case_kwargs,
) -> Dict[float, Dict[str, float]]:
    """Link-level uncoded BER vs SNR through the FULL receiver chain
    (estimate -> joint MMSE equalize -> max-log soft demap -> descramble),
    against the perfect-CSI MMSE bound on the same realizations.

    The reference has no link-level evaluation (it stops at the channel
    estimate); this closes the loop the way a PHY team actually judges an
    estimator — by the bit errors it costs downstream. Returns
    {snr_db: {"ber": ..., "ber_perfect_csi": ..., "n_bits": N}} scored on
    `data_mask` REs (hard decisions from the fused int8 LLR planes, descrambled
    by XOR with the transmitter's Gold stream).
    """
    from ..models import estimator, receiver
    from ..ops import demap
    from ..utils.synthetic import make_mimo_case, symbol_cfo_rotation

    def _perfect_csi_bits(case, nbits):
        """Hard decisions of the perfect-CSI MMSE receiver, float64 numpy on the
        host (the bound doesn't need a device at all).
        Same math as ops/equalize.mmse_equalize: x = (H^H H + sI)^-1 H^H y / β,
        s = N0/β², then alpha-unbias and nearest-constellation-point decision
        (= the sign pattern of the max-log LLRs)."""
        n_sym = case.received_rg.shape[-1]
        rot = symbol_cfo_rotation(case.config, case.cfo_hz, n_sym)
        h = case.true_channels * rot[None, None, :, None]  # (n_rx, sc, sym, nL)
        nL = h.shape[-1]
        H = np.transpose(h, (1, 2, 0, 3))  # (sc, sym, rx, nL)
        y = np.transpose(case.received_rg, (1, 2, 0))[..., None]  # (sc, sym, rx, 1)
        Hh = np.conj(np.swapaxes(H, -1, -2))
        s = case.noise_var  # data beta = 1
        inv = np.linalg.inv(Hh @ H + s * np.eye(nL))
        x = (inv @ (Hh @ y))[..., 0]  # (sc, sym, nL)
        d = np.real(np.einsum("...ll->...l", inv))
        sinr = np.maximum(1.0 / np.maximum(d * s, 1e-30) - 1.0, 0.0)
        alpha = sinr / (1.0 + sinr)
        xt = np.where(alpha > 0, x / np.maximum(alpha, 1e-30), 0.0)
        pts = demap.constellation(case.modulation)
        idx = np.argmin(np.abs(xt[..., None] - pts[None, None, None, :]), axis=-1)
        shifts = np.arange(nbits - 1, -1, -1)
        return ((idx[..., None] >> shifts) & 1).astype(np.uint8)  # (sc, sym, nL, nbits)

    out: Dict[float, Dict[str, float]] = {}
    for snr in snrs_db:
        errs = errs_ideal = total = 0
        for i in range(n_cases):
            case = make_mimo_case(
                seed=seed0 + i,
                n_rx=n_rx,
                modulation=modulation,
                scramble=scramble,
                snr_db=float(snr),
                n_prbs=n_prbs,
                n_layers=n_layers,
                **case_kwargs,
            )
            nbits = demap.bits_per_symbol(modulation)
            fn = receiver.build_receiver_ri(
                case.hop1, case.hop2, case.config, n_layers, n_rx,
                modulation=modulation,
            )
            res = fn(
                estimator.split_ri(case.received_rg),
                estimator.split_ri(case.pilots),
                jnp.asarray(case.beta),
            )
            llr = np.stack([np.asarray(p) for p in res.llr], axis=-1)  # (nL, sym, sc, nbits)
            dec = (np.transpose(llr, (2, 1, 0, 3)) < 0).astype(np.uint8)

            # Perfect-CSI MMSE bound: true per-port channels (incl. the CFO
            # ramp the receiver had to estimate) + true noise variance.
            dec_i = _perfect_csi_bits(case, nbits)

            if case.scramble_c is not None:
                dec = dec ^ case.scramble_c
                dec_i = dec_i ^ case.scramble_c
            mask = np.broadcast_to(
                case.data_mask[:, :, None, None], case.bits.shape
            )
            errs += int(np.sum((dec != case.bits) & mask))
            errs_ideal += int(np.sum((dec_i != case.bits) & mask))
            total += int(mask.sum())
        out[float(snr)] = {
            "ber": errs / total,
            "ber_perfect_csi": errs_ideal / total,
            "n_bits": total,
        }
    return out


def coded_ber_sweep(
    snrs_db: Sequence[float] = (8.0, 10.0, 12.0),
    modulation: str = "16qam",
    n_rx: int = 2,
    n_layers: int = 2,
    n_prbs: int = 24,
    n_cases: int = 2,
    seed0: int = 5100,
    code=None,
    n_iters: int = 25,
    scramble: bool = True,
    **case_kwargs,
) -> Dict[float, Dict[str, float]]:
    """CODED link-level evaluation: LDPC codewords through the FULL uplink
    chain — encode -> scramble -> Gray-QAM -> MIMO channel + CFO + AWGN ->
    estimate -> joint MMSE equalize -> fused int8 max-log demap -> descramble
    -> batched min-sum decode (ops/ldpc) — scored on the systematic payload.

    This is the end state the reference's channel estimate exists to serve
    (soft bits feeding a decoder); the reference itself stops at the estimate
    and has no coding anywhere. Codeword bits are scattered over the scored
    payload positions (`data_mask` REs) by a seeded pseudorandom channel
    interleaver (frequency fades are hundred-bit bursts in (sc, sym) order);
    positions the codewords don't fill stay random and are scored only by the
    uncoded counter. Channels/noise per seed are bit-independent, so coded vs
    uncoded compare on identical realizations.

    Returns {snr_db: {"coded_ber", "coded_bler", "parity_ok_frac",
    "uncoded_ber", "n_info_bits", "n_words"}}.
    """
    from .. import transport
    from ..models import receiver
    from ..ops import demap, ldpc
    from ..utils.synthetic import make_mimo_case

    if code is None:
        # rate ~0.63 array code, n=976: a few codewords per slot at 24 PRB
        code = ldpc.array_code(6, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    dec = ldpc.build_decoder(code, n_iters=n_iters)
    nbits = demap.bits_per_symbol(modulation)
    mk = dict(
        n_rx=n_rx, modulation=modulation, scramble=scramble,
        n_prbs=n_prbs, n_layers=n_layers, **case_kwargs,
    )

    out: Dict[float, Dict[str, float]] = {}
    for snr in snrs_db:
        info_errs = n_info = word_errs = n_words = ok_words = 0
        unc_errs = unc_total = 0
        for i in range(n_cases):
            seed = seed0 + i
            # geometry probe: a single-port make_case carries the same hops /
            # grid shape as the full MIMO link (make_mimo_case builds its
            # per-port cases from it) without drawing n_rx channels + noise
            geo = synthetic.make_case(
                seed=seed, snr_db=float(snr), n_prbs=n_prbs, n_layers=n_layers,
                **case_kwargs,
            )
            n_sc, n_sym = geo.received_rg.shape
            # Channel interleaver + placement via the shared transport layout
            # (fades are hundred-bit bursts in natural (sc, sym) order —
            # measured to defeat the code without interleaving).
            coding = transport.TransportCoding(code=code, interleave_seed=seed ^ 0xC0DED)
            lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
            mask, perm, c_words = lay.mask, lay.perm, lay.c_words
            rng = np.random.default_rng(seed ^ 0xC0DED)
            u = rng.integers(0, 2, (c_words, plan.k), dtype=np.uint8)
            bits = transport.place_codewords(lay, ldpc.encode(code, u), n_layers, nbits, fill_rng=rng)
            stream = bits[mask].reshape(-1)
            case = make_mimo_case(seed=seed, snr_db=float(snr), bits=bits, **mk)

            fn = receiver.build_receiver_ri(
                case.hop1, case.hop2, case.config, n_layers, n_rx,
                modulation=modulation,
            )
            res = fn(
                estimator.split_ri(case.received_rg),
                estimator.split_ri(case.pilots),
                jnp.asarray(case.beta),
            )
            llr = np.stack([np.asarray(p) for p in res.llr], axis=-1)
            llr = np.transpose(llr, (2, 1, 0, 3)).astype(np.float32)
            if case.scramble_c is not None:
                llr = demap.descramble_llrs(llr, case.scramble_c)
            cw_llrs = transport.extract_streams(lay, llr)
            d = dec(cw_llrs)
            info = np.asarray(d.info)
            info_errs += int(np.sum(info != u))
            n_info += int(u.size)
            word_errs += int(np.sum(np.any(info != u, axis=-1)))
            ok_words += int(np.sum(np.asarray(d.ok)))
            n_words += c_words
            tx = stream[perm].reshape(c_words, code.n)
            unc_errs += int(np.sum((cw_llrs < 0) != tx))
            unc_total += int(tx.size)
        out[float(snr)] = {
            "coded_ber": info_errs / n_info,
            "coded_bler": word_errs / n_words,
            "parity_ok_frac": ok_words / n_words,
            "uncoded_ber": unc_errs / unc_total,
            "n_info_bits": n_info,
            "n_words": n_words,
        }
    return out
