"""Plan-driven JAX estimator — the production compute path.

Single-problem forward pass of the full srsRAN port-channel-estimator chain
(reference srs_channel_estimator + process_hop, ce_rule_baseline.py:507-953), built
from an `EstimatorPlan` so that the whole thing traces to ONE static-shape XLA
program: gathers with static index tables, K-tap shifted-add convolutions, one
4096-point batched IFFT per hop, and static Python loops over hops/CDM groups.

Layout: internally layer-major (n_layers, n_re[, n_dsym]) so per-layer ops batch on
the leading axis and vmap adds a clean problem axis in front.

Works in complex64 (the serving default) or complex128 (CPU x64 conformance runs) — dtype
follows the inputs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EstimatorConfig, HopConfig
from ..ops import dsp
from .plan import EstimatorPlan, HopPlan, make_plan


@jax.tree_util.register_dataclass
@dataclass
class EstimateResult:
    """Outputs of one estimation problem (reference return 6-tuple,
    ce_rule_baseline.py:768). `cfo_hz` is NaN when no hop had >= 2 DM-RS symbols
    (the reference returns an empty tensor; presence is a static plan property —
    see `EstimatorPlan.cfo_possible`)."""

    channel_est_rg: jnp.ndarray  # (n_sc, n_sym, n_layers) complex
    noise_est: jnp.ndarray  # scalar real
    rsrp: jnp.ndarray  # scalar real
    epre: jnp.ndarray  # scalar real
    time_alignment: jnp.ndarray  # scalar real, seconds
    cfo_hz: jnp.ndarray  # scalar real, Hz (NaN if not estimable)


@jax.tree_util.register_dataclass
@dataclass
class FactoredResult:
    """Rank-1 factored serving output (`out_layout="factored"`).

    When time interpolation is off, the dense grid the reference materializes is
    exactly rank-1 in time per hop: each hop broadcasts one smoothed frequency
    profile across its allocated symbols (ce_rule_baseline.py:333-358) and the
    final CFO rotation is a per-symbol scalar (ce_rule_baseline.py:938-945). So

        channel_est_rg[sc, sym, l] == profiles[h, l, sc] * sym_rot[sym]

    for `sym` in hop h's allocated symbol range and zero elsewhere (hop symbol
    ranges never overlap — reference assert, ce_rule_baseline.py:877-885).
    Returning the factors instead of the product shrinks the output ~n_sym x
    (14x for a full slot): the write cost and the device->host transfer of a
    serving pipeline drop with it, and a downstream equalizer can fold
    `sym_rot` into its own per-symbol pass instead of ever expanding the grid.
    Use `estimator.reconstruct_factored` to expand to the reference layout.
    """

    profiles: jnp.ndarray  # (n_hops, n_layers, n_sc) complex — zero outside band
    sym_rot: jnp.ndarray  # (n_sym,) complex — CFO rotation (ones when off)
    noise_est: jnp.ndarray  # scalar real
    rsrp: jnp.ndarray  # scalar real
    epre: jnp.ndarray  # scalar real
    time_alignment: jnp.ndarray  # scalar real, seconds
    cfo_hz: jnp.ndarray  # scalar real, Hz (NaN if not estimable)


def prefetch_plan_constants(plan: EstimatorPlan) -> None:
    """Eagerly compute device-resident plan constants (the CNN inpainting operators)
    BEFORE tracing, so the jitted program captures them as baked constants instead of
    re-deriving them inside the trace. Called by every builder."""
    if plan.config.interp != "cnn":
        return
    dtypes = [np.float32]
    if jax.config.jax_enable_x64:
        dtypes.append(np.float64)
    for hp in (plan.hop1, plan.hop2):
        if hp is None or hp.inpaint_schedules is None:
            continue
        for c in range(hp.n_cdm):
            transient, steady = hp.inpaint_schedules[c]
            total = len(transient) + steady
            if total > 16:
                for dt in dtypes:
                    dsp.inpaint_operator(hp.inpaint_known[c], total, dt)


def _virtual_pilots(
    h: jnp.ndarray, vp_matrix: Optional[np.ndarray], n_pils: int, precision
) -> jnp.ndarray:
    """Extrapolate n_pils virtual pilots to the left of h[..., :n_pils].

    h: (..., n_pils) complex — the first n_pils pilot estimates (pass a flipped tail
    to extrapolate past the right edge). Linear LS fit of modulus and unwrapped phase
    as two matmuls with the static fit matrix (ce_rule_baseline.py:69-140).
    """
    if n_pils == 1 or vp_matrix is None:
        # n==1 fit degenerates; reference extrapolates the constant value
        # (ce_rule_baseline.py:95-101).
        return jnp.repeat(h[..., :1], n_pils, axis=-1)
    rdtype = jnp.real(h).dtype
    M = jnp.asarray(vp_matrix.T, dtype=rdtype)  # (n_pils_in, n_virt)
    amp = jnp.abs(h)
    ph = dsp.unwrap_phase(jnp.angle(h))
    v_amp = jnp.matmul(amp, M, precision=precision)
    v_ph = jnp.matmul(ph, M, precision=precision)
    return (v_amp * jnp.exp(1j * v_ph)).astype(h.dtype)


def _use_fused_smooth(hp_plan: HopPlan) -> bool:
    """True when the filter chain runs as the fused plan matrices (XLA tier): the
    CDM pair-average is then folded into the matrices and _process_hop must NOT
    apply it explicitly."""
    return hp_plan.smoothing == "filter" and hp_plan.smooth_mat is not None


def _smooth_fused(hp_plan: HopPlan, config: EstimatorConfig, h_p: jnp.ndarray) -> jnp.ndarray:
    """Fused filter smoothing: pair-average + RC conv (+ alpha blend) as plan
    matrices (matmuls); only the virtual-pilot fit stays nonlinear.
    h_p: (n_layers, n_re) RAW (pre pair-average).

    Precision is PINNED to HIGHEST here regardless of config.matmul_precision:
    these matmuls are skinny (M = n_layers <= 8 rows against a dense (n_re, n_re)
    matrix of inexact entries), so they are latency-negligible next to the
    n_sc-wide grid fill — but at "high" (three bf16 passes) their ~1e-5 relative
    error DOMINATED the conformance NMSE on every multi-layer config (the
    round-2 "c2 outlier": 6.3e-11 vs ~5e-15 on 1-layer configs, which smooth
    via exact shifted-add convs instead). Bisected round 3: profiles carried
    the whole error; this pin takes c2 to 2.0e-11 at unchanged latency, and
    the remainder is the fill matmul (see _grid_fill — pinned on the ref
    conformance path, kept fast-at-"high" for serving)."""
    prec = jax.lax.Precision.HIGHEST
    rdtype = jnp.real(h_p).dtype

    def cmm(x, m):
        mr = jnp.asarray(m, dtype=rdtype)
        return jax.lax.complex(
            jnp.matmul(jnp.real(x), mr, precision=prec),
            jnp.matmul(jnp.imag(x), mr, precision=prec),
        )

    n_pils = hp_plan.n_pils
    e_l = cmm(h_p, hp_plan.pair_l_mat)  # == h_avg[:, :n_pils]
    e_r = cmm(h_p, hp_plan.pair_r_mat)
    vb = _virtual_pilots(e_l, hp_plan.vp_matrix, n_pils, prec)
    ve = _virtual_pilots(jnp.flip(e_r, axis=-1), hp_plan.vp_matrix, n_pils, prec)
    return (
        cmm(h_p, hp_plan.smooth_mat)
        + cmm(vb, hp_plan.smooth_vb_mat)
        + cmm(jnp.flip(ve, axis=-1), hp_plan.smooth_ve_mat)
    )


def _smooth_wiener(hp_plan: HopPlan, config: EstimatorConfig, h_p: jnp.ndarray) -> jnp.ndarray:
    """MMSE-optimal linear smoothing (smoothing="wiener" — no reference
    counterpart; plan builds R = U diag(lam) U^H from the exponential-PDP prior).

    Runtime: estimate the noise level from adjacent pilot differences and the
    channel power from the total, then apply the exact shrinkage
    h_s = U diag(lam / (lam + sigma^2/P)) U^H h — two complex matmuls with static
    eigenvector matrices and a continuous, per-problem SNR dependence.
    h_p: (n_layers, n_re) pair-averaged pilot estimates.
    """
    if hp_plan.wiener_u is None:
        return h_p  # degenerate (<2-point) pilot lattice: pass-through
    prec = dsp.precision_of(config.matmul_precision, h_p.dtype)
    rdtype = jnp.real(h_p).dtype
    h_d = h_p[:, ::2] if hp_plan.wiener_paired else h_p
    # adjacent differences: E|d|^2 = 2 sigma^2 + channel variation (the latter
    # makes this an upper bound -> slightly conservative shrinkage at high SNR)
    d = h_d[:, 1:] - h_d[:, :-1]
    sig2 = jnp.mean(jnp.real(d) ** 2 + jnp.imag(d) ** 2).astype(rdtype) / 2.0
    sig2 = jnp.maximum(sig2, jnp.asarray(1e-20, rdtype))
    pwr = jnp.mean(jnp.real(h_d) ** 2 + jnp.imag(h_d) ** 2).astype(rdtype)
    p_hat = jnp.maximum(pwr - sig2, jnp.asarray(1e-20, rdtype))

    u_r = jnp.asarray(np.real(hp_plan.wiener_u), rdtype)
    u_i = jnp.asarray(np.imag(hp_plan.wiener_u), rdtype)
    lam = jnp.asarray(hp_plan.wiener_lam, rdtype)
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)
    hr, hi = jnp.real(h_d).astype(rdtype), jnp.imag(h_d).astype(rdtype)
    # z = h @ conj(U)
    zr = mm(hr, u_r) + mm(hi, u_i)
    zi = mm(hi, u_r) - mm(hr, u_i)
    g = (lam / (lam + sig2 / p_hat))[None, :]
    zr = zr * g
    zi = zi * g
    # h_s = z @ U^T
    o_r = mm(zr, u_r.T) - mm(zi, u_i.T)
    o_i = mm(zr, u_i.T) + mm(zi, u_r.T)
    out = jax.lax.complex(o_r, o_i).astype(h_p.dtype)
    if hp_plan.wiener_paired:
        out = jnp.repeat(out, 2, axis=-1)
    return out


def _smooth(
    hp_plan: HopPlan,
    config: EstimatorConfig,
    h_p: jnp.ndarray,
    params=None,
) -> jnp.ndarray:
    """Frequency-domain smoothing switch (ce_rule_baseline.py:645-680; CNN alpha
    blend from ce_dl_cnn.py:690-717; trainable path via models/denoiser.py).
    h_p: (n_layers, n_re) — RAW when _use_fused_smooth (the pair-average lives in
    the fused matrices), pair-averaged otherwise."""
    smoothing = hp_plan.smoothing
    if smoothing == "none":
        return h_p
    if smoothing == "learned":
        from . import denoiser as _dn

        assert params is not None, "smoothing='learned' needs denoiser params"
        return _dn.apply_complex(params, h_p)
    if smoothing == "mean":
        return jnp.broadcast_to(jnp.mean(h_p, axis=-1, keepdims=True), h_p.shape)
    if smoothing == "wiener":
        return _smooth_wiener(hp_plan, config, h_p)
    # "filter"
    if _use_fused_smooth(hp_plan):
        return _smooth_fused(hp_plan, config, h_p)
    prec = dsp.precision_of(config.matmul_precision, h_p.dtype)
    n_pils = hp_plan.n_pils
    v_begin = _virtual_pilots(h_p[:, :n_pils], hp_plan.vp_matrix, n_pils, prec)
    tail_rev = jnp.flip(h_p[:, -n_pils:], axis=-1)
    v_end = _virtual_pilots(tail_rev, hp_plan.vp_matrix, n_pils, prec)
    x_ext = jnp.concatenate([v_begin, h_p, jnp.flip(v_end, axis=-1)], axis=-1)
    K = hp_plan.rc_taps.size
    hw = (K - 1) // 2
    y = dsp.conv_same_zero(x_ext, hp_plan.rc_taps)
    out = y[:, n_pils : y.shape[-1] - n_pils]
    if config.cnn_alpha > 0.0:
        alpha = min(1.0, max(0.0, config.cnn_alpha))
        out = out + alpha * (dsp.cnn_lowpass(out, passes=1) - out)
    return out


def _grid_fill(
    hp_plan: HopPlan,
    config: EstimatorConfig,
    h_p: jnp.ndarray,
    rows_per_layer: int = 1,
    prec=None,
) -> jnp.ndarray:
    """Interpolate pilot-position estimates to every subcarrier of the hop band.

    h_p: (n_layers, n_re) -> (n_layers, n_sc_hop). Linear path = one static gather +
    FMA per CDM group (replacing ce_rule_baseline.py:303-320); CNN path = fixed-point
    partial-conv inpainting with a precomputed mask schedule (ce_dl_cnn.py:473-508).
    rows_per_layer > 1: h_p carries that many consecutive rows per layer (the
    time-interp path packs (layer, dmrs_sym) layer-major) — CDM slices scale.

    `prec` overrides the fill-matmul precision (None = config.matmul_precision).
    The multi-layer fill matmul is the c2-NMSE-critical op: at "high" an M >= 2
    matmul runs three bf16 passes, which bounds the channel NMSE at ~1e-11
    EVEN with bf16-exact interp weights. The CONFORMANCE (ref-layout) path
    passes HIGHEST here while serving keeps the config precision with its
    documented NMSE bound (< 4e-11 at c2; ARCHITECTURE.md).
    """
    if prec is None:
        prec = dsp.precision_of(config.matmul_precision, h_p.dtype)
    outs = []
    for c, (l0, l1) in enumerate(hp_plan.layer_slices):
        vals = h_p[l0 * rows_per_layer : l1 * rows_per_layer]  # (n_l_c * rpl, n_re)
        if config.interp == "linear":
            if hp_plan.interp_matrix is not None:
                w = jnp.asarray(hp_plan.interp_matrix[c], dtype=jnp.real(vals).dtype)
                full = dsp.inpaint_matmul(vals, w, prec)  # one matmul vs three gathers
            else:
                full = dsp.lerp_gather(
                    vals, hp_plan.interp_left[c], hp_plan.interp_right[c], hp_plan.interp_alpha[c]
                )
        else:  # "cnn"
            known = hp_plan.inpaint_known[c]
            transient, steady = hp_plan.inpaint_schedules[c]
            total_iters = len(transient) + steady
            if total_iters > 16:
                # Deep iteration counts (e.g. 409 at 273 PRB): apply the exact
                # precomputed linear operator as one matmul instead of a
                # sequential conv chain (see dsp.inpaint_operator).
                w = dsp.inpaint_operator(known, total_iters, jnp.real(vals).dtype)
                full = dsp.inpaint_matmul(vals, w, prec)
            else:
                filled = np.nonzero(known)[0]
                sparse = jnp.zeros((vals.shape[0], hp_plan.n_sc_hop), dtype=vals.dtype)
                sparse = sparse.at[:, filled].set(vals)
                full = dsp.cnn_inpaint(sparse, known, 0, schedule=hp_plan.inpaint_schedules[c])
        outs.append(full)
    return jnp.concatenate(outs, axis=0)  # (n_layers, n_sc_hop)


def _serve_fill_xla_ri(
    hp_plan: HopPlan,
    config: EstimatorConfig,
    h_p: jnp.ndarray,  # (n_layers, n_re) complex
    rot_slice: jnp.ndarray,  # (n_alloc,) complex
) -> jnp.ndarray:
    """XLA-tier serve fill in EXPLICIT real (ri) arithmetic: interp einsums on the
    ri parts, rotate as real broadcast-FMAs, one stacked (2, nL, n_alloc, n_sc_hop)
    real output.

    Used ONLY for out_dtype="bfloat16" (the cast must land before the grid write).
    For f32 serving the COMPLEX fill path (with the ri conversion fused into
    the final write) is used instead; which of the two is faster on the GPU is
    not measured yet."""
    prec = dsp.precision_of(config.matmul_precision, h_p.dtype)
    rdtype = jnp.real(h_p).dtype
    frs, fis = [], []
    for c, (l0, l1) in enumerate(hp_plan.layer_slices):
        if config.interp == "linear" and hp_plan.interp_matrix is not None:
            w = jnp.asarray(hp_plan.interp_matrix[c], dtype=rdtype)
        elif config.interp == "cnn" and hp_plan.inpaint_schedules is not None:
            transient, steady = hp_plan.inpaint_schedules[c]
            w = dsp.inpaint_operator(hp_plan.inpaint_known[c], len(transient) + steady, rdtype)
        else:
            full = _grid_fill(hp_plan, config, h_p)  # gather fallback (complex)
            fr, fi = jnp.real(full), jnp.imag(full)
            frs, fis = [fr], [fi]
            break
        vals = h_p[l0:l1]
        frs.append(jnp.matmul(jnp.real(vals), w, precision=prec))
        fis.append(jnp.matmul(jnp.imag(vals), w, precision=prec))
    fr = jnp.concatenate(frs, axis=0) if len(frs) > 1 else frs[0]  # (nL, n_sc_hop)
    fi = jnp.concatenate(fis, axis=0) if len(fis) > 1 else fis[0]
    rr = jnp.real(rot_slice).astype(rdtype)[None, :, None]  # (1, n_alloc, 1)
    ri = jnp.imag(rot_slice).astype(rdtype)[None, :, None]
    fr_b = fr[:, None, :]
    fi_b = fi[:, None, :]
    return jnp.stack([fr_b * rr - fi_b * ri, fr_b * ri + fi_b * rr])


def _gather_rx(hp: HopPlan, received_rg: jnp.ndarray) -> jnp.ndarray:
    """Gather the hop's received pilot REs: (n_cdm, n_dsym, n_re), *time-major*:
    the long frequency axis stays minor-most (contiguous), so elementwise
    passes stream full rows instead of a length-2 minor axis. For contiguous
    comb allocations (the common case) the gather is pure static slices +
    reshape, with no index table."""
    if hp.fast_sel is not None:
        sc0, offsets = hp.fast_sel
        n_prbs_sel = hp.n_re // len(offsets[0])
        blk = received_rg[sc0 : sc0 + n_prbs_sel * 12]  # (12*n_prbs, n_sym)
        sym_sl = jnp.stack([blk[:, int(i)] for i in hp.dmrs_sym_idx], axis=0)
        b3 = sym_sl.reshape(hp.n_dsym, n_prbs_sel, 12)
        return jnp.stack(
            [
                jnp.stack([b3[:, :, o] for o in offs], axis=2).reshape(hp.n_dsym, hp.n_re)
                for offs in offsets
            ]
        )  # (n_cdm, n_dsym, n_re)
    rx_f = jnp.take(received_rg, jnp.asarray(hp.re_idx), axis=0)  # (n_cdm, n_re, n_sym)
    return jnp.stack([rx_f[:, :, int(i)] for i in hp.dmrs_sym_idx], axis=1)


def _process_hop(
    hp: HopPlan,
    config: EstimatorConfig,
    received_rg: jnp.ndarray,  # (n_sc, n_sym) complex
    pilots_h: jnp.ndarray,  # (n_re, n_dsym, n_layers) complex
    beta: jnp.ndarray,
    sst: Optional[np.ndarray],
    params=None,
):
    """One hop of the estimator (reference process_hop, ce_rule_baseline.py:507-755).

    Returns (epre_inc, cfo_hop|None, ta_inc, noise_inc, rsrp_inc, h_p, h_t) — the
    grid fill happens in _estimate_impl after the cross-hop CFO combine, so the
    rotation fuses into the single block write. h_t is the per-DM-RS-symbol
    smoothed estimate (nL*n_dsym, n_re) when time_interp is active, else None.
    """
    cdtype = received_rg.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    nL = hp.n_layers
    beta_r = beta.astype(rdtype)

    # --- Pilot RE gather + LS de-spread (ce_rule_baseline.py:583-605) ---
    rx = _gather_rx(hp, received_rg)  # (n_cdm, n_dsym, n_re)
    epre_inc = dsp.fro_norm_sq(rx)

    # Static row replication (NOT jnp.take: under vmap a traced gather of this
    # tiny 4-row lookup lowers to a batched gather + transpose).
    cdm_of_layer = np.arange(nL) // 2
    rx_l = jnp.concatenate(
        [rx[int(c) : int(c) + 1] for c in cdm_of_layer], axis=0
    )  # (nL, n_dsym, n_re)
    pil_l = jnp.transpose(pilots_h, (2, 1, 0))  # (nL, n_dsym, n_re)
    rec_x = rx_l * jnp.conj(pil_l)

    # --- CFO estimate / compensation (ce_rule_baseline.py:363-463) ---
    cfo_hop = None
    rec_x_nocfo = rec_x
    if hp.cfo_possible:
        if hp.cfo_pair_dt is not None:
            # WLS phase-slope fit over ALL consecutive DM-RS pairs
            # (config.cfo_estimator="wls", no reference counterpart): minimize
            # sum_j w_j (theta_j - 2 pi dt_j cfo)^2 with magnitude weights.
            num = jnp.zeros((), rdtype)
            den = jnp.zeros((), rdtype)
            for j in range(hp.n_dsym - 1):
                inner = jnp.sum(jnp.conj(rec_x[:, j, :]) * rec_x[:, j + 1, :], axis=-1)
                dt = float(hp.cfo_pair_dt[j])
                for c in range(hp.n_cdm):
                    pair = inner[2 * c] + (inner[2 * c + 1] if 2 * c + 1 < nL else 0.0)
                    w = jnp.abs(pair).astype(rdtype)
                    th = jnp.angle(pair).astype(rdtype)
                    num = num + w * dt * th
                    den = den + w * dt * dt
            cfo_hop = num / (2.0 * np.pi * jnp.maximum(den, jnp.asarray(1e-30, rdtype)))
        else:
            inner = jnp.sum(jnp.conj(rec_x[:, 0, :]) * rec_x[:, 1, :], axis=-1)  # (nL,)
            acc = jnp.zeros((), rdtype)
            for c in range(hp.n_cdm):
                pair = inner[2 * c] + (inner[2 * c + 1] if 2 * c + 1 < nL else 0.0)
                acc = acc + jnp.angle(pair).astype(rdtype)
            cfo_hop = acc / (2.0 * np.pi * hp.n_samples) / hp.n_cdm
        if config.cfo_compensate:
            sst_d = jnp.asarray(sst[hp.dmrs_sym_idx], dtype=rdtype)
            rot = jnp.exp(-1j * (2.0 * np.pi * sst_d * cfo_hop)).astype(cdtype)
            rec_x_nocfo = rec_x * rot[None, :, None]

    # --- Time average (ce_rule_baseline.py:625) ---
    h_p = jnp.sum(rec_x_nocfo, axis=1) / beta.astype(cdtype) / hp.n_dsym  # (nL, n_re)

    # --- CDM interference removal: adjacent-RE pair average (ce_rule_baseline.py:632-640).
    # Folded into the fused smoothing matrices when they run (see _smooth_fused).
    if nL >= 2 and not _use_fused_smooth(hp):
        m = hp.n_re // 2
        pairs = h_p[:, : 2 * m].reshape(nL, m, 2)
        avg = jnp.mean(pairs, axis=-1, keepdims=True)
        h_p = jnp.concatenate(
            [jnp.broadcast_to(avg, (nL, m, 2)).reshape(nL, 2 * m), h_p[:, 2 * m :]], axis=-1
        )

    # --- Smoothing (ce_rule_baseline.py:645-680) ---
    h_pre = h_p  # pre-smoothing pilot estimates (multi-slot tracking blends here:
    # raw adjacent differences are a valid noise proxy, smoothed ones are not)
    if hp.smoothing == "learned2d":
        # 2-D (time x freq) denoiser: the metrics path sees the time-averaged
        # profile as a single-symbol grid (models/denoiser.PilotDenoiser2D).
        from . import denoiser as _dn

        assert params is not None, "smoothing='learned2d' needs denoiser params"
        h_p = _dn.apply_complex_2d(params, h_p[:, None, :])[:, 0, :]
    else:
        h_p = _smooth(hp, config, h_p, params)

    # --- Per-DM-RS-symbol estimates for time interpolation (time_interp="linear",
    # no reference counterpart — see EstimatorConfig docs). Rows pack (layer,
    # dmrs_sym) layer-major so every row-wise smoothing path applies unchanged and
    # CDM slices stay contiguous; scalar metrics below keep using the
    # time-averaged h_p (exact reference parity).
    h_t = None
    if hp.time_interp_mat is not None:
        ht = (rec_x_nocfo / beta.astype(cdtype)).reshape(nL * hp.n_dsym, hp.n_re)
        if nL >= 2 and not _use_fused_smooth(hp):
            m = hp.n_re // 2
            rows = ht.shape[0]
            pairs = ht[:, : 2 * m].reshape(rows, m, 2)
            avg = jnp.mean(pairs, axis=-1, keepdims=True)
            ht = jnp.concatenate(
                [jnp.broadcast_to(avg, (rows, m, 2)).reshape(rows, 2 * m), ht[:, 2 * m :]],
                axis=-1,
            )
        if hp.smoothing == "learned2d":
            from . import denoiser as _dn

            h_t = _dn.apply_complex_2d(
                params, ht.reshape(nL, hp.n_dsym, hp.n_re)
            ).reshape(nL * hp.n_dsym, hp.n_re)
        else:
            h_t = _smooth(hp, config, ht, params)

    # --- Time alignment from the IFFT power-delay profile (ce_rule_baseline.py:684-710).
    # Only the first/last half_cp_len bins feed the argmax, so evaluate exactly those
    # via a direct DFT: two small matmuls instead of scattering into a
    # (4096, nL) buffer (which costs ~4 MB of HBM traffic per problem) and a full FFT.
    if hp.ta_dft_cos is not None:
        k = hp.ta_scatter_idx.size
        C = jnp.asarray(hp.ta_dft_cos, dtype=rdtype)
        S = jnp.asarray(hp.ta_dft_sin, dtype=rdtype)
        hr = jnp.real(h_p[:, :k])
        hi = jnp.imag(h_p[:, :k])
        prec = dsp.precision_of(config.matmul_precision, rdtype)
        mm = lambda a, b: jnp.matmul(a, b, precision=prec)
        re = mm(hr, C) - mm(hi, S)  # (nL, 2*half_cp_len)
        im = mm(hr, S) + mm(hi, C)
        pdp = jnp.sum(re**2 + im**2, axis=0)  # (2*half_cp_len,)
        head = pdp[: hp.half_cp_len]
        tail = pdp[hp.half_cp_len :]
    else:
        z = jnp.zeros((hp.fft_size, nL), dtype=cdtype)
        z = z.at[jnp.asarray(hp.ta_scatter_idx), :].set(h_p[:, : hp.ta_scatter_idx.size].T)
        ir = jnp.fft.ifft(z, axis=0)
        pdp = jnp.sum(jnp.abs(ir) ** 2, axis=1)
        head = pdp[: hp.half_cp_len]
        tail = pdp[-hp.half_cp_len :]
    i_delay = jnp.argmax(head)
    i_adv = jnp.argmax(tail)
    i_max = jnp.where(
        head[i_delay] >= tail[i_adv],
        i_delay.astype(rdtype),
        -(hp.half_cp_len - i_adv).astype(rdtype),
    )
    ta_inc = i_max / float(hp.fft_size) / float(config.scs_hz)

    # --- Reconstruct expected RX pilots; noise / RSRP (ce_rule_baseline.py:713-746) ---
    if config.cfo_compensate and cfo_hop is not None:
        sst_d = jnp.asarray(sst[hp.dmrs_sym_idx], dtype=rdtype)
        ph = jnp.exp(1j * (2.0 * np.pi * sst_d * cfo_hop)).astype(cdtype)  # (n_dsym,)
    else:
        ph = jnp.ones((hp.n_dsym,), dtype=cdtype)
    contrib = beta.astype(cdtype) * pil_l * (h_p[:, None, :] * ph[None, :, None])  # (nL, n_dsym, n_re)
    est_rx_parts = []
    for c, (l0, l1) in enumerate(hp.layer_slices):
        est_rx_parts.append(jnp.sum(contrib[l0:l1], axis=0))
    est_rx = jnp.stack(est_rx_parts, axis=0)  # (n_cdm, n_dsym, n_re)
    noise_inc = dsp.fro_norm_sq(rx - est_rx)
    rsrp_inc = (beta_r**2) * dsp.fro_norm_sq(h_p) * hp.n_dsym

    return epre_inc, cfo_hop, ta_inc, noise_inc, rsrp_inc, h_p, h_t, h_pre


def _estimate_impl(
    plan: EstimatorPlan,
    received_rg: jnp.ndarray,
    pilots: jnp.ndarray,
    beta: jnp.ndarray,
    params=None,
    out_layout: str = "ref",
    out_dtype=None,
    h_prev=None,
    track_w=None,
) -> EstimateResult:
    """h_prev/track_w: optional multi-slot tracking state (models/tracking.py) —
    per-hop previous pilot-lattice estimates and their accumulated weight. When
    given, each hop's smoothed estimate is blended with its predecessor by an
    adaptive gain before the grid fill, and the call returns
    (EstimateResult, (blended_h_ps, w_new)) instead of EstimateResult alone.
    Scalar metrics stay single-slot (reference parity)."""
    cdtype = received_rg.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    config = plan.config
    nL = plan.n_layers
    n_sc, n_sym = received_rg.shape
    sst = plan.symbol_start_time
    beta = jnp.asarray(beta, dtype=rdtype)

    # Output layout. "ref" = the reference's user-facing (sc, sym, layer) grid
    # (ce_rule_baseline.py:806). "serve" = subcarrier-last (layer, sym, sc):
    # the minor-most axis is the long frequency axis, so block writes are long
    # contiguous rows instead of a length-nL minor axis.
    assert out_layout in ("ref", "serve", "factored")
    # out_dtype: a real dtype (e.g. bfloat16) or the sentinel "ri" = the input's
    # native real dtype. Either way the grid buffer is ri-layout REAL (2, ...) from
    # the start and the serve fill runs in explicit real arithmetic — no complex
    # intermediates, no final complex->ri conversion pass (the builders use "ri"
    # for every serve-layout program; see _serve_fill_xla_ri for the measured why).
    assert out_dtype is None or out_layout == "serve", "out_dtype requires serve layout"
    if out_dtype == "ri":
        out_dtype = rdtype
    n_hops = 2 if plan.has_hop2 else 1
    if out_layout == "factored":
        # Rank-1-in-time output (see FactoredResult): valid only when each hop
        # broadcasts a single frequency profile over its symbols.
        assert plan.hop1.time_interp_mat is None and (
            not plan.has_hop2 or plan.hop2.time_interp_mat is None
        ), "out_layout='factored' requires time_interp='none'"
        channel = jnp.zeros((n_hops, nL, n_sc), dtype=cdtype)
    elif out_dtype is not None:
        grid_shape = (nL, n_sym, n_sc) if out_layout == "serve" else (n_sc, n_sym, nL)
        channel = jnp.zeros((2,) + grid_shape, dtype=out_dtype)
    else:
        grid_shape = (nL, n_sym, n_sc) if out_layout == "serve" else (n_sc, n_sym, nL)
        channel = jnp.zeros(grid_shape, dtype=cdtype)
    epre = jnp.zeros((), rdtype)
    noise = jnp.zeros((), rdtype)
    rsrp = jnp.zeros((), rdtype)
    ta = jnp.zeros((), rdtype)
    cfo = None

    hops = [(plan.hop1, pilots[:, : plan.n_dsym1, :])]
    if plan.has_hop2:
        hops.append((plan.hop2, pilots[:, plan.n_dsym1 :, :]))

    h_ps = []
    h_ts = []
    h_pres = []
    cfo_hs = []
    for hp, pil in hops:
        e_i, cfo_h, ta_i, n_i, r_i, h_p, h_t, h_pre = _process_hop(
            hp, config, received_rg, pil, beta, sst, params
        )
        epre = epre + e_i
        noise = noise + n_i
        rsrp = rsrp + r_i
        ta = ta + ta_i
        if cfo_h is not None:
            # Reference combine rule (ce_rule_baseline.py:617-621): average when both
            # hops estimate a CFO.
            cfo = cfo_h if cfo is None else (cfo + cfo_h) / 2.0
        h_ps.append(h_p)
        h_ts.append(h_t)
        h_pres.append(h_pre)
        cfo_hs.append(cfo_h)

    # --- Multi-slot tracking blend (models/tracking.py; no reference counterpart).
    # Pool the gain statistics across hops: sig2 = observation noise proxy from
    # adjacent pilot differences, innov = distance to the tracked state. Gain a
    # falls back to 1 on the first slot (w == 0), approaches the running-average
    # gain 1/(w+1) on static channels, and snaps back toward 1 when the
    # innovation exceeds the noise floor (channel moved).
    track_out = None
    if h_prev is not None:
        assert all(h_t is None for h_t in h_ts), "tracking requires time_interp='none'"
        # Phase-anchor each hop's observation before blending: with CFO
        # compensation on, this slot's raw pilot average carries the phase
        # exp(-j*2pi*t_bar*cfo_hat) of ITS OWN (noisy) CFO estimate at the
        # DM-RS-symbol centroid t_bar — a phase that the single-slot
        # reconstruction cancels internally (the final rotation re-applies the
        # same cfo_hat) but that is inconsistent ACROSS slots. The tracked
        # state therefore lives in the anchor-free (absolute) domain:
        # multiply by conj of that phase before blending, divide after —
        # without this, equalizing with tracked profiles measured WORSE
        # hard-decision BER than single-slot despite 12 dB better channel
        # NMSE (the current slot's full CFO-noise ramp lands on the tracked
        # profile un-anchored).
        anchors = []
        for (hp, _), cfo_h in zip(hops, cfo_hs):
            if config.cfo_compensate and cfo_h is not None:
                t_bar = float(np.mean(sst[hp.dmrs_sym_idx]))
                anchors.append(
                    jnp.exp(1j * (2.0 * np.pi * t_bar) * cfo_h).astype(cdtype)
                )
            else:
                anchors.append(None)
        h_obs = [
            h_pre if an is None else h_pre * an
            for h_pre, an in zip(h_pres, anchors)
        ]
        sig2 = jnp.zeros((), rdtype)
        innov = jnp.zeros((), rdtype)
        n_s = n_i = 0
        for h_ob, h_pr in zip(h_obs, h_prev):
            d = h_ob[:, 1:] - h_ob[:, :-1]
            sig2 = sig2 + jnp.sum(jnp.real(d) ** 2 + jnp.imag(d) ** 2) / 2.0
            e = h_ob - h_pr
            innov = innov + jnp.sum(jnp.real(e) ** 2 + jnp.imag(e) ** 2)
            n_s += d.size
            n_i += e.size
        sig2 = jnp.maximum(sig2 / max(n_s, 1), jnp.asarray(1e-30, rdtype))
        innov = jnp.maximum(innov / max(n_i, 1), jnp.asarray(1e-30, rdtype))
        w = track_w.astype(rdtype)
        a_static = 1.0 / (w + 1.0)
        # Static channel: innov ~ sig2 * (1 + 1/w) (both terms are noise) so
        # a_move clips to 0 and the running average a_static rules. A moved
        # channel pushes innov >> 2*sig2 and the gain snaps toward 1.
        a_move = jnp.clip(1.0 - 2.0 * sig2 / innov, 0.0, 1.0)
        a = jnp.maximum(a_static, a_move)
        a = jnp.where(w < 0.5, jnp.ones((), rdtype), a)
        a_c = a.astype(cdtype)
        h_blend = [h_pr + a_c * (h_ob - h_pr) for h_ob, h_pr in zip(h_obs, h_prev)]
        # Re-smooth the blended pilot estimates (rotated back into THIS slot's
        # compensation convention) — the tracked state lives in the raw
        # anchor-free domain so its noise statistics stay interpretable slot
        # to slot, and data-adaptive smoothers (wiener) see the averaged
        # (cleaner) input.
        h_ps = [
            _smooth(hp, config, h_b if an is None else h_b * jnp.conj(an), params)
            for (hp, _), h_b, an in zip(hops, h_blend, anchors)
        ]
        w_new = jnp.minimum(1.0 / jnp.maximum(a, jnp.asarray(1e-3, rdtype)), 64.0)
        track_out = (tuple(h_blend), w_new)

    # --- Normalization (ce_rule_baseline.py:914-935) ---
    rsrp = rsrp / plan.n_pilots / nL
    epre = epre / plan.n_pilots
    noise = noise / plan.noise_den
    if plan.has_hop2:
        ta = ta / 2.0

    # --- Grid-wide CFO phase rotation (ce_rule_baseline.py:938-945), folded into the
    # hop-block writes: the grid is zero outside the hop allocations, so rotating
    # only the blocks is identical and saves a full read+write pass over the grid.
    if config.cfo_compensate and cfo is not None:
        sst_j = jnp.asarray(sst, dtype=rdtype)  # (14,)
        rot = jnp.exp(1j * (2.0 * np.pi * sst_j * cfo)).astype(cdtype)
        # Reference broadcasts a length-14 vector over the symbol axis (assumes a
        # 14-symbol slot, ce_rule_baseline.py:944); preserve that contract.
        assert n_sym == rot.shape[0], "CFO grid rotation assumes a 14-symbol slot"
    else:
        rot = jnp.ones((n_sym,), dtype=cdtype)

    for h, ((hp, _), h_p, h_t) in enumerate(zip(hops, h_ps, h_ts)):
        if out_layout == "factored":
            # Store the hop's smoothed full-band profile; the symbol broadcast and
            # CFO rotation stay factored (profiles ⊗ sym_rot, see FactoredResult).
            full = _grid_fill(hp, config, h_p)  # (nL, n_sc_hop)
            channel = jax.lax.dynamic_update_slice(
                channel, full[None], (h, 0, hp.sc_start)
            )
            continue
        rot_slice = jax.lax.slice_in_dim(rot, hp.sym_start, hp.sym_start + hp.n_alloc_syms, axis=0)
        if h_t is not None:
            # Time-interpolated fill: per-symbol frequency profiles combined with
            # the static (n_alloc, n_dsym) weight matrix, then CFO-rotated.
            # ref layout = conformance: exact fill + combine (see _grid_fill)
            prec = (
                jax.lax.Precision.HIGHEST
                if out_layout == "ref"
                else dsp.precision_of(config.matmul_precision, rdtype)
            )
            full_t = _grid_fill(hp, config, h_t, rows_per_layer=hp.n_dsym, prec=prec)
            ft = full_t.reshape(nL, hp.n_dsym, hp.n_sc_hop)
            tm = jnp.asarray(hp.time_interp_mat.T, dtype=rdtype)  # (n_dsym, n_alloc)
            mm = lambda a: jnp.einsum("lds,dt->lts", a, tm, precision=prec)
            block = jax.lax.complex(mm(jnp.real(ft)), mm(jnp.imag(ft)))
            block = block * rot_slice[None, :, None]  # (nL, n_alloc, n_sc_hop)
            if out_layout == "serve":
                if out_dtype is not None:
                    blk_ri = _complex_to_ri(block).astype(out_dtype)
                    channel = jax.lax.dynamic_update_slice(
                        channel, blk_ri, (0, 0, hp.sym_start, hp.sc_start)
                    )
                else:
                    channel = jax.lax.dynamic_update_slice(
                        channel, block, (0, hp.sym_start, hp.sc_start)
                    )
            else:
                channel = jax.lax.dynamic_update_slice(
                    channel, jnp.transpose(block, (2, 1, 0)), (hp.sc_start, hp.sym_start, 0)
                )
            continue
        if out_layout == "serve":
            if out_dtype is not None:
                # Real-arithmetic fill: (2, nL, n_alloc, n_sc_hop), one write pass.
                blk_ri = _serve_fill_xla_ri(hp, config, h_p, rot_slice).astype(out_dtype)
                if (
                    n_hops == 1
                    and hp.sc_start == 0
                    and hp.n_sc_hop == n_sc
                    and hp.sym_start == 0
                    and hp.n_alloc_syms == n_sym
                ):
                    # Hop covers the whole grid: skip the copy-into-zeros pass.
                    channel = blk_ri
                else:
                    channel = jax.lax.dynamic_update_slice(
                        channel, blk_ri, (0, 0, hp.sym_start, hp.sc_start)
                    )
                continue
            full = _grid_fill(hp, config, h_p)  # (nL, n_sc_hop)
            block = full[:, None, :] * rot_slice[None, :, None]  # (nL, n_alloc, n_sc_hop)
            # The full-cover dynamic_update_slice is kept even when the block
            # covers the whole grid: XLA elides it, and it keeps the producer
            # fusion boundaries that an earlier measurement found faster than
            # returning the bare block (not re-measured on the GPU).
            channel = jax.lax.dynamic_update_slice(
                channel, block, (0, hp.sym_start, hp.sc_start)
            )
            continue
        # reference layout = the CONFORMANCE path: exact fill (see _grid_fill)
        full = _grid_fill(hp, config, h_p, prec=jax.lax.Precision.HIGHEST)
        block = full.T[:, None, :] * rot_slice[None, :, None]  # (n_sc_hop, n_alloc, nL)
        channel = jax.lax.dynamic_update_slice(channel, block, (hp.sc_start, hp.sym_start, 0))

    cfo_hz = (
        (cfo * config.scs_hz).astype(rdtype)
        if cfo is not None
        else jnp.full((), jnp.nan, dtype=rdtype)
    )
    if out_layout == "factored":
        res = FactoredResult(channel, rot, noise, rsrp, epre, ta, cfo_hz)
    else:
        res = EstimateResult(channel, noise, rsrp, epre, ta, cfo_hz)
    if track_out is not None:
        return res, track_out
    return res


# ---------------------------------------------------------------------------
# Public builders (jitted, cached per plan)
# ---------------------------------------------------------------------------
#
# Device-boundary layout (an API convention): all jitted entry points take and
# return REAL arrays with a leading re/im axis of size 2 ("ri layout") and
# recombine to complex *inside* the traced program (SURVEY.md §7 design stance
# #3). One real layout at every boundary keeps the host packer, the sharded
# builders and the serving scatter on a single array convention; complex math
# stays complex in-graph, where XLA lowers it to fused real arithmetic.


def _ri_to_complex(x_ri: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.complex(x_ri[0], x_ri[1])


def _complex_to_ri(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([jnp.real(x), jnp.imag(x)])


def result_to_ri(res, out_dtype=None):
    """In-graph conversion of a complex EstimateResult/FactoredResult to ri layout
    (the single definition every builder — serving, DP, tracked — goes through).
    With out_dtype the impl already produced a real (2, ...) grid buffer."""
    if isinstance(res, FactoredResult):
        return FactoredResult(
            profiles=_complex_to_ri(res.profiles),
            sym_rot=_complex_to_ri(res.sym_rot),
            noise_est=res.noise_est,
            rsrp=res.rsrp,
            epre=res.epre,
            time_alignment=res.time_alignment,
            cfo_hz=res.cfo_hz,
        )
    ch = res.channel_est_rg
    return EstimateResult(
        channel_est_rg=ch if out_dtype is not None else _complex_to_ri(ch),
        noise_est=res.noise_est,
        rsrp=res.rsrp,
        epre=res.epre,
        time_alignment=res.time_alignment,
        cfo_hz=res.cfo_hz,
    )


def split_ri(x: np.ndarray) -> np.ndarray:
    """Host-side complex -> (2, ...) real-pair conversion."""
    x = np.asarray(x)
    rdt = np.float64 if x.dtype == np.complex128 else np.float32
    return np.stack([x.real.astype(rdt), x.imag.astype(rdt)])


def merge_ri(x_ri: np.ndarray) -> np.ndarray:
    """Host-side (2, ...) real-pair -> complex conversion.

    Writes through .real/.imag views: two plain copy passes, no complex-multiply
    temporaries (`re + 1j*im` costs ~3 full passes plus two temporaries — it
    dominated serving's host-side scatter before this)."""
    x_ri = np.asarray(x_ri)
    cdt = np.complex128 if x_ri.dtype == np.float64 else np.complex64
    out = np.empty(x_ri.shape[1:], cdt)
    out.real = x_ri[0]
    out.imag = x_ri[1]
    return out


def reconstruct_factored(
    profiles: np.ndarray,
    sym_rot: np.ndarray,
    hop1: HopConfig,
    hop2: Optional[HopConfig] = None,
    n_sym: int = 14,
) -> np.ndarray:
    """Expand a FactoredResult to the reference-layout dense grid (host-side).

    profiles: (..., n_hops, n_layers, n_sc) complex; sym_rot: (..., n_sym) complex
    (leading batch axes allowed; use merge_ri first if holding ri arrays).
    Returns (..., n_sc, n_sym, n_layers) — identical to what out_layout="ref"
    would have materialized on device up to one ulp of the final complex multiply
    (numpy's and XLA's complex products round differently), exact where the CFO
    rotation is 1. Needs only the hop configs (symbol extents) — no plan build.
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    hop_cfgs = [hop1] + ([hop2] if hop2 is not None else [])
    profiles = np.asarray(profiles)
    sym_rot = np.asarray(sym_rot)
    *lead, n_hops, nL, n_sc = profiles.shape
    assert n_hops == len(hop_cfgs), (n_hops, len(hop_cfgs))
    grid = np.zeros((*lead, n_sc, n_sym, nL), dtype=profiles.dtype)
    for h, hc in enumerate(hop_cfgs):
        s0, s1 = hc.start_symbol, hc.start_symbol + hc.n_allocated_symbols
        prof = np.moveaxis(profiles[..., h, :, :], -2, -1)  # (..., n_sc, nL)
        grid[..., :, s0:s1, :] = (
            prof[..., :, None, :] * sym_rot[..., None, s0:s1, None]
        )
    return grid


@functools.lru_cache(maxsize=256)
def _build_ri_cached(plan_key, batched: bool, out_layout: str = "ref", out_dtype=None):
    hop1, hop2, config, n_layers = plan_key
    plan = make_plan(hop1, hop2, config, n_layers)
    prefetch_plan_constants(plan)
    # Serve-layout f32 programs use the COMPLEX fill (out_dtype=None) with the
    # ri conversion fused into the final write by XLA; _serve_fill_xla_ri is
    # the out_dtype="bfloat16" route (the cast must happen pre-write).
    def to_ri(res):
        return result_to_ri(res, out_dtype)

    if config.smoothing in ("learned", "learned2d"):
        # params pytree rides along as a replicated (non-batched) argument
        def single_p(rg_ri, pil_ri, beta, params):
            return to_ri(
                _estimate_impl(
                    plan,
                    _ri_to_complex(rg_ri),
                    _ri_to_complex(pil_ri),
                    beta,
                    params,
                    out_layout,
                    out_dtype,
                )
            )

        if batched:
            fn = jax.jit(jax.vmap(single_p, in_axes=(0, 0, 0, None)))
        else:
            fn = jax.jit(single_p)
        return fn

    def single(rg_ri, pil_ri, beta):
        return to_ri(
            _estimate_impl(
                plan,
                _ri_to_complex(rg_ri),
                _ri_to_complex(pil_ri),
                beta,
                None,
                out_layout,
                out_dtype,
            )
        )

    if batched:
        fn = jax.jit(jax.vmap(single))
    else:
        fn = jax.jit(single)
    return fn


def build_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    batched: bool = False,
    out_layout: str = "ref",
    out_dtype: Optional[str] = None,
):
    """Jitted `fn(rg_ri, pil_ri, beta) -> EstimateResult` in ri layout.

    rg_ri: (2, n_sc, n_sym) real; pil_ri: (2, n_re, n_dsym, n_layers) real; the
    returned channel_est_rg is (2, n_sc, n_sym, n_layers) real. With batched=True a
    leading problem axis B follows the ri axis on inputs ((B, 2, ...)) and outputs.
    This is the serving path: no complex arrays cross the device boundary.

    out_layout="serve" returns channel_est_rg as (2, n_layers, n_sym, n_sc) —
    subcarrier-last, the serving layout (block writes are long contiguous rows;
    with the "ref" (sc, sym, layer) layout the minor-most axis is n_layers<=4).
    Identical values, transposed.

    out_dtype="bfloat16" (serve layout only): half-size serving output — halves
    the grid's device-memory footprint and the device->host transfer volume;
    choose it for memory/egress (its effect on device time is not measured).
    Channel values carry ~2-3 significant digits (~4e-3 relative, NMSE ~1e-5);
    measurement scalars stay full precision. Not for conformance runs.

    out_layout="factored" returns a `FactoredResult` instead: profiles as
    (2, n_hops, n_layers, n_sc) and sym_rot as (2, n_sym) ri arrays — the exact
    rank-1 factorization of the grid (grid[sc,sym,l] = profiles[h,l,sc] *
    sym_rot[sym] over hop h's symbols). ~n_sym x smaller output; requires
    time_interp="none"; expand with `reconstruct_factored` when a dense grid is
    actually needed.
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert out_layout in ("ref", "serve", "factored")
    assert out_dtype in (None, "bfloat16"), "out_dtype: None or 'bfloat16'"
    assert out_dtype is None or out_layout == "serve", "out_dtype requires serve layout"
    if out_layout == "factored" and config.time_interp != "none":
        raise ValueError("out_layout='factored' requires time_interp='none'")
    return _build_ri_cached(
        (hop1, hop2, config, n_layers), batched, out_layout, out_dtype
    )


def build(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
):
    """Complex-friendly wrapper: `fn(received_rg, pilots, beta) -> EstimateResult`
    with numpy complex inputs/outputs (converted to ri layout at the host boundary).
    Calls sharing (hop1, hop2, config, n_layers) share one compiled executable."""
    fn_ri = build_ri(hop1, hop2, config, n_layers, batched=False)

    def fn(received_rg, pilots, beta):
        res = fn_ri(split_ri(received_rg), split_ri(pilots), jnp.asarray(beta))
        return EstimateResult(
            channel_est_rg=merge_ri(np.asarray(res.channel_est_rg)),
            noise_est=res.noise_est,
            rsrp=res.rsrp,
            epre=res.epre,
            time_alignment=res.time_alignment,
            cfo_hz=res.cfo_hz,
        )

    return fn


def build_batched(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
):
    """Batched front-end: `fn(received_rg[B], pilots[B], beta[B]) -> EstimateResult`
    with a leading problem axis on every output (SURVEY.md §2.3 'batched front-end';
    the (cell, UE, port, slot) problem tuple is flattened into B). Complex host API;
    use build_ri(batched=True) directly for the zero-conversion serving path."""
    fn_ri = build_ri(hop1, hop2, config, n_layers, batched=True)

    def fn(received_rg, pilots, beta):
        rg_ri = np.moveaxis(split_ri(received_rg), 0, 1)  # (B, 2, ...)
        pil_ri = np.moveaxis(split_ri(pilots), 0, 1)
        res = fn_ri(rg_ri, pil_ri, jnp.asarray(beta))
        ch = np.moveaxis(np.asarray(res.channel_est_rg), 1, 0)  # (2, B, ...)
        return EstimateResult(
            channel_est_rg=merge_ri(ch),
            noise_est=res.noise_est,
            rsrp=res.rsrp,
            epre=res.epre,
            time_alignment=res.time_alignment,
            cfo_hz=res.cfo_hz,
        )

    return fn


def estimate(
    received_rg,
    pilots,
    beta,
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
) -> EstimateResult:
    """Convenience one-shot API mirroring the reference call signature
    (srs_channel_estimator, ce_rule_baseline.py:761-768)."""
    n_layers = int(pilots.shape[-1])
    fn = build(hop1, hop2, config, n_layers)
    return fn(received_rg, pilots, beta)
