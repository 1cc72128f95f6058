"""Subcarrier-block sharding with overlap-save halo exchange (shard_map + ppermute).

This implements the north-star's sequence-parallel analog (SURVEY.md §5 "long-context
/ sequence parallelism"): one wideband estimation problem's frequency axis is split
into contiguous PRB blocks across the mesh axis `sp`, and the only cross-shard data
motion is

  - a (K-1)/2-pilot halo exchange (two `lax.ppermute`s) feeding the raised-cosine
    smoothing convolution — classic overlap-save; interior shards exchange *real*
    neighbor taps, only the outermost shards synthesize virtual pilots
    (ce_rule_baseline.py:661-676 is globally edge-aware; see SURVEY.md §7 hard parts),
  - a 1-pilot halo for the linear grid interpolation across seam gaps,
  - scalar psums (EPRE / noise / RSRP / CFO inner products),
  - one tiny all_gather of the smoothed pilot estimates (<= ~26 KB) for the
    4096-point IFFT time-alignment PDP, which is cheaper gathered than distributed.

Geometry restrictions for the overlap-save path (asserted): single hop covering the
whole grid, contiguous PRB mask, comb-uniform DM-RS RE masks (pilot every `comb`
subcarriers — true for all standard DM-RS/SRS comb patterns), shard count dividing
n_prbs. Frequency-hopped (two-hop) problems take a different sharded route — see
`HoppedShardPlan`: replicated tiny pilot front + sharded grid fill via full-grid-
embedded interpolation operators (BASELINE.json config[4]). Interpolation may be
linear (1-pilot halos) or CNN inpainting (each shard applies its column block of the
exact linear operator to the all_gathered pilots — no halos needed). All smoothing
modes are supported: "filter" (RC-FIR halo exchange + cnn_alpha 1-halo reflect
blend), "mean" (psum), "none", "learned" (the trainable denoiser with
layer-wise conv halo exchange — models/denoiser.apply_sharded; the built function
then takes the params pytree as a trailing replicated argument), and "wiener"
(global eigenbasis projection: gather the tiny raw pilot vector, shrink
replicated, keep the local slice), and "learned2d" (the 2-D time-frequency
denoiser with frequency-axis layer-wise halos — denoiser.apply_sharded_2d).
The general/irregular geometries use the DP path (independent problems scale out
embarrassingly); SP exists for wideband low-latency and for halo-exchange parity with
the north-star benchmark config.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import NRE, EstimatorConfig, HopConfig
from ..models import estimator as _est
from ..models.plan import EstimatorPlan, make_plan
from ..ops import dsp


@dataclass(eq=False)
class ShardPlan:
    """Static per-shard geometry derived from (EstimatorPlan, n_sp).

    When n_sp does not divide n_prbs, the global pilot/subcarrier axes are padded
    to the next shard-divisible size (pad = n_sp*R - n_re pilot slots, all on the
    LAST shard's tail): every shard still runs one static-shape program; the last
    shard's real pilot count is `n_rlast` (== R when no padding) and the filter /
    interp edge handling anchors the true band edge there. Padded input entries
    are zeros (they contribute nothing to the linear front), padded outputs are
    masked in smoothing and sliced off by the build_sp* wrappers."""

    plan: EstimatorPlan
    n_sp: int
    comb: int
    offs: Tuple[int, ...]  # per-CDM first-pilot offset within the comb
    L: int  # local subcarriers per shard (padded geometry)
    R: int  # local pilot REs per shard (per CDM, padded geometry)
    hw: int  # conv halo width = (K-1)//2, 0 if smoothing != filter
    pad: int  # padded pilot slots on the last shard's tail (0 if divisible)
    n_rlast: int  # real pilots on the last shard (== R when pad == 0)
    local_re_idx: np.ndarray  # (n_cdm, R) local sc index of local pilots
    interp_jl: np.ndarray  # (n_cdm, L) left anchor into halo-extended (R+2) array
    interp_jr: np.ndarray
    interp_alpha: np.ndarray  # (n_cdm, L)
    first_zone: np.ndarray  # (n_cdm, L) bool: q <= off_c (global constant-extrap zone)
    last_zone: np.ndarray  # (n_cdm, L) bool: q >= off_c + (n_rlast-1)*comb (last shard)


def _comb_structure(re_mask_col: np.ndarray) -> Tuple[int, int]:
    """Return (comb, offset) of an arithmetic-progression RE mask column, or raise."""
    pos = np.nonzero(re_mask_col)[0]
    assert pos.size > 0, "empty DMRS RE mask column"
    if pos.size == 1:
        comb = NRE
    else:
        d = np.diff(pos)
        assert np.all(d == d[0]), f"RE mask not comb-uniform: {pos}"
        comb = int(d[0])
    assert NRE % comb == 0 and pos[0] < comb, f"RE mask not a comb pattern: {pos}"
    return comb, int(pos[0])


def make_shard_plan(plan: EstimatorPlan, n_sp: int) -> ShardPlan:
    hp = plan.hop1
    hop = hp.hop
    assert plan.hop2 is None, "subcarrier sharding supports single-hop problems"
    assert plan.config.interp in ("linear", "cnn"), "unknown interpolation"
    prb_mask = hop.prb_mask_np
    assert prb_mask.all() and hop.prb_start == 0 and hop.n_prbs == prb_mask.size, (
        "subcarrier sharding requires a contiguous full-band hop"
    )

    re_mask = hop.dmrs_re_mask_np
    combs_offs = [_comb_structure(re_mask[:, c]) for c in range(hp.n_cdm)]
    combs = {c for c, _ in combs_offs}
    assert len(combs) == 1, "all CDM groups must share one comb"
    comb = combs.pop()
    offs = tuple(o for _, o in combs_offs)

    # Padded geometry: R = ceil(n_re / n_sp) pilot slots per shard; the last
    # shard holds n_rlast real pilots and `pad` zero-padded tail slots.
    R = -(-hp.n_re // n_sp)
    L = R * comb
    pad = n_sp * R - hp.n_re
    n_rlast = R - pad
    assert n_rlast >= 1, (
        f"n_sp={n_sp} too large for n_re={hp.n_re}: last shard would hold no pilots"
    )
    if hp.n_layers >= 2:
        # CDM pair averaging pairs adjacent pilots; an odd boundary would pair a
        # real pilot with padding.
        assert R % 2 == 0 and n_rlast % 2 == 0, (
            "CDM pair averaging requires even per-shard pilot counts "
            f"(R={R}, n_rlast={n_rlast}); choose a different n_sp"
        )
    if pad:
        assert plan.config.smoothing not in ("learned", "learned2d"), (
            "padded (non-divisible) sharding is not wired for learned smoothing: "
            "the denoiser's conv stack has no band-edge re-anchoring; choose an "
            "n_sp dividing n_prbs"
        )

    if plan.config.interp == "cnn":
        # Prefetch the exact inpainting operators eagerly (outside any trace).
        dtypes = [np.float32] + ([np.float64] if jax.config.jax_enable_x64 else [])
        for c in range(hp.n_cdm):
            transient, steady = hp.inpaint_schedules[c]
            for dt in dtypes:
                dsp.inpaint_operator(hp.inpaint_known[c], len(transient) + steady, dt)

    hw = 0
    if plan.config.smoothing == "filter":
        hw = (hp.rc_taps.size - 1) // 2
        assert n_rlast >= max(hw, hp.n_pils), (
            f"last shard's real pilot block ({n_rlast}) must cover halo ({hw}) "
            f"and virtual pilots ({hp.n_pils})"
        )
        if plan.config.cnn_alpha > 0.0:
            assert n_rlast >= 2, "cnn_alpha reflect padding needs >= 2 real local pilots"
    elif plan.config.smoothing == "learned":
        from ..models import denoiser as _dn

        hw = _dn.halo_width()
        assert R >= hw, f"local pilot block ({R}) must cover the denoiser halo ({hw})"
    elif plan.config.smoothing == "learned2d":
        from ..models import denoiser as _dn

        hw = _dn.halo_width_2d()
        assert R >= hw, f"local pilot block ({R}) must cover the 2-D denoiser halo ({hw})"

    local_re_idx = np.stack(
        [offs[c] + comb * np.arange(R, dtype=np.int32) for c in range(hp.n_cdm)]
    )

    q = np.arange(L)
    jl = np.empty((hp.n_cdm, L), np.int32)
    jr = np.empty((hp.n_cdm, L), np.int32)
    al = np.empty((hp.n_cdm, L), np.float64)
    fz = np.empty((hp.n_cdm, L), bool)
    lz = np.empty((hp.n_cdm, L), bool)
    for c in range(hp.n_cdm):
        off = offs[c]
        # anchors into the halo-extended pilot array hh of length R+2
        # (hh[0] = left neighbor's last pilot, hh[R+1] = right neighbor's first)
        jl[c] = np.floor_divide(q - off, comb) + 1
        jr[c] = jl[c] + 1
        al[c] = np.mod(q - off, comb) / comb
        fz[c] = q <= off
        # last-shard constant-extrapolation zone anchors at the last REAL pilot
        lz[c] = q >= off + (n_rlast - 1) * comb
    return ShardPlan(
        plan=plan,
        n_sp=n_sp,
        comb=comb,
        offs=offs,
        L=L,
        R=R,
        hw=hw,
        pad=pad,
        n_rlast=n_rlast,
        local_re_idx=local_re_idx,
        interp_jl=jl,
        interp_jr=jr,
        interp_alpha=al,
        first_zone=fz,
        last_zone=lz,
    )


def _psum_c(x: jnp.ndarray, axis: str) -> jnp.ndarray:
    """psum for complex values (summed as a real pair)."""
    return jax.lax.complex(
        jax.lax.psum(jnp.real(x), axis), jax.lax.psum(jnp.imag(x), axis)
    )


def _halo_exchange(x: jnp.ndarray, h: int, axis: str, n: int):
    """Exchange size-h halos along the last axis over mesh axis `axis`.

    Returns (left, right): left = left neighbor's last h entries (zeros on shard 0),
    right = right neighbor's first h entries (zeros on the last shard) — the zero
    fill matches the unsharded algorithm's zero padding at band edges.
    """
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    left = jax.lax.ppermute(x[..., -h:], axis, fwd)
    right = jax.lax.ppermute(x[..., :h], axis, bwd)
    return left, right


def _sharded_problem(
    sp: ShardPlan, axis: str, rg_ri_loc, pil_ri_loc, beta, params=None,
    out_layout: str = "ref", h_prev=None, track_w=None,
):
    """Per-shard body for ONE estimation problem.

    rg_ri_loc: (2, L, n_sym) local subcarrier block of the received grid (real pair)
    pil_ri_loc: (2, R, n_dsym, nL) local pilot block
    params: denoiser pytree, required iff config.smoothing is "learned"/"learned2d"
    Returns local EstimateResult with channel (2, L, n_sym, nL), or — with
    out_layout="factored" — a local FactoredResult with profiles (2, 1, nL, L)
    (sharded over the last axis) and a replicated sym_rot (estimator.FactoredResult
    semantics; requires time_interp="none").

    h_prev/track_w: multi-slot tracking state (models/tracking.py semantics) —
    h_prev is this shard's (nL, R) complex slice of the previous tracked pilot
    estimate, track_w the replicated weight. The gain statistics pool globally
    (psums; seam-adjacent pilot differences ride the existing 1-halo exchange),
    so the tracked result equals the unsharded tracker's. Returns
    (result, (h_blend, w_new)) when tracking.
    """
    plan = sp.plan
    hp = plan.hop1
    config = plan.config
    nL = hp.n_layers
    n_sp = sp.n_sp

    rg = _est._ri_to_complex(rg_ri_loc)  # (L, n_sym)
    pil = _est._ri_to_complex(pil_ri_loc)  # (R, n_dsym, nL)
    cdtype = rg.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    beta = jnp.asarray(beta, rdtype)

    my = jax.lax.axis_index(axis)
    is_first = my == 0
    is_last = my == n_sp - 1

    # Padded-tail validity (non-divisible sharding): 1.0 on real pilot slots,
    # 0.0 on the last shard's padded tail; all-ones everywhere when pad == 0.
    if sp.pad:
        mvec = jnp.asarray((np.arange(sp.R) < sp.n_rlast), rdtype)
        valid_last = jnp.where(is_last, mvec, jnp.ones_like(mvec))  # (R,)
    else:
        valid_last = None

    # --- gather + LS de-spread (local) ---
    rx = jnp.take(rg, jnp.asarray(sp.local_re_idx), axis=0)  # (n_cdm, R, n_sym)
    rx = jnp.take(rx, jnp.asarray(hp.dmrs_sym_idx), axis=2)  # (n_cdm, R, n_dsym)
    epre_loc = dsp.fro_norm_sq(rx)

    cdm_of_layer = np.arange(nL) // 2
    rx_l = jnp.take(rx, jnp.asarray(cdm_of_layer), axis=0)  # (nL, R, n_dsym)
    pil_l = jnp.moveaxis(pil, -1, 0)  # (nL, R, n_dsym)
    rec_x = rx_l * jnp.conj(pil_l)

    # --- CFO (global inner products via psum) ---
    sst = plan.symbol_start_time
    cfo_hop = None
    if hp.cfo_possible:
        if hp.cfo_pair_dt is not None:
            # WLS over all consecutive DM-RS pairs (mirrors estimator._process_hop).
            # All per-pair inner products ride ONE psum (stacked (n_pairs, nL))
            # instead of n_pairs sequential collectives.
            inner_loc = jnp.stack(
                [
                    jnp.sum(jnp.conj(rec_x[:, :, j]) * rec_x[:, :, j + 1], axis=1)
                    for j in range(hp.n_dsym - 1)
                ]
            )  # (n_pairs, nL)
            inner_all = _psum_c(inner_loc, axis)
            num = jnp.zeros((), rdtype)
            den = jnp.zeros((), rdtype)
            for j in range(hp.n_dsym - 1):
                dt = float(hp.cfo_pair_dt[j])
                for c in range(hp.n_cdm):
                    pair = inner_all[j, 2 * c] + (
                        inner_all[j, 2 * c + 1] if 2 * c + 1 < nL else 0.0
                    )
                    w = jnp.abs(pair).astype(rdtype)
                    th = jnp.angle(pair).astype(rdtype)
                    num = num + w * dt * th
                    den = den + w * dt * dt
            cfo_hop = num / (2.0 * np.pi * jnp.maximum(den, jnp.asarray(1e-30, rdtype)))
        else:
            inner_loc = jnp.sum(jnp.conj(rec_x[:, :, 0]) * rec_x[:, :, 1], axis=1)  # (nL,)
            inner = _psum_c(inner_loc, axis)
            acc = jnp.zeros((), rdtype)
            for c in range(hp.n_cdm):
                pair = inner[2 * c] + (inner[2 * c + 1] if 2 * c + 1 < nL else 0.0)
                acc = acc + jnp.angle(pair).astype(rdtype)
            cfo_hop = acc / (2.0 * np.pi * hp.n_samples) / hp.n_cdm
        if config.cfo_compensate:
            sst_d = jnp.asarray(sst[hp.dmrs_sym_idx], dtype=rdtype)
            rot = jnp.exp(-1j * (2.0 * np.pi * sst_d * cfo_hop)).astype(cdtype)
            rec_x = rec_x * rot[None, None, :]

    # --- time average + CDM pair average (local; R is even) ---
    def pair_average(h):  # (rows, R) -> (rows, R)
        m = sp.R // 2
        rows = h.shape[0]
        pairs = h.reshape(rows, m, 2)
        avg = jnp.mean(pairs, axis=-1, keepdims=True)
        return jnp.broadcast_to(avg, (rows, m, 2)).reshape(rows, sp.R)

    h_raw = jnp.sum(rec_x, axis=-1) / beta.astype(cdtype) / hp.n_dsym  # (nL, R)
    h_p = pair_average(h_raw) if nL >= 2 else h_raw

    # Per-DM-RS-symbol estimates for time interpolation (rows pack (layer,
    # dmrs_sym) layer-major — mirrors models/estimator._process_hop).
    ht = None
    if hp.time_interp_mat is not None:
        ht = jnp.moveaxis(rec_x, 2, 1).reshape(nL * hp.n_dsym, sp.R) / beta.astype(cdtype)
        if nL >= 2:
            ht = pair_average(ht)

    # --- smoothing (row-generic: applied to the time-averaged profiles and, when
    # time_interp is active, to the per-symbol rows) ---
    def _mask_tail(h):
        """Zero the last shard's padded tail (smoothing can spill nonzero values
        into it: the conv's garbage outputs, the mean broadcast, wiener's pad)."""
        return h if valid_last is None else h * valid_last[None, :]

    def smooth_rows(h):  # (rows, R) -> (rows, R)
        rows = h.shape[0]
        if hp.smoothing == "mean":
            mean = _psum_c(jnp.sum(h, axis=-1), axis) / hp.n_re  # (rows,)
            return _mask_tail(jnp.broadcast_to(mean[:, None], h.shape))
        if hp.smoothing == "filter":
            hw, n_pils = sp.hw, hp.n_pils
            lh, rh = _halo_exchange(h, hw, axis, n_sp)
            # Outermost shards synthesize virtual pilots; zero-fill beyond them
            # matches the unsharded zero padding (n_pils = min(12, hw) <= hw).
            prec = dsp.precision_of(config.matmul_precision, h.dtype)
            vb = _est._virtual_pilots(h[:, :n_pils], hp.vp_matrix, n_pils, prec)
            ve = _est._virtual_pilots(
                jnp.flip(h[:, sp.n_rlast - n_pils : sp.n_rlast], axis=-1),
                hp.vp_matrix, n_pils, prec,
            )
            zpad = jnp.zeros((rows, hw - n_pils), cdtype)
            left_edge = jnp.concatenate([zpad, vb], axis=-1)  # (rows, hw)
            left = jnp.where(is_first, left_edge, lh)
            # Last shard: the band-edge extension (virtual pilots then zeros)
            # starts right after the last REAL pilot — with a padded tail that
            # is inside h itself, so build the whole extended row explicitly.
            right_edge_full = jnp.concatenate(
                [jnp.flip(ve, axis=-1), jnp.zeros((rows, sp.pad + hw - n_pils), cdtype)],
                axis=-1,
            )  # (rows, pad + hw)
            ext_last = jnp.concatenate([left, h[:, : sp.n_rlast], right_edge_full], axis=-1)
            ext_other = jnp.concatenate([left, h, rh], axis=-1)  # (rows, R + 2*hw)
            ext = jnp.where(is_last, ext_last, ext_other)
            h = dsp.conv_valid(ext, hp.rc_taps)  # (rows, R)
            if config.cnn_alpha > 0.0:
                # Alpha blend with the 3-tap low-pass (ce_dl_cnn.py:712-715).
                # Interior seams use real neighbor taps; outermost shards reflect
                # locally — identical to the unsharded global reflect padding
                # because the global reflection of element 0 is element 1, which
                # lives on shard 0.
                alpha = min(1.0, max(0.0, config.cnn_alpha))
                lh2, rh2 = _halo_exchange(h, 1, axis, n_sp)
                left2 = jnp.where(is_first, h[:, 1:2], lh2)
                right2 = jnp.where(
                    is_last, h[:, sp.n_rlast - 2 : sp.n_rlast - 1], rh2
                )
                if sp.pad:
                    # place the reflected edge value where the conv garbage sits
                    # so the low-pass at the last real pilot sees the reflection
                    hl = jnp.where(
                        is_last & (jnp.arange(sp.R) == sp.n_rlast),
                        h[:, sp.n_rlast - 2 : sp.n_rlast - 1],
                        h,
                    )
                else:
                    hl = h
                ext2 = jnp.concatenate([left2, hl, right2], axis=-1)  # (rows, R + 2)
                lp = dsp.conv_valid(ext2, np.asarray([0.25, 0.5, 0.25]))
                h = h + alpha * (lp - h)
            return _mask_tail(h)
        if hp.smoothing == "learned":
            from ..models import denoiser as _dn

            assert params is not None, "smoothing='learned' needs denoiser params"
            return _dn.apply_sharded(
                params, h, lambda x, w: _halo_exchange(x, w, axis, n_sp)
            )
        if hp.smoothing == "wiener":
            # The eigenbasis projection is global and tiny: gather the raw pilot
            # estimates (same collective size as the TA gather below), run the
            # exact unsharded shrinkage replicated, keep this shard's R columns.
            h_raw_all = jax.lax.all_gather(h, axis, axis=1, tiled=True)
            h_sm_all = _est._smooth_wiener(hp, config, h_raw_all[:, : hp.n_re])
            if sp.pad:
                h_sm_all = jnp.pad(h_sm_all, ((0, 0), (0, sp.pad)))
            start_w = (my * sp.R).astype(jnp.int32)
            return jax.lax.dynamic_slice(h_sm_all, (jnp.int32(0), start_w), (rows, sp.R))
        return h  # "none"

    h_pre = h_p  # pre-smoothing pilot estimates (tracking blends in this domain)
    if hp.smoothing == "learned2d":
        from ..models import denoiser as _dn

        assert params is not None, "smoothing='learned2d' needs denoiser params"
        ex = lambda x, wdt: _halo_exchange(x, wdt, axis, n_sp)
        h_p = _dn.apply_sharded_2d(params, h_p[:, None, :], ex)[:, 0, :]
        if ht is not None:
            ht = _dn.apply_sharded_2d(
                params, ht.reshape(nL, hp.n_dsym, sp.R), ex
            ).reshape(nL * hp.n_dsym, sp.R)
    else:
        h_p = smooth_rows(h_p)
        if ht is not None:
            ht = smooth_rows(ht)

    # --- time alignment: gather the (tiny) smoothed pilots, shared PDP ---
    h_all = jax.lax.all_gather(h_p, axis, axis=1, tiled=True)  # (nL, n_re)
    z = jnp.zeros((hp.fft_size, nL), dtype=cdtype)
    z = z.at[jnp.asarray(hp.ta_scatter_idx), :].set(h_all[:, : hp.ta_scatter_idx.size].T)
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
    ta = i_max / float(hp.fft_size) / float(config.scs_hz)

    # --- reconstruction, noise, RSRP (local sums -> psum) ---
    if config.cfo_compensate and cfo_hop is not None:
        sst_d = jnp.asarray(sst[hp.dmrs_sym_idx], dtype=rdtype)
        ph = jnp.exp(1j * (2.0 * np.pi * sst_d * cfo_hop)).astype(cdtype)
    else:
        ph = jnp.ones((hp.n_dsym,), dtype=cdtype)
    contrib = beta.astype(cdtype) * pil_l * (h_p[:, :, None] * ph[None, None, :])
    est_rx = jnp.stack(
        [jnp.sum(contrib[l0:l1], axis=0) for (l0, l1) in hp.layer_slices], axis=0
    )
    noise_loc = dsp.fro_norm_sq(rx - est_rx)
    rsrp_loc = (beta**2) * dsp.fro_norm_sq(h_p) * hp.n_dsym

    # --- grid fill (row-generic; rpl = rows per layer, > 1 on the time path) ---
    def fill_rows(h, h_all_rows, rpl):  # (rows, R) -> (rows, L)
        if config.interp == "cnn":
            # Exact inpainting linear operator (ops/dsp.inpaint_operator): each
            # shard multiplies the all_gathered pilot estimates by its own column
            # block of the global operator — no halos required.
            outs = []
            for c, (l0, l1) in enumerate(hp.layer_slices):
                transient, steady = hp.inpaint_schedules[c]
                w = jnp.asarray(dsp.inpaint_operator(
                    hp.inpaint_known[c], len(transient) + steady, rdtype
                ))  # (n_re, n_sc_hop)
                if sp.pad:
                    # zero columns for the padded tail so the last shard's
                    # dynamic_slice stays in bounds (it is masked/sliced off)
                    w = jnp.pad(w, ((0, 0), (0, n_sp * sp.L - w.shape[1])))
                start = (my * sp.L).astype(jnp.int32)
                w_local = jax.lax.dynamic_slice(w, (jnp.int32(0), start), (hp.n_re, sp.L))
                outs.append(
                    dsp.inpaint_matmul(
                        h_all_rows[l0 * rpl : l1 * rpl, : hp.n_re],
                        w_local,
                        dsp.precision_of(config.matmul_precision, h_all_rows.dtype),
                    )
                )
            return jnp.concatenate(outs, axis=0)
        # linear interp with a 1-pilot halo across seams
        lh1, rh1 = _halo_exchange(h, 1, axis, n_sp)
        hh = jnp.concatenate([lh1, h, rh1], axis=-1)  # (rows, R + 2)
        outs = []
        for c, (l0, l1) in enumerate(hp.layer_slices):
            vals = hh[l0 * rpl : l1 * rpl]
            base = dsp.lerp_gather(vals, sp.interp_jl[c], sp.interp_jr[c], sp.interp_alpha[c])
            fz = jnp.asarray(sp.first_zone[c])
            lz = jnp.asarray(sp.last_zone[c])
            base = jnp.where(is_first & fz, vals[:, 1:2], base)
            # constant extrapolation anchored at the last REAL pilot (hh index
            # n_rlast; == R when the shard count divides the band)
            base = jnp.where(is_last & lz, vals[:, sp.n_rlast : sp.n_rlast + 1], base)
            outs.append(base)
        return jnp.concatenate(outs, axis=0)

    # --- normalization + grid-wide CFO rotation ---
    epre = jax.lax.psum(epre_loc, axis) / plan.n_pilots
    noise = jax.lax.psum(noise_loc, axis) / plan.noise_den
    rsrp = jax.lax.psum(rsrp_loc, axis) / plan.n_pilots / nL
    if config.cfo_compensate and cfo_hop is not None:
        rot = jnp.exp(
            1j * (2.0 * np.pi * jnp.asarray(sst, dtype=rdtype) * cfo_hop)
        ).astype(cdtype)
    else:
        rot = jnp.ones((rg.shape[1],), dtype=cdtype)
    cfo_hz = (
        (cfo_hop * config.scs_hz).astype(rdtype)
        if cfo_hop is not None
        else jnp.full((), jnp.nan, rdtype)
    )

    # --- multi-slot tracking blend (estimator._estimate_impl semantics, sharded:
    # the gain statistics pool globally via psums; the seam-adjacent pilot
    # difference rides a 1-halo exchange so sig2 counts every global pair) ---
    track_out = None
    h_fill, h_all_fill = h_p, h_all
    if h_prev is not None:
        assert ht is None, "tracking requires time_interp='none'"
        # Match the unsharded tracker's blending domain exactly: with the fused
        # filter chain the pair-average lives inside the smoothing matrices, so
        # the unsharded h_pre (and thus the threaded state) is the RAW estimate;
        # otherwise it is pair-averaged (estimator._process_hop h_pre).
        track_raw = _est._use_fused_smooth(hp) and nL >= 2
        h_pre = h_raw if track_raw else h_pre
        # Phase anchor (estimator tracking-block semantics): store the state
        # in the anchor-free domain — undo this slot's CFO-estimate phase at
        # the DM-RS centroid before blending, re-apply it for the fill.
        # cfo_hop is a psum, so the anchor is identical on every shard.
        anchor = None
        if config.cfo_compensate and cfo_hop is not None:
            t_bar = float(np.mean(np.asarray(sst)[hp.dmrs_sym_idx]))
            anchor = jnp.exp(1j * (2.0 * np.pi * t_bar) * cfo_hop).astype(cdtype)
            h_pre = h_pre * anchor
        d = h_pre[:, 1:] - h_pre[:, :-1]
        if sp.pad:
            # drop pairs touching the last shard's padded tail (real->0 jumps)
            pair_ok = jnp.asarray(np.arange(sp.R - 1) < sp.n_rlast - 1, rdtype)
            d = d * jnp.where(is_last, pair_ok, jnp.ones_like(pair_ok))[None, :]
        s_loc = jnp.sum(jnp.real(d) ** 2 + jnp.imag(d) ** 2) / 2.0
        if n_sp > 1:
            _lh, rh = _halo_exchange(h_pre, 1, axis, n_sp)
            ds = rh[:, 0] - h_pre[:, -1]
            seam = jnp.sum(jnp.real(ds) ** 2 + jnp.imag(ds) ** 2) / 2.0
            s_loc = s_loc + jnp.where(is_last, jnp.zeros((), rdtype), seam)
        e = h_pre - h_prev
        i_loc = jnp.sum(jnp.real(e) ** 2 + jnp.imag(e) ** 2)
        n_s = nL * (hp.n_re - 1)
        n_i = nL * hp.n_re
        sig2 = jnp.maximum(jax.lax.psum(s_loc, axis) / n_s, jnp.asarray(1e-30, rdtype))
        innov = jnp.maximum(jax.lax.psum(i_loc, axis) / n_i, jnp.asarray(1e-30, rdtype))
        w = track_w.astype(rdtype)
        a_static = 1.0 / (w + 1.0)
        a_move = jnp.clip(1.0 - 2.0 * sig2 / innov, 0.0, 1.0)
        a = jnp.maximum(a_static, a_move)
        a = jnp.where(w < 0.5, jnp.ones((), rdtype), a)
        h_blend = h_prev + a.astype(cdtype) * (h_pre - h_prev)
        h_cur = h_blend if anchor is None else h_blend * jnp.conj(anchor)
        h_fill = smooth_rows(pair_average(h_cur) if track_raw else h_cur)
        h_all_fill = (
            jax.lax.all_gather(h_fill, axis, axis=1, tiled=True)
            if config.interp == "cnn"
            else None
        )
        w_new = jnp.minimum(1.0 / jnp.maximum(a, jnp.asarray(1e-3, rdtype)), 64.0)
        track_out = (_est._complex_to_ri(h_blend), w_new)

    def _ret(res):
        return (res, track_out) if track_out is not None else res

    if out_layout == "factored":
        # rank-1 output: local slice of the hop's smoothed profile + replicated
        # per-symbol rotation (cfo_hop is a psum -> identical on every shard)
        assert ht is None, "factored SP requires time_interp='none'"
        full = fill_rows(h_fill, h_all_fill, 1)  # (nL, L)
        return _ret(_est.FactoredResult(
            profiles=_est._complex_to_ri(full[None]),  # (2, 1, nL, L)
            sym_rot=_est._complex_to_ri(rot),
            noise_est=noise,
            rsrp=rsrp,
            epre=epre,
            time_alignment=ta,
            cfo_hz=cfo_hz,
        ))

    if ht is not None:
        ht_all = (
            jax.lax.all_gather(ht, axis, axis=1, tiled=True) if config.interp == "cnn" else None
        )
        full_t = fill_rows(ht, ht_all, hp.n_dsym)  # (nL*n_dsym, L)
        ft = full_t.reshape(nL, hp.n_dsym, sp.L)
        tm = jnp.asarray(hp.time_interp_mat.T, dtype=rdtype)  # (n_dsym, n_alloc)
        prec_t = dsp.precision_of(config.matmul_precision, rdtype)
        mm = lambda a: jnp.einsum("lds,dt->lts", a, tm, precision=prec_t)
        blk = jax.lax.complex(mm(jnp.real(ft)), mm(jnp.imag(ft)))  # (nL, n_alloc, L)
        block = jnp.transpose(blk, (2, 1, 0))  # (L, n_alloc, nL)
    else:
        full = fill_rows(h_fill, h_all_fill, 1)  # (nL, L)
        block = jnp.broadcast_to(full.T[:, None, :], (sp.L, hp.n_alloc_syms, nL))
    channel = jnp.zeros((sp.L, rg.shape[1], nL), dtype=cdtype)
    channel = jax.lax.dynamic_update_slice(channel, block, (0, hp.sym_start, 0))
    if config.cfo_compensate and cfo_hop is not None:
        channel = channel * rot[None, :, None]

    return _ret(_est.EstimateResult(
        channel_est_rg=_est._complex_to_ri(channel),
        noise_est=noise,
        rsrp=rsrp,
        epre=epre,
        time_alignment=ta,
        cfo_hz=cfo_hz,
    ))


@dataclass(eq=False)
class HoppedShardPlan:
    """Static geometry for the frequency-hopped SP path (BASELINE.json config[4]).

    Strategy differs from the single-hop overlap-save path: with two hops the
    contiguous subcarrier shards don't align with either hop band, but the pilot
    front (LS -> CFO -> smooth) is tiny (n_re <= ~3k) while the output grid fill +
    write dominates. So each shard all_gathers the full received grid (<= ~0.4 MB
    even at 273 PRB — one cheap ICI collective), runs the exact unsharded front
    REPLICATED, and fills only its own L output subcarriers via per-hop interp
    operators embedded into full-grid columns (a static dynamic_slice of width L
    per device — no dynamic shapes, no halos).
    """

    plan: EstimatorPlan
    n_sp: int
    L: int  # local subcarriers per shard
    # per hop: list over CDM groups of (n_re, n_sc_full) float64 operators
    w_emb: Tuple[Tuple[np.ndarray, ...], ...]


def make_hopped_shard_plan(plan: EstimatorPlan, n_sp: int) -> HoppedShardPlan:
    assert plan.hop2 is not None, "use make_shard_plan for single-hop problems"
    n_sc = len(plan.hop1.hop.prb_mask) * NRE
    # Non-divisible shard counts pad the subcarrier axis: the embedded operators
    # get zero columns for the padded tail and the build_sp* wrappers pad/slice
    # the grid, so every shard runs the same static-shape fill.
    L = -(-n_sc // n_sp)
    n_sc_pad = n_sp * L
    # the sharded fill writes every local column of a hop's symbol block (zeros
    # outside the band), so hop symbol ranges must not overlap (true for
    # frequency hopping; the reference also assumes it)
    s1 = set(range(plan.hop1.sym_start, plan.hop1.sym_start + plan.hop1.n_alloc_syms))
    s2 = set(range(plan.hop2.sym_start, plan.hop2.sym_start + plan.hop2.n_alloc_syms))
    assert not (s1 & s2), "hopped SP sharding requires disjoint hop symbol ranges"
    w_all = []
    for hp in (plan.hop1, plan.hop2):
        ws = []
        for c in range(hp.n_cdm):
            if plan.config.interp == "cnn":
                transient, steady = hp.inpaint_schedules[c]
                dtypes = [np.float32] + ([np.float64] if jax.config.jax_enable_x64 else [])
                for dt in dtypes:  # prefetch outside any trace
                    dsp.inpaint_operator(hp.inpaint_known[c], len(transient) + steady, dt)
                w = np.asarray(
                    dsp.inpaint_operator(hp.inpaint_known[c], len(transient) + steady, np.float64)
                )
            else:
                w = hp.interp_matrix[c]  # (n_re, n_sc_hop)
            w_full = np.zeros((hp.n_re, n_sc_pad), dtype=np.float64)
            w_full[:, hp.sc_start : hp.sc_start + hp.n_sc_hop] = w
            ws.append(w_full)
        w_all.append(tuple(ws))
    return HoppedShardPlan(plan=plan, n_sp=n_sp, L=L, w_emb=tuple(w_all))


def _sharded_problem_hopped(
    sp: HoppedShardPlan, axis: str, rg_ri_loc, pil_ri_loc, beta,
    out_layout: str = "ref", h_prev=None, track_w=None,
):
    """Per-shard body for one frequency-hopped problem (see HoppedShardPlan).

    out_layout="factored": local FactoredResult — profiles (2, 2, nL, L) (one row
    per hop, zero outside each hop's band locally) + replicated sym_rot.

    h_prev/track_w: multi-slot tracking state — the hopped front is replicated,
    so the blend is the unsharded tracker's math verbatim (h_prev: per-hop
    (nL, n_re) complex, replicated over shards); returns (result, (h_new, w_new))
    when tracking."""
    plan = sp.plan
    config = plan.config
    nL = plan.n_layers

    rg_loc = _est._ri_to_complex(rg_ri_loc)  # (L, n_sym)
    pil = _est._ri_to_complex(pil_ri_loc)  # (n_re, n_dsym_total, nL) replicated
    cdtype = rg_loc.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    beta = jnp.asarray(beta, rdtype)
    n_sym = rg_loc.shape[1]
    sst = plan.symbol_start_time
    my = jax.lax.axis_index(axis)

    # one small collective: reassemble the full grid on every shard
    rg_full = jax.lax.all_gather(rg_loc, axis, axis=0, tiled=True)  # (n_sc, n_sym)

    # replicated front — the exact unsharded per-hop chain
    epre = jnp.zeros((), rdtype)
    noise = jnp.zeros((), rdtype)
    rsrp = jnp.zeros((), rdtype)
    ta = jnp.zeros((), rdtype)
    cfo = None
    hops = [(plan.hop1, pil[:, : plan.n_dsym1, :]), (plan.hop2, pil[:, plan.n_dsym1 :, :])]
    h_ps = []
    h_ts = []
    h_pres = []
    cfo_hs = []
    for hp, pil_h in hops:
        e_i, cfo_h, ta_i, n_i, r_i, h_p, h_t, h_pre = _est._process_hop(
            hp, config, rg_full, pil_h, beta, sst
        )
        epre, noise, rsrp, ta = epre + e_i, noise + n_i, rsrp + r_i, ta + ta_i
        if cfo_h is not None:
            cfo = cfo_h if cfo is None else (cfo + cfo_h) / 2.0
        h_ps.append(h_p)
        h_ts.append(h_t)
        h_pres.append(h_pre)
        cfo_hs.append(cfo_h)
    rsrp = rsrp / plan.n_pilots / nL
    epre = epre / plan.n_pilots
    noise = noise / plan.noise_den
    ta = ta / 2.0

    # --- multi-slot tracking blend (replicated front -> unsharded math verbatim,
    # mirrors estimator._estimate_impl's tracking block) ---
    track_out = None
    if h_prev is not None:
        assert all(h_t is None for h_t in h_ts), "tracking requires time_interp='none'"
        # phase anchor per hop (estimator tracking-block semantics)
        anchors = []
        for (hp, _), cfo_h in zip(hops, cfo_hs):
            if config.cfo_compensate and cfo_h is not None:
                t_bar = float(np.mean(np.asarray(sst)[hp.dmrs_sym_idx]))
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
        n_s = n_i2 = 0
        for h_pre, h_pr in zip(h_obs, h_prev):
            d = h_pre[:, 1:] - h_pre[:, :-1]
            sig2 = sig2 + jnp.sum(jnp.real(d) ** 2 + jnp.imag(d) ** 2) / 2.0
            e = h_pre - h_pr
            innov = innov + jnp.sum(jnp.real(e) ** 2 + jnp.imag(e) ** 2)
            n_s += d.size
            n_i2 += e.size
        sig2 = jnp.maximum(sig2 / max(n_s, 1), jnp.asarray(1e-30, rdtype))
        innov = jnp.maximum(innov / max(n_i2, 1), jnp.asarray(1e-30, rdtype))
        w = track_w.astype(rdtype)
        a_static = 1.0 / (w + 1.0)
        a_move = jnp.clip(1.0 - 2.0 * sig2 / innov, 0.0, 1.0)
        a = jnp.maximum(a_static, a_move)
        a = jnp.where(w < 0.5, jnp.ones((), rdtype), a)
        a_c = a.astype(cdtype)
        h_blend = [h_pr + a_c * (h_ob - h_pr) for h_ob, h_pr in zip(h_obs, h_prev)]
        h_ps = [
            _est._smooth(hp, config, h_b if an is None else h_b * jnp.conj(an), None)
            for (hp, _), h_b, an in zip(hops, h_blend, anchors)
        ]
        w_new = jnp.minimum(1.0 / jnp.maximum(a, jnp.asarray(1e-3, rdtype)), 64.0)
        track_out = (tuple(_est._complex_to_ri(h) for h in h_blend), w_new)

    if config.cfo_compensate and cfo is not None:
        rot = jnp.exp(
            1j * (2.0 * np.pi * jnp.asarray(sst, dtype=rdtype) * cfo)
        ).astype(cdtype)
    else:
        rot = jnp.ones((n_sym,), dtype=cdtype)

    cfo_hz_f = (
        (cfo * config.scs_hz).astype(rdtype)
        if cfo is not None
        else jnp.full((), jnp.nan, rdtype)
    )

    def _ret_h(res):
        return (res, track_out) if track_out is not None else res

    # sharded fill: each device computes only its L output columns per hop
    prec = dsp.precision_of(config.matmul_precision, rdtype)
    if out_layout == "factored":
        assert all(h_t is None for h_t in h_ts), "factored SP requires time_interp='none'"
        start_f = (my * sp.L).astype(jnp.int32)
        rows = []
        for h, ((hp, _), h_p) in enumerate(zip(hops, h_ps)):
            cols = []
            for c, (l0, l1) in enumerate(hp.layer_slices):
                w_loc = jax.lax.dynamic_slice(
                    jnp.asarray(sp.w_emb[h][c], dtype=rdtype),
                    (jnp.int32(0), start_f),
                    (hp.n_re, sp.L),
                )
                cols.append(dsp.inpaint_matmul(h_p[l0:l1], w_loc, prec))
            rows.append(jnp.concatenate(cols, axis=0))  # (nL, L)
        return _ret_h(_est.FactoredResult(
            profiles=_est._complex_to_ri(jnp.stack(rows)),  # (2, 2, nL, L)
            sym_rot=_est._complex_to_ri(rot),
            noise_est=noise,
            rsrp=rsrp,
            epre=epre,
            time_alignment=ta,
            cfo_hz=cfo_hz_f,
        ))

    channel = jnp.zeros((sp.L, n_sym, nL), dtype=cdtype)
    start = (my * sp.L).astype(jnp.int32)
    for (hp, _), h_p, h_t in zip(hops, h_ps, h_ts):
        rpl = hp.n_dsym if h_t is not None else 1
        vals_rows = h_t if h_t is not None else h_p
        cols = []
        for c, (l0, l1) in enumerate(hp.layer_slices):
            w_loc = jax.lax.dynamic_slice(
                jnp.asarray(sp.w_emb[0 if hp is plan.hop1 else 1][c], dtype=rdtype),
                (jnp.int32(0), start),
                (hp.n_re, sp.L),
            )
            cols.append(dsp.inpaint_matmul(vals_rows[l0 * rpl : l1 * rpl], w_loc, prec))
        full_loc = jnp.concatenate(cols, axis=0)  # (nL*rpl, L)
        rot_slice = jax.lax.slice_in_dim(rot, hp.sym_start, hp.sym_start + hp.n_alloc_syms, axis=0)
        if h_t is not None:
            # time-interpolated combine (mirrors estimator._estimate_impl)
            ft = full_loc.reshape(nL, hp.n_dsym, sp.L)
            tm = jnp.asarray(hp.time_interp_mat.T, dtype=rdtype)  # (n_dsym, n_alloc)
            mm = lambda a: jnp.einsum("lds,dt->lts", a, tm, precision=prec)
            blk = jax.lax.complex(mm(jnp.real(ft)), mm(jnp.imag(ft)))  # (nL, n_alloc, L)
            block = jnp.transpose(blk, (2, 1, 0)) * rot_slice[None, :, None]
        else:
            block = full_loc.T[:, None, :] * rot_slice[None, :, None]  # (L, n_alloc, nL)
        channel = jax.lax.dynamic_update_slice(channel, block, (0, hp.sym_start, 0))

    return _ret_h(_est.EstimateResult(
        channel_est_rg=_est._complex_to_ri(channel),
        noise_est=noise,
        rsrp=rsrp,
        epre=epre,
        time_alignment=ta,
        cfo_hz=cfo_hz_f,
    ))


def _pad_to(x: jnp.ndarray, axis: int, n: int) -> jnp.ndarray:
    """Zero-pad `axis` of x up to length n (no-op when already there)."""
    cur = x.shape[axis]
    if cur == n:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, n - cur)
    return jnp.pad(x, pads)


def _slice_to(x: jnp.ndarray, axis: int, n: int) -> jnp.ndarray:
    if x.shape[axis] == n:
        return x
    return jax.lax.slice_in_dim(x, 0, n, axis=axis)


def _wrap_padded(fn, n_sc: int, n_re: int, n_sc_pad: int, n_re_pad: int,
                 rg_axis: int, pil_axis: Optional[int], out_layout: str,
                 ch_axis: int):
    """Wrap a shard-mapped estimator fn with logical->padded input padding and
    padded->logical output slicing (the non-divisible-n_sp route). pil_axis None
    means the pilot input is replicated/unpadded (the hopped front)."""

    def padded(rg_ri, pil_ri, *rest):
        rg_p = _pad_to(rg_ri, rg_axis, n_sc_pad)
        pil_p = pil_ri if pil_axis is None else _pad_to(pil_ri, pil_axis, n_re_pad)
        res = fn(rg_p, pil_p, *rest)

        import dataclasses as _dc

        if out_layout == "factored":
            return _dc.replace(
                res, profiles=_slice_to(res.profiles, res.profiles.ndim - 1, n_sc)
            )
        return _dc.replace(
            res, channel_est_rg=_slice_to(res.channel_est_rg, ch_axis, n_sc)
        )

    return padded


def build_sp_batched(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    mesh: Mesh,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    out_layout: str = "ref",
):
    """Jitted batched estimator sharded over BOTH problems (dp) and subcarriers (sp).

    fn(rg_ri[B,2,n_sc,n_sym], pil_ri[B,2,n_re,n_dsym,L], beta[B]) -> EstimateResult;
    channel output is sharded (dp over batch, sp over subcarriers), scalars dp-sharded.
    B must be divisible by |dp|; geometry restrictions per make_shard_plan.

    out_layout="factored" returns a FactoredResult instead: profiles
    (B, 2, n_hops, nL, n_sc) sharded (dp, sp on the last axis), sym_rot
    (B, 2, n_sym) dp-sharded/sp-replicated (requires time_interp="none").
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert out_layout in ("ref", "factored")
    if out_layout == "factored" and config.time_interp != "none":
        raise ValueError("out_layout='factored' requires time_interp='none'")
    plan = make_plan(hop1, hop2, config, n_layers)
    n_sp = mesh.shape[sp_axis]
    if plan.hop2 is not None:
        hsp = make_hopped_shard_plan(plan, n_sp)
        in_specs_h = (
            P(dp_axis, None, sp_axis, None),  # rg_ri (B, 2, n_sc, n_sym)
            P(dp_axis),  # pil_ri replicated over sp (tiny)
            P(dp_axis),
        )
        if out_layout == "factored":
            out_specs_h = _est.FactoredResult(
                profiles=P(dp_axis, None, None, None, sp_axis),
                sym_rot=P(dp_axis),
                noise_est=P(dp_axis),
                rsrp=P(dp_axis),
                epre=P(dp_axis),
                time_alignment=P(dp_axis),
                cfo_hz=P(dp_axis),
            )
        else:
            out_specs_h = _est.EstimateResult(
                channel_est_rg=P(dp_axis, None, sp_axis, None, None),
                noise_est=P(dp_axis),
                rsrp=P(dp_axis),
                epre=P(dp_axis),
                time_alignment=P(dp_axis),
                cfo_hz=P(dp_axis),
            )

        def body_h(rg_ri_loc, pil_ri_loc, beta_loc):
            return jax.vmap(
                lambda r, p, b: _sharded_problem_hopped(hsp, sp_axis, r, p, b, out_layout)
            )(rg_ri_loc, pil_ri_loc, beta_loc)

        fn = shard_map(
            body_h, mesh=mesh, in_specs=in_specs_h, out_specs=out_specs_h, check_vma=False
        )
        n_sc = len(plan.hop1.hop.prb_mask) * NRE
        if n_sp * hsp.L != n_sc:
            fn = _wrap_padded(fn, n_sc, 0, n_sp * hsp.L, 0, 2, None, out_layout, 2)
        return jax.jit(fn)
    sp = make_shard_plan(plan, n_sp)

    in_specs = (
        P(dp_axis, None, sp_axis, None),  # rg_ri (B, 2, n_sc, n_sym)
        P(dp_axis, None, sp_axis, None, None),  # pil_ri (B, 2, n_re, n_dsym, nL)
        P(dp_axis),  # beta (B,)
    )
    if out_layout == "factored":
        out_specs = _est.FactoredResult(
            profiles=P(dp_axis, None, None, None, sp_axis),
            sym_rot=P(dp_axis),
            noise_est=P(dp_axis),
            rsrp=P(dp_axis),
            epre=P(dp_axis),
            time_alignment=P(dp_axis),
            cfo_hz=P(dp_axis),
        )
    else:
        out_specs = _est.EstimateResult(
            channel_est_rg=P(dp_axis, None, sp_axis, None, None),
            noise_est=P(dp_axis),
            rsrp=P(dp_axis),
            epre=P(dp_axis),
            time_alignment=P(dp_axis),
            cfo_hz=P(dp_axis),
        )

    if config.smoothing in ("learned", "learned2d"):
        def body_p(rg_ri_loc, pil_ri_loc, beta_loc, params):
            return jax.vmap(
                lambda r, p, b: _sharded_problem(sp, sp_axis, r, p, b, params, out_layout)
            )(rg_ri_loc, pil_ri_loc, beta_loc)

        fn = shard_map(
            body_p,
            mesh=mesh,
            in_specs=in_specs + (P(),),  # params replicated
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(fn)

    def body(rg_ri_loc, pil_ri_loc, beta_loc):
        return jax.vmap(
            lambda r, p, b: _sharded_problem(sp, sp_axis, r, p, b, None, out_layout)
        )(rg_ri_loc, pil_ri_loc, beta_loc)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    if sp.pad:
        fn = _wrap_padded(
            fn, plan.hop1.n_sc_hop, plan.hop1.n_re,
            n_sp * sp.L, n_sp * sp.R, 2, 2, out_layout, 2,
        )
    return jax.jit(fn)


def build_sp_receiver(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    mesh: Mesh,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
):
    """Subcarrier-sharded joint multi-RX receiver: fused per-port estimation +
    cross-port MMSE equalization, batched over dp and sharded over sp.

    fn(rg_ri[B,2,n_rx,n_sc,n_sym], pil_ri[B,2,...], beta[B]) ->
    models/receiver.ReceiverResult with x (B, 2, nL, n_sym, n_sc) sharded
    (dp, sp on the subcarrier axis) and sinr (B, n_hops, nL, n_sc).

    The estimation front is the existing factored SP path vmapped over the RX
    axis (halo exchanges / psums batch over ports); the equalization stage then
    needs ZERO additional collectives — the factored output is exactly
    shard-local: each device holds its subcarrier slice of every port's profile
    (sharded over sp), the replicated per-symbol rotation, and the already
    psum'd global noise estimate, and the per-subcarrier MMSE filter touches
    nothing else (ops/equalize.mmse_equalize_factored_serve). Requires
    time_interp="none" (the factored contract). Geometry restrictions per
    make_shard_plan / make_hopped_shard_plan.

    `modulation` fuses the int8 soft demapper like receiver.build_receiver_ri
    (an LlrResult comes back, llr (B, nbits, nL, n_sym, n_sc) sharded over sp) —
    demap is per-RE elementwise, so it stays shard-local: zero extra collectives.
    """
    from ..models import receiver as _rcv
    from ..ops import demap as _demap
    from ..ops import equalize as _eq

    if hop2 is not None and hop2.is_empty:
        hop2 = None
    if config.time_interp != "none":
        raise ValueError("build_sp_receiver requires time_interp='none'")
    assert config.smoothing not in ("learned", "learned2d"), (
        "learned smoothing on the SP receiver: not wired (params plumbing); "
        "use build_dp_receiver or the unsharded receiver"
    )
    plan = make_plan(hop1, hop2, config, n_layers)
    n_sp = mesh.shape[sp_axis]
    nL = n_layers
    hopped = plan.hop2 is not None
    if hopped:
        hsp = make_hopped_shard_plan(plan, n_sp)
        hop_plans = [plan.hop1, plan.hop2]
        pil_spec = P(dp_axis)  # replicated over sp (tiny front)
    else:
        sp = make_shard_plan(plan, n_sp)
        hop_plans = [plan.hop1]
        pil_spec = P(dp_axis, None, sp_axis, None, None)

    in_specs = (
        P(dp_axis, None, None, sp_axis, None),  # rg_ri (B, 2, n_rx, n_sc, n_sym)
        pil_spec,
        P(dp_axis),
    )
    meas_specs = dict(
        noise_est=P(dp_axis),
        rsrp=P(dp_axis),
        epre=P(dp_axis),
        time_alignment=P(dp_axis),
        cfo_hz=P(dp_axis),
    )
    if modulation is None:
        out_specs = _rcv.ReceiverResult(
            x=P(dp_axis, None, None, None, sp_axis),
            sinr=P(dp_axis, None, None, sp_axis),
            **meas_specs,
        )
    else:
        nbits = _demap.bits_per_symbol(modulation)  # validate early
        out_specs = _rcv.LlrResult(
            llr=(P(dp_axis, None, None, sp_axis),) * nbits,
            sinr=P(dp_axis, None, None, sp_axis),
            **meas_specs,
        )

    def one(rg_p, pil_p, b):
        # rg_p (2, n_rx, L, n_sym) local; estimate each port on the SP front
        ports = jnp.moveaxis(rg_p, 1, 0)  # (n_rx, 2, L, n_sym)
        if hopped:
            est = jax.vmap(
                lambda g: _sharded_problem_hopped(
                    hsp, sp_axis, g, pil_p, b, out_layout="factored"
                )
            )(ports)
        else:
            est = jax.vmap(
                lambda g: _sharded_problem(
                    sp, sp_axis, g, pil_p, b, None, "factored"
                )
            )(ports)
        prof = jax.lax.complex(est.profiles[:, 0], est.profiles[:, 1])
        rot = jax.lax.complex(est.sym_rot[:, 0], est.sym_rot[:, 1])  # (n_rx, n_sym)
        noise = jnp.mean(est.noise_est)
        y = jax.lax.complex(rg_p[0], rg_p[1])  # (n_rx, L, n_sym)
        y = jnp.moveaxis(y, -1, -2)  # (n_rx, n_sym, L)
        n_sym, L = y.shape[1], y.shape[2]
        x = jnp.zeros((nL, n_sym, L), y.dtype)
        sinrs = []
        for h, hp in enumerate(hop_plans):
            xh, sh = _eq.mmse_equalize_factored_serve(
                y, prof[:, h], rot, noise, hp.sym_start, hp.n_alloc_syms,
                beta=data_beta,
            )
            x = jax.lax.dynamic_update_slice(x, xh, (0, hp.sym_start, 0))
            sinrs.append(sh)
        meas = dict(
            noise_est=noise,
            rsrp=jnp.mean(est.rsrp),
            epre=jnp.mean(est.epre),
            time_alignment=jnp.mean(est.time_alignment),
            cfo_hz=jnp.mean(est.cfo_hz),
        )
        if modulation is None:
            return _rcv.ReceiverResult(x=_est._complex_to_ri(x), sinr=jnp.stack(sinrs), **meas)
        # per-hop demap against the per-subcarrier SINR; per-bit int8 planes,
        # never stacked on device (see models/receiver.LlrResult)
        nbits = _demap.bits_per_symbol(modulation)
        quant = lambda l: jnp.clip(jnp.round(l * llr_scale), -127.0, 127.0).astype(jnp.int8)
        planes = [jnp.zeros((nL, n_sym, L), jnp.int8) for _ in range(nbits)]
        for h, hp in enumerate(hop_plans):
            xh = jax.lax.dynamic_slice(
                x, (0, hp.sym_start, 0), (nL, hp.n_alloc_syms, L)
            )
            lst = _demap._llr_list(xh, sinrs[h][:, None, :], modulation)
            for k in range(nbits):
                planes[k] = jax.lax.dynamic_update_slice(
                    planes[k], quant(lst[k]), (0, hp.sym_start, 0)
                )
        return _rcv.LlrResult(llr=tuple(planes), sinr=jnp.stack(sinrs), **meas)

    def body(rg_ri_loc, pil_ri_loc, beta_loc):
        return jax.vmap(one)(rg_ri_loc, pil_ri_loc, beta_loc)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    n_sc_log = len(plan.hop1.hop.prb_mask) * NRE
    n_sc_p = n_sp * (hsp.L if hopped else sp.L)
    if n_sc_p != n_sc_log:
        import dataclasses as _dc

        inner = fn
        n_re_p = None if hopped else n_sp * sp.R

        def fn(rg_ri, pil_ri, beta):
            rg_p = _pad_to(rg_ri, 3, n_sc_p)
            pil_p = pil_ri if hopped else _pad_to(pil_ri, 2, n_re_p)
            res = inner(rg_p, pil_p, beta)
            kw = dict(sinr=_slice_to(res.sinr, res.sinr.ndim - 1, n_sc_log))
            if modulation is None:
                kw["x"] = _slice_to(res.x, res.x.ndim - 1, n_sc_log)
            else:
                kw["llr"] = tuple(
                    _slice_to(p, p.ndim - 1, n_sc_log) for p in res.llr
                )
            return _dc.replace(res, **kw)

    return jax.jit(fn)


def build_sp(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    mesh: Mesh,
    sp_axis: str = "sp",
    out_layout: str = "ref",
):
    """Single-problem subcarrier-sharded estimator (wideband low-latency path).

    fn(rg_ri[2,n_sc,n_sym], pil_ri[2,n_re,n_dsym,L], beta) -> EstimateResult with the
    channel output sharded over subcarriers. out_layout="factored" returns a
    FactoredResult (profiles (2, n_hops, nL, n_sc) sharded on the last axis,
    replicated sym_rot; requires time_interp="none").
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert out_layout in ("ref", "factored")
    if out_layout == "factored" and config.time_interp != "none":
        raise ValueError("out_layout='factored' requires time_interp='none'")
    plan = make_plan(hop1, hop2, config, n_layers)
    n_sp = mesh.shape[sp_axis]
    if plan.hop2 is not None:
        hsp = make_hopped_shard_plan(plan, n_sp)
        if out_layout == "factored":
            out_specs_h = _est.FactoredResult(
                profiles=P(None, None, None, sp_axis),
                sym_rot=P(),
                noise_est=P(),
                rsrp=P(),
                epre=P(),
                time_alignment=P(),
                cfo_hz=P(),
            )
        else:
            out_specs_h = _est.EstimateResult(
                channel_est_rg=P(None, sp_axis, None, None),
                noise_est=P(),
                rsrp=P(),
                epre=P(),
                time_alignment=P(),
                cfo_hz=P(),
            )

        def body_h(rg_ri_loc, pil_ri_loc, beta):
            return _sharded_problem_hopped(hsp, sp_axis, rg_ri_loc, pil_ri_loc, beta, out_layout)

        fn = shard_map(
            body_h,
            mesh=mesh,
            in_specs=(P(None, sp_axis, None), P(), P()),
            out_specs=out_specs_h,
            check_vma=False,
        )
        n_sc = len(plan.hop1.hop.prb_mask) * NRE
        if n_sp * hsp.L != n_sc:
            fn = _wrap_padded(fn, n_sc, 0, n_sp * hsp.L, 0, 1, None, out_layout, 1)
        return jax.jit(fn)
    sp = make_shard_plan(plan, n_sp)

    in_specs = (
        P(None, sp_axis, None),
        P(None, sp_axis, None, None),
        P(),
    )
    if out_layout == "factored":
        out_specs = _est.FactoredResult(
            profiles=P(None, None, None, sp_axis),
            sym_rot=P(),
            noise_est=P(),
            rsrp=P(),
            epre=P(),
            time_alignment=P(),
            cfo_hz=P(),
        )
    else:
        out_specs = _est.EstimateResult(
            channel_est_rg=P(None, sp_axis, None, None),
            noise_est=P(),
            rsrp=P(),
            epre=P(),
            time_alignment=P(),
            cfo_hz=P(),
        )

    if config.smoothing in ("learned", "learned2d"):
        def body_p(rg_ri_loc, pil_ri_loc, beta, params):
            return _sharded_problem(sp, sp_axis, rg_ri_loc, pil_ri_loc, beta, params, out_layout)

        fn = shard_map(
            body_p, mesh=mesh, in_specs=in_specs + (P(),), out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(fn)

    def body(rg_ri_loc, pil_ri_loc, beta):
        return _sharded_problem(sp, sp_axis, rg_ri_loc, pil_ri_loc, beta, None, out_layout)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    if sp.pad:
        fn = _wrap_padded(
            fn, plan.hop1.n_sc_hop, plan.hop1.n_re,
            n_sp * sp.L, n_sp * sp.R, 1, 1, out_layout, 1,
        )
    return jax.jit(fn)


def build_sp_tracked(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    mesh: Mesh,
    sp_axis: str = "sp",
    out_layout: str = "ref",
):
    """Subcarrier-sharded estimator with multi-slot tracking (models/tracking.py).

    fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new) where the
    tracking state h_prev_ri is a tuple of per-hop (2, nL, n_re) ri arrays (pass
    `tracking.init_state(...)` output for slot 0; thread the returned state into
    the next call). Single-hop: state sharded over the pilot axis, gain
    statistics pool via psums, seam pilot differences via halo exchange. Hopped:
    the front (and so the state) is replicated — the unsharded tracker's math
    verbatim. The tracked result is numerically equal to
    `tracking.build_tracked_ri`'s. out_layout "ref" or "factored".
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert out_layout in ("ref", "factored")
    assert config.time_interp == "none", "tracking requires time_interp='none'"
    assert config.smoothing not in ("learned", "learned2d"), (
        "tracking + learned smoothing not wired (mirrors tracking.build_tracked_ri)"
    )
    plan = make_plan(hop1, hop2, config, n_layers)
    n_sp = mesh.shape[sp_axis]
    if plan.hop2 is not None:
        hsp = make_hopped_shard_plan(plan, n_sp)
        if out_layout == "factored":
            res_specs_h = _est.FactoredResult(
                profiles=P(None, None, None, sp_axis),
                sym_rot=P(),
                noise_est=P(),
                rsrp=P(),
                epre=P(),
                time_alignment=P(),
                cfo_hz=P(),
            )
        else:
            res_specs_h = _est.EstimateResult(
                channel_est_rg=P(None, sp_axis, None, None),
                noise_est=P(),
                rsrp=P(),
                epre=P(),
                time_alignment=P(),
                cfo_hz=P(),
            )
        in_specs_h = (P(None, sp_axis, None), P(), P(), (P(), P()), P())
        out_specs_h = (res_specs_h, (P(), P()), P())

        def body_h(rg_ri_loc, pil_ri_loc, beta, h_prev_ri, w):
            h_prev = tuple(_est._ri_to_complex(h) for h in h_prev_ri)
            res, (h_new_ri, w_new) = _sharded_problem_hopped(
                hsp, sp_axis, rg_ri_loc, pil_ri_loc, beta, out_layout,
                h_prev=h_prev, track_w=w,
            )
            return res, h_new_ri, w_new

        fn = shard_map(
            body_h, mesh=mesh, in_specs=in_specs_h, out_specs=out_specs_h,
            check_vma=False,
        )
        n_sc = len(plan.hop1.hop.prb_mask) * NRE
        if n_sp * hsp.L != n_sc:
            import dataclasses as _dc

            inner_h, n_sc_p = fn, n_sp * hsp.L

            def fn(rg_ri, pil_ri, beta, h_prev_ri, w):
                res, h_new_ri, w_new = inner_h(
                    _pad_to(rg_ri, 1, n_sc_p), pil_ri, beta, h_prev_ri, w
                )
                if out_layout == "factored":
                    res = _dc.replace(
                        res,
                        profiles=_slice_to(res.profiles, res.profiles.ndim - 1, n_sc),
                    )
                else:
                    res = _dc.replace(
                        res, channel_est_rg=_slice_to(res.channel_est_rg, 1, n_sc)
                    )
                return res, h_new_ri, w_new

        return jax.jit(fn)
    sp = make_shard_plan(plan, n_sp)

    in_specs = (
        P(None, sp_axis, None),  # rg_ri
        P(None, sp_axis, None, None),  # pil_ri
        P(),  # beta
        (P(None, None, sp_axis),),  # h_prev_ri (1-tuple, sharded pilot axis)
        P(),  # w
    )
    if out_layout == "factored":
        res_specs = _est.FactoredResult(
            profiles=P(None, None, None, sp_axis),
            sym_rot=P(),
            noise_est=P(),
            rsrp=P(),
            epre=P(),
            time_alignment=P(),
            cfo_hz=P(),
        )
    else:
        res_specs = _est.EstimateResult(
            channel_est_rg=P(None, sp_axis, None, None),
            noise_est=P(),
            rsrp=P(),
            epre=P(),
            time_alignment=P(),
            cfo_hz=P(),
        )
    out_specs = (res_specs, (P(None, None, sp_axis),), P())

    def body(rg_ri_loc, pil_ri_loc, beta, h_prev_ri, w):
        h_prev = _est._ri_to_complex(h_prev_ri[0])  # (nL, R) local
        res, (h_new_ri, w_new) = _sharded_problem(
            sp, sp_axis, rg_ri_loc, pil_ri_loc, beta, None, out_layout,
            h_prev=h_prev, track_w=w,
        )
        return res, (h_new_ri,), w_new

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    if sp.pad:
        import dataclasses as _dc

        inner, n_sc, n_re = fn, plan.hop1.n_sc_hop, plan.hop1.n_re
        n_sc_p, n_re_p = n_sp * sp.L, n_sp * sp.R

        def fn(rg_ri, pil_ri, beta, h_prev_ri, w):
            res, (h_new_ri,), w_new = inner(
                _pad_to(rg_ri, 1, n_sc_p),
                _pad_to(pil_ri, 1, n_re_p),
                beta,
                (_pad_to(h_prev_ri[0], 2, n_re_p),),
                w,
            )
            if out_layout == "factored":
                res = _dc.replace(
                    res, profiles=_slice_to(res.profiles, res.profiles.ndim - 1, n_sc)
                )
            else:
                res = _dc.replace(
                    res, channel_est_rg=_slice_to(res.channel_est_rg, 1, n_sc)
                )
            return res, (_slice_to(h_new_ri, 2, n_re),), w_new

    return jax.jit(fn)
