"""Joint multi-RX-port MMSE receiver: estimate + equalize in ONE jitted program.

The reference stops at the per-port channel estimate (srs_channel_estimator
returns the grid + measurements, ce_rule_baseline.py:761-768); an actual uplink
receiver runs the estimator once per receive antenna and then jointly
MMSE-equalizes the data REs across ports. This module closes that loop on the
device:

  * ONE compiled XLA program per (plan, n_rx): the per-port channel grids are
    intermediate values that never leave the device — only the equalized
    symbols (nL <= n_rx x smaller than the stacked channel) and per-layer SINR
    cross the host boundary.
  * The per-port estimates are a `jax.vmap` over the RX axis of the SAME
    `_estimate_impl` the single-port API jits — no second estimator code path
    to keep conformant.
  * Factored fast path (`mode="auto"`, time_interp="none"): each port's grid
    is rank-1 in time per hop (profile x unit-modulus CFO rotation,
    estimator.FactoredResult), and the per-port rotations cancel in the Gram
    matrix, so the MMSE filter inverse is built once per SUBCARRIER instead of
    once per RE — exactly, not approximately — even though every port carries
    its own measured CFO phase (ops/equalize.mmse_equalize_factored_serve).

Measurement combining across ports: noise/RSRP/EPRE/time-alignment/CFO are
arithmetic means over the per-port estimates (each port's estimator measures
the same physical link through independent noise).

Shapes (ri layout at the device boundary, like every builder in this repo):
rg_ri (2, n_rx, n_sc, n_sym); pil_ri (2, n_re, n_dsym, n_layers) — pilots are
the UE's transmission, shared by all ports; x (2, nL, n_sym, n_sc) serve
layout. Batched adds a leading B axis after nothing (B, 2, ...).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import EstimatorConfig, HopConfig
from ..ops import demap, equalize
from .estimator import (
    _complex_to_ri,
    _estimate_impl,
    _ri_to_complex,
    prefetch_plan_constants,
)
from .plan import make_plan


@jax.tree_util.register_dataclass
@dataclass
class ReceiverResult:
    """Equalized symbols + SINR + the estimator's 5 measurements (port-mean).

    x: (2, n_layers, n_sym, n_sc) ri — noise-normalized symbol estimates, serve
    layout; zero outside the hop allocations. sinr: per-layer post-MMSE SINR
    (linear) — (n_layers, n_sym, n_sc) on the dense path, (n_hops, n_layers,
    n_sc) on the factored path (the factored filter is time-invariant per hop).
    """

    x: jnp.ndarray
    sinr: jnp.ndarray
    noise_est: jnp.ndarray  # scalar real (mean over RX ports)
    rsrp: jnp.ndarray  # scalar real
    epre: jnp.ndarray  # scalar real
    time_alignment: jnp.ndarray  # scalar real, seconds
    cfo_hz: jnp.ndarray  # scalar real, Hz (NaN if not estimable)


@jax.tree_util.register_dataclass
@dataclass
class LlrResult:
    """Soft-bit receiver output: the chain's final product (what a PHY hands to
    the LDPC decoder) instead of complex symbols.

    llr: TUPLE of bits_per_symbol int8 arrays, each (n_layers, n_sym, n_sc),
    in TS 38.211 word order b0, b1, ... — max-log-MAP LLRs quantized as
    round(llr * llr_scale) clipped to [-127, 127] (3GPP sign convention:
    positive = bit 0 likelier; the srsRAN receiver's own soft bits are int8,
    log_likelihood_ratio). REs outside the hop allocations are 0 (erasures).
    Separate per-bit planes, NOT one stacked array: each plane keeps the long
    subcarrier axis minor (contiguous int8 writes), and an int8 concatenate
    cost ~10x the separate outputs in an earlier measurement — stack on the
    host if a single array is wanted (np.stack(out.llr, axis=-1)).
    sinr keeps the ReceiverResult native shape ((nL, n_sym, n_sc) dense /
    (n_hops, nL, n_sc) factored) for CQI reporting.
    """

    llr: tuple
    sinr: jnp.ndarray
    noise_est: jnp.ndarray
    rsrp: jnp.ndarray
    epre: jnp.ndarray
    time_alignment: jnp.ndarray
    cfo_hz: jnp.ndarray


def receiver_impl(
    plan,
    rg_ri: jnp.ndarray,
    pil_ri: jnp.ndarray,
    beta,
    factored: bool,
    data_beta: float = 1.0,
    params=None,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
) -> "ReceiverResult | LlrResult":
    """Traceable estimate+equalize body shared by the builder and the bench
    harness. rg_ri (2, n_rx, n_sc, n_sym); pil_ri (2, n_re, n_dsym, nL).

    With `modulation` set the soft demapper (ops/demap.llrs, exact max-log-MAP)
    runs in the SAME program and an LlrResult comes back instead: int8 LLRs are
    nbits bytes/RE vs 8 for complex64 symbols (4x less transfer at QPSK, equal
    at 256QAM) and the host does zero demap work."""
    out_layout = "factored" if factored else "serve"
    rg = _ri_to_complex(rg_ri)  # (n_rx, n_sc, n_sym)
    pil = _ri_to_complex(pil_ri)
    est = jax.vmap(
        lambda r: _estimate_impl(plan, r, pil, beta, params, out_layout)
    )(rg)
    return _equalize_tail(plan, rg, est, factored, data_beta, modulation, llr_scale)


def _equalize_tail(
    plan, rg, est, factored, data_beta, modulation, llr_scale
) -> "ReceiverResult | LlrResult":
    """Cross-port MMSE equalization (+ optional fused demap) of per-port
    estimator outputs — shared by the plain and the tracked receiver."""
    hop_plans = [plan.hop1] + ([plan.hop2] if plan.has_hop2 else [])
    n_layers = plan.n_layers
    noise = jnp.mean(est.noise_est)
    y = jnp.moveaxis(rg, -1, -2)  # (n_rx, n_sym, n_sc)
    if factored:
        n_sc, n_sym = rg.shape[1], rg.shape[2]
        x = jnp.zeros((n_layers, n_sym, n_sc), rg.dtype)
        sinrs = []
        for h, hp in enumerate(hop_plans):
            xh, sh = equalize.mmse_equalize_factored_serve(
                y,
                est.profiles[:, h],
                est.sym_rot,
                noise,
                hp.sym_start,
                hp.n_alloc_syms,
                beta=data_beta,
            )
            x = jax.lax.dynamic_update_slice(x, xh, (0, hp.sym_start, 0))
            sinrs.append(sh)
        sinr = jnp.stack(sinrs)  # (n_hops, nL, n_sc)
    else:
        # est.channel_est_rg is the serve-layout grid stacked over ports:
        # (n_rx, nL, n_sym, n_sc) — consumed with no relayout.
        x, sinr = equalize.mmse_equalize_serve(
            y, est.channel_est_rg, noise, beta=data_beta
        )
    meas = dict(
        noise_est=noise,
        rsrp=jnp.mean(est.rsrp),
        epre=jnp.mean(est.epre),
        time_alignment=jnp.mean(est.time_alignment),
        cfo_hz=jnp.mean(est.cfo_hz),
    )
    if modulation is None:
        return ReceiverResult(x=_complex_to_ri(x), sinr=sinr, **meas)
    nbits = demap.bits_per_symbol(modulation)
    n_sym, n_sc = x.shape[-2], x.shape[-1]
    quant = lambda l: jnp.clip(jnp.round(l * llr_scale), -127.0, 127.0).astype(jnp.int8)
    if factored:
        # Demap each hop's symbol block against its per-subcarrier SINR
        # ((nL, 1, n_sc), broadcast in-fusion) instead of expanding SINR onto
        # the full grid first: the grid-sized SINR would be re-read once per
        # bit plane (~8 x 73 MB at 256QAM/106PRB/batch-128 — HBM, not FLOPs,
        # is the demap cost). Zeros outside the allocations = erasures.
        planes = [jnp.zeros((n_layers, n_sym, n_sc), jnp.int8) for _ in range(nbits)]
        for h, hp in enumerate(hop_plans):
            xh = jax.lax.dynamic_slice(
                x, (0, hp.sym_start, 0), (n_layers, hp.n_alloc_syms, n_sc)
            )
            lst = demap._llr_list(xh, sinr[h][:, None, :], modulation)
            for k in range(nbits):
                planes[k] = jax.lax.dynamic_update_slice(
                    planes[k], quant(lst[k]), (0, hp.sym_start, 0)
                )
    else:
        planes = [quant(l) for l in demap._llr_list(x, sinr, modulation)]
    return LlrResult(llr=tuple(planes), sinr=sinr, **meas)


@functools.lru_cache(maxsize=128)
def _build_receiver_cached(
    plan_key,
    n_rx: int,
    batched: bool,
    mode: str,
    data_beta: float,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
):
    hop1, hop2, config, n_layers = plan_key
    plan = make_plan(hop1, hop2, config, n_layers)
    prefetch_plan_constants(plan)
    factored = mode == "factored" or (mode == "auto" and config.time_interp == "none")
    learned = config.smoothing in ("learned", "learned2d")

    def single(rg_ri, pil_ri, beta, params=None):
        assert rg_ri.shape[1] == n_rx, (rg_ri.shape, n_rx)
        return receiver_impl(
            plan,
            rg_ri,
            pil_ri,
            beta,
            factored,
            data_beta,
            params,
            modulation,
            llr_scale,
        )

    if learned:
        if batched:
            return jax.jit(jax.vmap(single, in_axes=(0, 0, 0, None)))
        return jax.jit(single)
    one = lambda rg_ri, pil_ri, beta: single(rg_ri, pil_ri, beta)
    return jax.jit(jax.vmap(one)) if batched else jax.jit(one)


def build_receiver_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    n_rx: int,
    batched: bool = False,
    mode: str = "auto",
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
):
    """Jitted `fn(rg_ri, pil_ri, beta[, params]) -> ReceiverResult` (ri layout).

    rg_ri: (2, n_rx, n_sc, n_sym) real — one received grid per RX port; pil_ri:
    (2, n_re, n_dsym, n_layers) real (shared); beta: pilot amplitude scale.
    With batched=True every array gains a leading problem axis B. `params` is
    the denoiser pytree, required iff config.smoothing is a learned mode
    (replicated, not batched).

    mode: "dense" always equalizes the full per-RE grid; "factored" requires
    time_interp="none" and builds the filter once per subcarrier; "auto" picks
    factored exactly when time_interp="none". `data_beta` is the data-RE
    amplitude scale (DM-RS boost beta scales only the pilots; data REs are
    typically unit amplitude), baked into the program as a static constant.

    `modulation` (one of ops/demap.MODULATIONS) fuses the exact max-log soft
    demapper into the program: the result is an LlrResult with int8 LLRs
    quantized by `llr_scale` — the equalized symbols never leave the device.
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert mode in ("auto", "dense", "factored")
    assert n_rx >= 1
    if mode == "factored" and config.time_interp != "none":
        raise ValueError("mode='factored' requires time_interp='none'")
    if modulation is not None:
        demap.bits_per_symbol(modulation)  # validate early
    return _build_receiver_cached(
        (hop1, hop2, config, n_layers),
        n_rx,
        batched,
        mode,
        float(data_beta),
        modulation,
        float(llr_scale),
    )


def tracked_receiver_impl(
    plan,
    rg_ri: jnp.ndarray,
    pil_ri: jnp.ndarray,
    beta,
    h_prev_ri,
    w,
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
):
    """Traceable multi-slot TRACKED receiver body: per-port tracked estimation
    (models/tracking's alpha filter with self-tuned gain, each RX port
    carrying its own state) + the same fused cross-port MMSE equalize (+
    demap) tail as the plain receiver. Tracking lives on the factored path
    (it requires time_interp="none"), so the equalizer's per-subcarrier
    filter consumes the TRACKED profiles — on a static channel the post-MMSE
    SINR grows with every sounding, and the demapper's LLR confidence follows
    automatically (the filter is rebuilt from the tracked Gram each slot).

    h_prev_ri: tuple (one per hop) of (n_rx, 2, nL, n_re) ri states
    (tracking.init_state(batch=n_rx)); w: (n_rx,) weights. Returns
    (ReceiverResult | LlrResult, h_new_ri, w_new)."""
    rg = _ri_to_complex(rg_ri)  # (n_rx, n_sc, n_sym)
    pil = _ri_to_complex(pil_ri)

    def one_port(r, hp_ri, wp):
        h_prev = tuple(_ri_to_complex(h) for h in hp_ri)
        res, (h_new, w_new) = _estimate_impl(
            plan, r, pil, beta, None, "factored", None,
            h_prev=h_prev, track_w=wp,
        )
        return res, tuple(_complex_to_ri(h) for h in h_new), w_new

    est, h_new_ri, w_new = jax.vmap(one_port)(rg, h_prev_ri, w)
    out = _equalize_tail(plan, rg, est, True, data_beta, modulation, llr_scale)
    return out, h_new_ri, w_new


def build_tracked_receiver_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    n_rx: int,
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
    batched: bool = False,
):
    """Jitted tracked multi-RX receiver:
    fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (result, h_new_ri, w_new).

    Thread the returned state into the next sounding's call (slot 0 state:
    `models.tracking.init_state(hop1, hop2, config, n_layers, batch=n_rx)` —
    weight 0 makes the first call identical to the plain receiver). Requires
    time_interp="none" (the tracking/factored domain). `modulation` fuses the
    int8 soft demapper exactly as in build_receiver_ri. With batched=True
    every argument (state included) gains a leading problem axis and problems
    track independently (serving.TrackedServer's multi-port path).
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert config.time_interp == "none", "tracking requires time_interp='none'"
    assert config.smoothing not in ("learned", "learned2d")
    if modulation is not None:
        demap.bits_per_symbol(modulation)
    return _build_tracked_receiver_cached(
        (hop1, hop2, config, n_layers), n_rx, float(data_beta), modulation,
        float(llr_scale), batched,
    )


@functools.lru_cache(maxsize=128)
def _build_tracked_receiver_cached(
    plan_key, n_rx, data_beta, modulation, llr_scale, batched=False
):
    hop1, hop2, config, n_layers = plan_key
    plan = make_plan(hop1, hop2, config, n_layers)
    prefetch_plan_constants(plan)

    def single(rg_ri, pil_ri, beta, h_prev_ri, w):
        assert rg_ri.shape[1] == n_rx, (rg_ri.shape, n_rx)
        return tracked_receiver_impl(
            plan, rg_ri, pil_ri, beta, h_prev_ri, w, data_beta, modulation, llr_scale
        )

    return jax.jit(jax.vmap(single)) if batched else jax.jit(single)
