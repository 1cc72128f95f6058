"""Multi-slot channel tracking: recursive refinement across successive soundings.

The reference estimates each slot independently (srs_channel_estimator is
stateless, ce_rule_baseline.py:761-953). Real deployments sound SRS/DM-RS
periodically, and the channel between soundings is correlated — a first-order
adaptive tracker (alpha filter with a self-tuned gain) recovers most of the
multi-slot averaging gain at negligible cost:

  h_track <- h_prev + a * (h_obs - h_prev)

with gain a pooled from two runtime statistics (models/estimator._estimate_impl
tracking block): the observation noise proxy (adjacent pilot differences, the
same statistic the wiener smoother uses) and the innovation |h_obs - h_prev|^2.
On a static channel a decays as 1/(w+1) — exact running average, ~10*log10(N) dB
noise reduction after N slots; when the innovation exceeds the noise floor the
gain snaps back toward 1, so a moving channel is never lagged by more than one
sounding. The tracked state rides the grid fill; the per-slot scalar metrics
(noise, RSRP, EPRE, TA, CFO) remain single-slot for reference parity.

State is functional and ri-layout (vmap-batched): a tuple of
per-hop pilot-lattice estimates (2, nL, n_re) plus a scalar weight. Use
`init_state` for slot 0 and thread the returned state through successive calls.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EstimatorConfig, HopConfig
from . import estimator as _est
from .plan import make_plan


def init_state(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    batch: Optional[int] = None,
    dtype=np.float32,
):
    """Zero tracking state: (h_prev_ri tuple, w). w == 0 makes the first call's
    gain exactly 1 (the tracker passes the first observation through)."""
    plan = make_plan(hop1, hop2, config, n_layers)
    hops = [plan.hop1] + ([plan.hop2] if plan.has_hop2 else [])
    lead = () if batch is None else (batch,)
    h = tuple(np.zeros(lead + (2, n_layers, hp.n_re), dtype=dtype) for hp in hops)
    w = np.zeros(lead, dtype=dtype)
    return h, w


@functools.lru_cache(maxsize=256)
def build_tracked_ri(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    batched: bool = False,
    out_layout: str = "ref",
):
    """Jitted tracking estimator:
    fn(rg_ri, pil_ri, beta, h_prev_ri, w) -> (EstimateResult_ri, h_new_ri, w_new).

    Thread (h_new_ri, w_new) into the next slot's call. All arrays ri-layout;
    with batched=True every argument gains a leading batch axis (state included)
    and problems track independently. lru-cached on the full signature so
    repeated calls (e.g. serving.TrackedServer, one per sounding) reuse one
    compiled executable — mirrors estimator._build_ri_cached.

    out_layout accepts "ref", "serve", and "factored" (tracking already requires
    time_interp="none", exactly the factored domain — the result is then an
    ri-layout FactoredResult).
    """
    assert out_layout in ("ref", "serve", "factored"), out_layout
    assert config.time_interp == "none", "tracking requires time_interp='none'"
    assert config.smoothing not in ("learned", "learned2d"), (
        "tracking + learned smoothing not wired (pass params support if needed)"
    )
    plan = make_plan(hop1, hop2, config, n_layers)
    _est.prefetch_plan_constants(plan)

    def single(rg_ri, pil_ri, beta, h_prev_ri, w):
        h_prev = tuple(_est._ri_to_complex(h) for h in h_prev_ri)
        res, (h_new, w_new) = _est._estimate_impl(
            plan,
            _est._ri_to_complex(rg_ri),
            _est._ri_to_complex(pil_ri),
            beta,
            None,
            out_layout,
            None,
            h_prev=h_prev,
            track_w=w,
        )
        res_ri = _est.result_to_ri(res)
        return res_ri, tuple(_est._complex_to_ri(h) for h in h_new), w_new

    if batched:
        return jax.jit(jax.vmap(single))
    return jax.jit(single)
