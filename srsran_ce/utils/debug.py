"""Numerical sanitizers (SURVEY.md §5 'Race detection / sanitizers' equivalents).

There is nothing to race in an SPMD program with deterministic collectives; the
failure modes that matter here are numerical — NaN/Inf escaping a kernel, division
blowups in the virtual-pilot fit, bad scatter indices. Tools:

  checked(fn)            — checkify-wrapped callable: NaN/div/OOB checks become
                           returned errors instead of silent garbage
  assert_finite_result   — host-side post-condition on an EstimateResult
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify


def checked(fn, errors=checkify.float_checks):
    """Wrap a jittable fn with checkify NaN/Inf (and optionally index) checks.

    Returns g(*args) -> (error, out); call error.throw() to raise on failure.
    """
    return jax.jit(checkify.checkify(fn, errors=errors))


def assert_finite_result(res) -> None:
    """Host-side sanity gate on an EstimateResult (any layout)."""
    for name in ("channel_est_rg", "noise_est", "rsrp", "epre", "time_alignment"):
        a = np.asarray(getattr(res, name))
        if not np.isfinite(a).all():
            raise FloatingPointError(f"non-finite values in {name}")
    # cfo_hz may legitimately be NaN when no hop had >= 2 DMRS symbols

