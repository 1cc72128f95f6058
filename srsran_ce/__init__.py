"""srsran_ce — 5G NR SRS/PUSCH channel-estimation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
pjookim/srsran-ce-pytorch (see SURVEY.md): LS pilot de-spreading, CFO
estimation/compensation, CDM interference averaging, raised-cosine MMSE-style
frequency smoothing with virtual-pilot edge extrapolation, IFFT power-delay-profile
time alignment, linear / CNN-inpainting interpolation to the full resource grid, and
noise-variance / RSRP / EPRE measurement — batched, jitted, and sharded over
device meshes.
"""
import os as _os

#: Compile cache used when JAX_COMPILATION_CACHE_DIR is not set: one fixed
#: directory inside the checkout (git-ignored). A fixed path matters because
#: the path is part of the cache key.
CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir() -> str:
    """The persistent compile cache directory in use: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else CACHE_DIR."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def _enable_persistent_compile_cache() -> None:
    """Point JAX at CACHE_DIR unless JAX_COMPILATION_CACHE_DIR is set, in which
    case nothing is set here. Repeat runs then skip identical compiles."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache everything that took non-trivial compile time, however small
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_persistent_compile_cache()

from .config import (
    NRE,
    EstimatorConfig,
    HopConfig,
    baseline_config,
    cnn_config,
    make_config,
    normal_cp_durations_ms,
    tensorized_config,
)

__version__ = "0.1.0"

__all__ = [
    "NRE",
    "EstimatorConfig",
    "HopConfig",
    "baseline_config",
    "cnn_config",
    "make_config",
    "normal_cp_durations_ms",
    "tensorized_config",
]
