"""DSP primitives (pure jnp, static shapes, batch-last-axis-free).

These are the JAX equivalents of the reference's primitive layer (SURVEY.md §2 #2-#5,
#9, #12-#14) re-designed for XLA: no data-dependent shapes, no Python branches on
traced values, convolutions expressed as K static shifted-accumulates (K <= 15 here,
so this compiles to a handful of fused elementwise ops rather than a conv layout shuffle).

All functions operate on the **last axis** and broadcast over arbitrary leading axes,
so the same code path serves single problems, vmapped batches, and sharded blocks.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def unwrap_phase(ph: jnp.ndarray) -> jnp.ndarray:
    """1-D phase unwrap along the last axis (numpy.unwrap convention).

    Parallel form of the reference's sequential cumulative correction
    (ce_rule_baseline.py:35-66): the correction is a prefix sum, which XLA lowers to a
    log-depth scan on accelerators.
    """
    if ph.shape[-1] <= 1:
        return ph
    pi = np.pi
    dd = ph[..., 1:] - ph[..., :-1]
    ddmod = jnp.mod(dd + pi, 2.0 * pi) - pi
    ddmod = jnp.where((ddmod == -pi) & (dd > 0), ddmod + 2.0 * pi, ddmod)
    correction = jnp.where(jnp.abs(dd) < pi, 0.0, ddmod - dd)
    cum = jnp.cumsum(correction, axis=-1)
    pad = [(0, 0)] * (ph.ndim - 1) + [(1, 0)]
    return ph + jnp.pad(cum, pad)


def conv_same_zero(x: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """MATLAB conv(x, h, 'same') with zero padding, odd-length static real taps.

    Matches the reference's float64 conv1d path (_conv_same_1d_complex,
    ce_rule_baseline.py:471-505) but expressed as K static shifted adds so XLA fuses
    it into the surrounding elementwise work. Works for real or complex x, batched
    over leading axes.
    """
    taps = np.asarray(taps)
    K = taps.size
    assert K % 2 == 1, "conv_same_zero expects odd-length taps"
    if K == 1:
        return x * float(taps[0])
    N = x.shape[-1]
    p = (K - 1) // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(p, p)]
    xp = jnp.pad(x, pad)
    # Python-float taps stay weakly typed so the input dtype (c64 when serving, c128 in
    # x64 conformance runs) is preserved.
    flipped = [float(t) for t in taps[::-1]]
    y = flipped[0] * jax.lax.slice_in_dim(xp, 0, N, axis=-1)
    for k in range(1, K):
        y = y + flipped[k] * jax.lax.slice_in_dim(xp, k, k + N, axis=-1)
    return y


def conv_valid(x: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """'valid' convolution along the last axis: (..., N) -> (..., N-K+1).

    Used by the overlap-save sharded smoothing path: each shard convolves its
    halo-extended block and keeps exactly its own output span, reproducing the
    unsharded conv_same_zero bit-for-bit at interior seams.
    """
    taps = np.asarray(taps)
    K = taps.size
    N = x.shape[-1]
    assert N >= K, f"conv_valid needs input >= taps ({N} < {K})"
    flipped = [float(t) for t in taps[::-1]]
    M = N - K + 1
    y = flipped[0] * jax.lax.slice_in_dim(x, 0, M, axis=-1)
    for k in range(1, K):
        y = y + flipped[k] * jax.lax.slice_in_dim(x, k, k + M, axis=-1)
    return y


def _reflect_pad_1(x: jnp.ndarray) -> jnp.ndarray:
    """Reflect-pad the last axis by 1 on each side (replicate for length-1 inputs),
    matching torch F.pad(mode='reflect') as used by the reference CNN helpers
    (ce_dl_cnn.py:433-451)."""
    if x.shape[-1] == 1:
        return jnp.concatenate([x, x, x], axis=-1)
    left = x[..., 1:2]
    right = x[..., -2:-1]
    return jnp.concatenate([left, x, right], axis=-1)


def conv3_reflect(x: jnp.ndarray, taps: Sequence[float] = (0.25, 0.5, 0.25)) -> jnp.ndarray:
    """3-tap 'same' convolution with reflect padding — the fixed-weight CNN building
    block (reference ce_dl_cnn.py:433-470)."""
    a, b, c = float(taps[2]), float(taps[1]), float(taps[0])  # flipped for convolution
    xp = _reflect_pad_1(x)
    N = x.shape[-1]
    return (
        a * jax.lax.slice_in_dim(xp, 0, N, axis=-1)
        + b * jax.lax.slice_in_dim(xp, 1, N + 1, axis=-1)
        + c * jax.lax.slice_in_dim(xp, 2, N + 2, axis=-1)
    )


def cnn_lowpass(x: jnp.ndarray, passes: int = 2) -> jnp.ndarray:
    """`passes` x [0.25, 0.5, 0.25] smoothing of a complex sequence (reference
    _cnn_lowpass_1d_complex, ce_dl_cnn.py:454-470; identity for length <= 2)."""
    if x.shape[-1] <= 2:
        return x
    y = x
    for _ in range(max(1, int(passes))):
        y = conv3_reflect(y)
    return y


def make_inpaint_schedule(known_mask: np.ndarray, n_iters: int):
    """Precompute the static mask/denominator schedule of the partial-conv inpainting.

    The reference updates its validity mask every iteration from data-independent
    quantities (ce_dl_cnn.py:473-508): m_{t+1} = max(m_t, conv(m_t, h) > eps). Since
    the seed mask is static config, the whole mask trajectory is trace-time constant —
    we precompute (m_t, den_t) per iteration in numpy so the jitted kernel is nothing
    but K shifted multiply-adds and selects.

    Returns list of (m_t, den_t) float64 numpy arrays, each shape (n,).
    """
    h = np.array([0.25, 0.5, 0.25])
    eps = 1e-12
    m = np.asarray(known_mask, dtype=np.float64).reshape(-1)
    n = m.size

    def conv_reflect_np(v):
        if n == 1:
            vp = np.array([v[0], v[0], v[0]])
        else:
            vp = np.concatenate([v[1:2], v, v[-2:-1]])
        return np.convolve(vp, h, mode="valid")

    schedule = []
    steady = 0
    total = max(1, int(n_iters))
    for it in range(total):
        den = conv_reflect_np(m)
        if m.all() and (den > eps).all():
            # Mask saturated: every remaining iteration is the identical fixed-point
            # update x = where(known, x0, conv(x)/(1+eps)). Collapse them into a
            # counted loop so the 273-PRB case (409 iterations) doesn't unroll into
            # a 400-deep XLA graph.
            steady = total - it
            break
        schedule.append((m.copy(), den))
        m = np.maximum(m, (den > eps).astype(np.float64))
    return schedule, steady


def cnn_inpaint(
    x_sparse: jnp.ndarray,  # (..., n) complex, zeros at unknown positions
    known_mask: np.ndarray,  # (n,) bool, static
    n_iters: int,
    schedule=None,
) -> jnp.ndarray:
    """Partial-convolution inpainting with a static mask schedule (reference
    _cnn_inpaint_1d_complex, ce_dl_cnn.py:473-508). `schedule` may be precomputed via
    make_inpaint_schedule (it is pure config) to avoid re-deriving it per trace."""
    known = np.asarray(known_mask, dtype=bool).reshape(-1)
    if known.all():
        return cnn_lowpass(x_sparse, passes=2)
    if schedule is None:
        schedule = make_inpaint_schedule(known, n_iters)
    transient, steady = schedule
    eps = 1e-12
    real_dtype = jnp.real(x_sparse).dtype
    known_j = jnp.asarray(known)
    x0 = x_sparse
    x = x_sparse
    for m_t, den_t in transient:
        m_j = jnp.asarray(m_t, dtype=real_dtype)
        inv_den = jnp.asarray(1.0 / (den_t + eps), dtype=real_dtype)
        num = conv3_reflect(x * m_j)
        prop = num * inv_den
        x = jnp.where(known_j, x0, prop)
    if steady > 0:
        inv = jnp.asarray(1.0 / (1.0 + eps), dtype=real_dtype)
        x = jax.lax.fori_loop(
            0,
            steady,
            lambda _, xc: jnp.where(known_j, x0, conv3_reflect(xc) * inv),
            x,
        )
    x_lp = cnn_lowpass(x, passes=2)
    return jnp.where(known_j, x0, x_lp)


@functools.lru_cache(maxsize=64)
def _inpaint_operator_cached(known_key: bytes, n: int, n_iters: int, dtype_str: str):
    """Exact linear operator of the full inpainting chain as an (n_re, n_sc) matrix.

    The partial-conv inpainting is linear in the seeded pilot values (the mask
    schedule, denominators, and pinning selects are all static — see
    make_inpaint_schedule), so T iterations + the final low-pass collapse into ONE
    matrix W with full[sc] = sum_j W[j, sc] * pilot[j]. We build W by pushing the
    n_re scatter-identity basis vectors through the *identical* cnn_inpaint code
    path (so parity is exact up to float reassociation), once per geometry, on
    device. Applying it is a single matmul — this replaces the 400-deep
    sequential conv loop of the 273-PRB case with ~1 GFLOP of dense matmul.
    """
    known = np.frombuffer(known_key, dtype=bool)
    filled = np.nonzero(known)[0]
    n_re = filled.size
    dtype = jnp.dtype(dtype_str)
    eye = np.zeros((n_re, n), dtype=dtype)
    eye[np.arange(n_re), filled] = 1.0
    schedule = make_inpaint_schedule(known, n_iters)
    w = jax.jit(lambda e: cnn_inpaint(e, known, n_iters, schedule=schedule))(
        jnp.asarray(eye)
    )
    return jax.block_until_ready(w)  # (n_re, n_sc) real


def inpaint_operator(known_mask: np.ndarray, n_iters: int, real_dtype) -> jnp.ndarray:
    """Cached (n_re, n_sc) inpainting operator for a static mask (see above)."""
    known = np.ascontiguousarray(np.asarray(known_mask, dtype=bool).reshape(-1))
    return _inpaint_operator_cached(
        known.tobytes(), known.size, int(n_iters), np.dtype(real_dtype).name
    )


#: Matmul arithmetic per precision name, pinned as an explicit dot algorithm so
#: a name means the same arithmetic on every backend (a bare lax.Precision lets
#: the backend choose: TF32 on a GPU, bf16 passes on other accelerators).
#: "default" = one bf16 pass (~4e-3 relative error — outside conformance bounds),
#: "high" = three bf16 passes (~1e-6 relative), "highest" = full f32.
#: Selected per config via EstimatorConfig.matmul_precision, so the precision
#: keys the jit cache.
_ALGORITHMS = {
    "default": jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "highest": jax.lax.DotAlgorithmPreset.F32_F32_F32,
}


def precision_of(name: str, dtype=jnp.float32):
    """Dot algorithm for `name` at operand dtype `dtype` (real or complex).

    The names describe float32 arithmetic. Wider operands (the float64
    conformance runs) always multiply exactly: a float32 algorithm would
    round them to float32 first."""
    if name not in _ALGORITHMS:
        raise ValueError(f"unknown matmul precision {name!r}")
    if jnp.finfo(dtype).bits > 32:
        return jax.lax.Precision.HIGHEST
    return _ALGORITHMS[name]


def inpaint_matmul(
    values: jnp.ndarray, w: jnp.ndarray, precision=jax.lax.Precision.HIGHEST
) -> jnp.ndarray:
    """Apply the inpainting operator: (..., n_re) complex -> (..., n_sc) complex.

    A single bf16 pass would degrade the channel estimate to ~1e-3 relative
    error — far outside conformance bounds. Default to HIGHEST; callers thread
    `precision_of(EstimatorConfig.matmul_precision, dtype)` through.
    """
    wr = w.astype(jnp.real(values).dtype)
    re = jnp.matmul(jnp.real(values), wr, precision=precision)
    im = jnp.matmul(jnp.imag(values), wr, precision=precision)
    return jax.lax.complex(re, im)


def lerp_gather(values: jnp.ndarray, left: np.ndarray, right: np.ndarray, alpha: np.ndarray) -> jnp.ndarray:
    """Linear interpolation via static gather tables.

    values: (..., n_re) complex pilot-position estimates.
    left/right: (n_out,) int static ordinals into the last axis.
    alpha: (n_out,) static real blend weights.

    Replaces the reference's per-gap Python loop / searchsorted interpolation
    (ce_rule_baseline.py:303-320, ce_rule_tensorized.py:311-340) with one gather + FMA.
    """
    lv = jnp.take(values, jnp.asarray(left), axis=-1)
    rv = jnp.take(values, jnp.asarray(right), axis=-1)
    a = jnp.asarray(alpha, dtype=jnp.real(values).dtype)
    return lv + a * (rv - lv)


def fro_norm_sq(x: jnp.ndarray) -> jnp.ndarray:
    """||x||_F^2 over all axes (reference _fro_norm_sq, ce_rule_baseline.py:466-468)."""
    return jnp.sum(jnp.abs(x) ** 2)
