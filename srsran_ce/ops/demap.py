"""Soft demapper: exact max-log-MAP bit LLRs from equalized symbols + SINR.

Completes the uplink receiver chain past the reference's endpoint (the
reference stops at the channel estimate, ce_rule_baseline.py:761-768; this
framework adds MMSE equalization in ops/equalize and bit LLRs here). The
per-RE model after MMSE equalization is the standard scalar channel

    x_hat = alpha * x + z,   alpha = sinr / (1 + sinr),  var(z) = alpha*(1-alpha)

whose unbiased estimate x_tilde = x_hat / alpha sees complex noise variance
1 / sinr — the per-RE post-MMSE SINR is exactly what the equalizer already
returns, so demapping needs no extra channel state.

For the square Gray-mapped QAM constellations of TS 38.211 §5.1 (QPSK, 16QAM,
64QAM, 256QAM, 1024QAM; BPSK demaps on its diagonal axis) the I and Q bit
groups demap independently, so the exact
max-log LLR per bit is a min over at most 2^(m-1) PAM levels per hypothesis
(16 at 1024QAM) — computed as a closed-form Gray fold of a few elementwise
ops per RE; no per-constellation-point Python loops and no approximation (this is EXACT max-log, verified against a brute-force
2D constellation scan in tests/test_demap.py).

LLR sign convention: positive = bit 0 more likely (3GPP soft-bit convention,
bit b maps to amplitude via (1-2b)). Bit order is the TS 38.211 word order
b0 b1 b2 ... (b0/b1 = I/Q sign, b2/b3 = I/Q first magnitude bit, ...).

Everything is jittable/vmappable and shape-agnostic (trailing bit axis added).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# m = bits per PAM axis; levels are odd integers scaled by 1/sqrt(norm)
# (TS 38.211 §5.1.3-§5.1.6 normalizations).
_QAM_NORM = {1: 2.0, 2: 10.0, 3: 42.0, 4: 170.0, 5: 682.0}

MODULATIONS = ("bpsk", "qpsk", "16qam", "64qam", "256qam", "1024qam")


def bits_per_symbol(modulation: str) -> int:
    try:
        return {
            "bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8,
            "1024qam": 10,
        }[modulation]
    except KeyError:
        raise ValueError(f"modulation must be one of {MODULATIONS}: {modulation!r}")


def _pam_level(bits) -> float:
    """TS 38.211 Gray PAM level (odd integer, unnormalized) for axis bits
    (b_sign, b_mag1, b_mag2, ...). The spec's nested form, e.g. 64QAM
    (§5.1.5): (1-2b0) * [4 - (1-2b2) * (2 - (1-2b4))] — built innermost-out."""
    f = 1.0
    p = 2.0
    for b in reversed(bits[1:]):
        f = p - (1.0 - 2.0 * b) * f
        p *= 2.0
    return (1.0 - 2.0 * bits[0]) * f


def _pam_table(m: int):
    """(levels, bits) for one PAM axis: levels (2^m,) float64 odd integers,
    bits (2^m, m) in axis bit order (sign, mag1, ...)."""
    n = 1 << m
    levels = np.empty(n)
    bits = np.empty((n, m), np.int64)
    for w in range(n):
        bw = [(w >> (m - 1 - k)) & 1 for k in range(m)]
        bits[w] = bw
        levels[w] = _pam_level(bw)
    return levels, bits


def constellation(modulation: str) -> np.ndarray:
    """Unit-energy Gray-mapped constellation indexed by the TS 38.211 bit word
    (b0..b_{n-1} -> index sum b_k 2^(n-1-k)). Host-side numpy (modulators and
    the test oracle use it)."""
    nbits = bits_per_symbol(modulation)
    if nbits == 1:
        # TS 38.211 5.1.2 BPSK: d = (1-2b)(1+j)/sqrt(2)
        return np.array([(1 + 1j), (-1 - 1j)]) / np.sqrt(2.0)
    m = nbits // 2
    s = np.sqrt(_QAM_NORM[m])
    pts = np.empty(1 << nbits, np.complex128)
    for w in range(1 << nbits):
        b = [(w >> (nbits - 1 - k)) & 1 for k in range(nbits)]
        pts[w] = (_pam_level(b[0::2]) + 1j * _pam_level(b[1::2])) / s
    return pts


def _llr_list(x: jnp.ndarray, sinr: jnp.ndarray, modulation: str):
    """Shared compute for `llrs` / `llr_planes`: the nbits per-bit LLR arrays
    (each x.shape) in TS 38.211 word order, as a list."""
    nbits = bits_per_symbol(modulation)
    m = nbits // 2
    rdt = jnp.real(x).dtype
    sinr = jnp.broadcast_to(jnp.asarray(sinr, rdt), x.shape)
    alpha = sinr / (1.0 + sinr)
    xt_scale = jnp.where(sinr > 0, 1.0 / jnp.maximum(alpha, 1e-30), 0.0)
    if nbits == 1:
        # BPSK: one bit on the diagonal axis p = (1+j)/sqrt(2);
        # exact max-log LLR = 4 * sinr * Re(x_tilde * conj(p))
        t = (jnp.real(x) + jnp.imag(x)) * (xt_scale / np.sqrt(2.0))
        return [4.0 * t * sinr]
    norm = _QAM_NORM[m]
    s = np.sqrt(norm)
    # work in t-units (levels at odd integers): t = Re/Im(x_tilde) * sqrt(norm)
    # noise variance per real dim in t-units: norm / (2*sinr)
    # => 1/(2 sigma_t^2) = sinr / norm
    inv2var = sinr / norm

    def axis_llrs(t):
        # Closed-form fold recursion instead of a min over the 2^m levels.
        # For the TS 38.211 Gray PAM (level = (1-2b0) * [p - (1-2b1) * [...]]),
        # every magnitude bit is exactly the SIGN bit of a reflected sub-PAM:
        # with u_0 = t and u_{k+1} = 2^(m-1-k) - |u_k|, bit k's level subsets
        # map to the positive/negative odd integers in [-(n-1), n-1], n =
        # 2^(m-k), and distances are preserved ((|t| - l)^2 = (u - u_l)^2).
        # The max-log LLR of a sign bit is d1 - d0 with c_b the nearest odd
        # level of that sign (clipped to the edge); by odd symmetry compute it
        # on a = |u| where the nearest opposite-sign level is always -1 and
        # the nearest same-sign one is 2*floor(a/2)+1:
        #   LLR(u) = sign(u) * (c0+1)(2a - c0 + 1) * inv2var.
        # ~8 elementwise ops per bit — no (..., 2^m) broadcast (which cost
        # ~0.5 GB/axis of HBM traffic at 256QAM/106PRB/batch-128: measured 5x
        # the entire multi-RX receiver) and no min chain (an unrolled
        # running-min over the 16 levels measured ~1.6x this form). Exactness
        # is gated by the brute-force constellation-scan tests
        # (tests/test_demap.py); ties at even integers are equidistant, so the
        # floor-vs-nearest choice there is irrelevant.
        out = []
        u = t
        for k in range(m):
            n = 1 << (m - k)  # sub-PAM levels: odd integers in [-(n-1), n-1]
            if n == 2:
                out.append(4.0 * u * inv2var)
            else:
                a = jnp.abs(u)
                c0 = jnp.minimum(2.0 * jnp.floor(0.5 * a) + 1.0, float(n - 1))
                out.append(jnp.sign(u) * ((c0 + 1.0) * (2.0 * a - c0 + 1.0)) * inv2var)
            if k < m - 1:
                u = float(1 << (m - 1 - k)) - jnp.abs(u)
        return out

    li = axis_llrs(jnp.real(x) * (xt_scale * s))
    lq = axis_llrs(jnp.imag(x) * (xt_scale * s))
    inter = []
    for k in range(m):
        inter.append(li[k])
        inter.append(lq[k])
    return inter


def llrs(x: jnp.ndarray, sinr: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """Exact max-log-MAP bit LLRs for MMSE-equalized symbols.

    x: equalized symbols (any shape, complex) as returned by ops/equalize /
    models/receiver — noise-normalized MMSE outputs, i.e. alpha-biased
    estimates of the unit-energy constellation point; sinr: per-RE post-MMSE
    SINR (linear), broadcastable to x.shape. Returns real LLRs shaped
    x.shape + (bits_per_symbol,); positive = bit 0 likelier. REs with sinr=0
    (outside the allocation) return all-zero LLRs (erasures).
    """
    return jnp.stack(_llr_list(x, sinr, modulation), axis=-1)


def llr_planes(x: jnp.ndarray, sinr: jnp.ndarray, modulation: str) -> jnp.ndarray:
    """`llrs` with the bit axis LEADING: (bits_per_symbol,) + x.shape.

    The on-device form: each bit plane keeps x's layout (long subcarrier axis
    minor = contiguous writes). A trailing bit axis of 2-8 as the minor dim
    forces a full-grid relayout (an earlier measurement: ~2x the whole fused
    receiver's latency at 256QAM; not re-measured on the GPU)."""
    return jnp.stack(_llr_list(x, sinr, modulation), axis=0)


def modulate(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Host-side Gray-QAM modulator: bits (..., n_sym*bits_per_symbol) in
    {0,1} -> unit-energy symbols (..., n_sym). Inverse of `llrs` hard
    decisions; the end-to-end tests transmit with it."""
    nbits = bits_per_symbol(modulation)
    pts = constellation(modulation)
    b = np.asarray(bits)
    assert b.shape[-1] % nbits == 0, (b.shape, nbits)
    words = b.reshape(b.shape[:-1] + (-1, nbits))
    idx = np.zeros(words.shape[:-1], np.int64)
    for k in range(nbits):
        idx = (idx << 1) | words[..., k]
    return pts[idx]


def descramble_llrs(llr: jnp.ndarray, c: np.ndarray) -> jnp.ndarray:
    """Undo TS 38.211 §6.3.1.1 scrambling on soft bits: a scrambled bit
    b' = b XOR c has LLR(b) = (1-2c) * LLR(b'), i.e. a sign flip where c = 1.

    llr: LLRs in any shape/dtype (float or the receiver's int8 — quantization
    commutes with the sign flip since the clip range is symmetric at +-127);
    c: scrambling bits (ops/sequences.gold_sequence with
    pusch_scrambling_c_init), same shape (flatten the stream the same way the
    transmitter consumed it). Works host-side (numpy in, numpy out) and
    in-graph (jnp in).
    """
    c = np.asarray(c)
    if isinstance(llr, np.ndarray):
        sign = (1 - 2 * c.astype(np.int8)) if llr.dtype == np.int8 else (
            1.0 - 2.0 * c.astype(np.float32)
        )
        return llr * sign
    sign = jnp.asarray(1 - 2 * c.astype(np.int8), llr.dtype)
    return llr * sign
