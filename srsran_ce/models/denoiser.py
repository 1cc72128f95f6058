"""Trainable pilot-estimate denoiser — the learned upgrade of the reference's CNN.

The reference's "CNN" variant is an untrained, fixed-weight [0.25, 0.5, 0.25]
iterative smoother (ce_dl_cnn.py:454-508; SURVEY.md §2 notes "no nn.Module, no
parameters, no training loop ... room for a trainable-weights extension"). This
module provides that extension as a trainable model written directly on
`lax.conv_general_dilated`: a small residual 1-D CNN over the frequency axis of the per-pilot LS estimates, trained on synthetic channels to
minimize NMSE against ground truth.

Integration: `smoothing="learned"` in EstimatorConfig routes the estimator's
smoothing stage through this network (the built function then takes a `params`
pytree as an extra argument). Everything stays ri-layout / static-shape, so the
denoiser runs inside the same single jitted XLA program as the rest of the chain.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Convolutions multiply in full float32 on every backend (a bare default would
# let a GPU round the operands to TF32).
_CONV_PRECISION = jax.lax.Precision.HIGHEST


def _init_stack(rng_key, window: Tuple[int, ...], features: Sequence[int]) -> dict:
    """Params of a residual conv stack on 2 (re/im) channels, in the tree layout
    {"params": {"Conv_i": {"kernel": window + (c_in, c_out), "bias": (c_out,)}}}.
    Hidden kernels are LeCun-normal; the output conv starts at zero, so the
    residual starts exactly at identity and an untrained network reproduces
    smoothing="none" bit-for-bit. Layer i draws from `rng_key` folded with the
    first 4 bytes of sha1("Conv_i" + b"\\x01") — the derivation the shipped
    checkpoints' training runs used, so a given seed gives the same weights."""
    init = jax.nn.initializers.lecun_normal()
    chans = (2,) + tuple(features) + (2,)

    def layer_key(i):
        digest = hashlib.sha1(f"Conv_{i}".encode() + b"\x01").digest()
        return jax.random.fold_in(rng_key, jnp.uint32(int.from_bytes(digest[:4], "big")))

    layers = {}
    for i, (c_in, c_out) in enumerate(zip(chans[:-1], chans[1:])):
        shape = tuple(window) + (c_in, c_out)
        last = i == len(chans) - 2
        layers[f"Conv_{i}"] = {
            "kernel": jnp.zeros(shape, jnp.float32) if last else init(layer_key(i), shape, jnp.float32),
            "bias": jnp.zeros((c_out,), jnp.float32),
        }
    return {"params": layers}


def _layer_names(p: dict):
    return sorted(p.keys(), key=lambda s: int(s.rsplit("_", 1)[1]))


def _apply_stack(params, x: jnp.ndarray, n_spatial: int) -> jnp.ndarray:
    """x + conv_stack(x) for x of shape (..., *spatial, 2): SAME zero padding on
    every layer, ReLU between layers. Leading axes batch."""
    p = params["params"]
    lead = x.shape[: x.ndim - n_spatial - 1]
    h = x.reshape((-1,) + x.shape[x.ndim - n_spatial - 1 :])
    spec = ("NWC", "WIO", "NWC") if n_spatial == 1 else ("NHWC", "HWIO", "NHWC")
    names = _layer_names(p)
    for i, name in enumerate(names):
        k = jnp.asarray(p[name]["kernel"], h.dtype)
        h = jax.lax.conv_general_dilated(
            h, k, window_strides=(1,) * n_spatial,
            padding=[(w // 2, w // 2) for w in k.shape[:n_spatial]],
            dimension_numbers=spec, precision=_CONV_PRECISION,
        ) + jnp.asarray(p[name]["bias"], h.dtype)
        if i < len(names) - 1:
            h = jax.nn.relu(h)
    return x + h.reshape(lead + h.shape[1:])


@dataclass(frozen=True)
class PilotDenoiser:
    """Residual 1-D CNN over the pilot/frequency axis.

    Input/output: (..., n_re, 2) — re/im channels last. The residual connection
    makes the identity (raw LS estimate) the zero-init fixed point, so an untrained
    network degrades gracefully to smoothing="none".
    """

    # Default architecture from a swept comparison (0 dB SNR pilot-level NMSE):
    # (32,32)k5 -10.4 dB < (48,48)k9 -11.6 < (48,48)k13 -11.8; deeper/wider
    # saturates. k13 x 3 layers => halo_width 18 for the sharded path.
    features: Sequence[int] = (48, 48)
    kernel_size: int = 13

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        return _apply_stack(params, x, 1)


def init_params(rng_key, n_re: int = 128):
    """Fresh params; `n_re` is accepted for symmetry with the data (the model
    is fully convolutional, its params do not depend on the length)."""
    del n_re
    m = PilotDenoiser()
    return _init_stack(rng_key, (m.kernel_size,), m.features)


def halo_width(model: PilotDenoiser | None = None) -> int:
    """Receptive-field half-width of the conv stack: the number of neighbor pilots
    each output depends on. This sizes the overlap-save halo exchange when the
    denoiser runs inside the subcarrier-sharded estimator (parallel/subcarrier.py):
    each conv layer (len(features) hidden + 1 output) sees kernel_size//2 on each
    side."""
    m = model or PilotDenoiser()
    return (m.kernel_size // 2) * (len(m.features) + 1)


def apply_sharded(params, h_p: jnp.ndarray, exchange) -> jnp.ndarray:
    """Subcarrier-sharded denoiser: layer-wise overlap-save halo exchange.

    h_p: (n_layers, R) complex local pilot block. `exchange(x, h)` must return
    (left, right) = the h-wide neighbor halos of x along its LAST axis, zero-filled
    at the outermost shards (parallel.subcarrier._halo_exchange semantics).

    Why layer-wise: the stack SAME-pads *each layer's input* with zeros at the true
    band edges. A single pre-padded apply would instead propagate relu(bias)
    activations from the halo region into edge outputs. Exchanging a
    kernel_size//2 halo before every conv and running it VALID reproduces the
    unsharded stack exactly at every output position (zero halos at the extremes
    == that layer's SAME padding).
    """
    p = params["params"]
    names = _layer_names(p)
    rdtype = jnp.real(h_p).dtype
    x = jnp.stack([jnp.real(h_p), jnp.imag(h_p)], axis=-1).astype(jnp.float32)
    x0 = x
    dn = jax.lax.conv_dimension_numbers(
        x.shape, (1, 1, 1), ("NWC", "WIO", "NWC")
    )
    for i, name in enumerate(names):
        k = jnp.asarray(p[name]["kernel"], jnp.float32)  # (ksize, c_in, c_out)
        b = jnp.asarray(p[name]["bias"], jnp.float32)
        hw = k.shape[0] // 2
        # exchange along the spatial axis (axis 1 of (nL, R, C))
        xm = jnp.moveaxis(x, 1, -1)  # (nL, C, R)
        left, right = exchange(xm, hw)
        ext = jnp.concatenate([left, xm, right], axis=-1)
        ext = jnp.moveaxis(ext, -1, 1)  # (nL, R + 2*hw, C)
        x = jax.lax.conv_general_dilated(
            ext, k, window_strides=(1,), padding="VALID", dimension_numbers=dn,
            precision=_CONV_PRECISION,
        ) + b[None, None, :]
        if i < len(names) - 1:
            x = jax.nn.relu(x)
    y = (x0 + x).astype(rdtype)
    return jax.lax.complex(y[..., 0], y[..., 1]).astype(h_p.dtype)


def apply_complex(params, h_p: jnp.ndarray) -> jnp.ndarray:
    """Denoise (n_layers, n_re) complex pilot estimates; returns same shape/dtype."""
    rdtype = jnp.real(h_p).dtype
    x = jnp.stack([jnp.real(h_p), jnp.imag(h_p)], axis=-1).astype(jnp.float32)
    y = PilotDenoiser().apply(params, x)
    y = y.astype(rdtype)
    return jax.lax.complex(y[..., 0], y[..., 1]).astype(h_p.dtype)


@dataclass(frozen=True)
class PilotDenoiser2D:
    """Residual 2-D CNN over the (DM-RS symbol, frequency) grid of per-symbol LS
    estimates — the DL-based time-frequency channel estimator of the literature
    (e.g. arXiv:2109.10667, arXiv:1810.05893: treat the pilot grid as a 2-channel
    image) specialized to the DM-RS lattice. Exploits time correlation the 1-D
    PilotDenoiser cannot see; pairs with config.time_interp="linear", which carries
    the denoised per-symbol profiles to every allocated OFDM symbol.

    Input/output: (..., n_dsym, n_re, 2). Zero-init residual: untrained ==
    identity == smoothing "none" bit-for-bit.
    """

    features: Sequence[int] = (32, 32)
    kernel_t: int = 3
    kernel_f: int = 9

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        return _apply_stack(params, x, 2)


def init_params_2d(rng_key, n_dsym: int = 4, n_re: int = 128):
    """Fresh 2-D params (fully convolutional: the grid size does not matter)."""
    del n_dsym, n_re
    m = PilotDenoiser2D()
    return _init_stack(rng_key, (m.kernel_t, m.kernel_f), m.features)


def halo_width_2d(model: "PilotDenoiser2D | None" = None) -> int:
    """Frequency-axis receptive-field half-width of the 2-D conv stack (the time
    axis is never sharded)."""
    m = model or PilotDenoiser2D()
    return (m.kernel_f // 2) * (len(m.features) + 1)


def apply_sharded_2d(params, h_t: jnp.ndarray, exchange) -> jnp.ndarray:
    """Subcarrier-sharded 2-D denoiser: layer-wise halo exchange on the frequency
    axis, SAME zero padding on the (local) time axis.

    h_t: (n_layers, n_dsym, R) complex local per-symbol pilot block. `exchange`
    as in apply_sharded. Same layer-wise rationale: zero halos at the outermost
    shards reproduce each conv layer's SAME padding at the true band edges.
    """
    p = params["params"]
    names = _layer_names(p)
    rdtype = jnp.real(h_t).dtype
    x = jnp.stack([jnp.real(h_t), jnp.imag(h_t)], axis=-1).astype(jnp.float32)
    x0 = x  # (nL, n_dsym, R, C)
    dn = jax.lax.conv_dimension_numbers(
        x.shape, (1, 1, 1, 1), ("NHWC", "HWIO", "NHWC")
    )
    for i, name in enumerate(names):
        k = jnp.asarray(p[name]["kernel"], jnp.float32)  # (kt, kf, c_in, c_out)
        b = jnp.asarray(p[name]["bias"], jnp.float32)
        kt, kf = k.shape[0], k.shape[1]
        hw = kf // 2
        # exchange along the frequency axis (axis 2 of (nL, n_dsym, R, C))
        xm = jnp.moveaxis(x, 2, -1)  # (nL, n_dsym, C, R)
        left, right = exchange(xm, hw)
        ext = jnp.concatenate([left, xm, right], axis=-1)
        ext = jnp.moveaxis(ext, -1, 2)  # (nL, n_dsym, R + 2*hw, C)
        x = jax.lax.conv_general_dilated(
            ext,
            k,
            window_strides=(1, 1),
            padding=((kt // 2, kt // 2), (0, 0)),  # SAME in time, VALID in freq
            dimension_numbers=dn,
            precision=_CONV_PRECISION,
        ) + b[None, None, None, :]
        if i < len(names) - 1:
            x = jax.nn.relu(x)
    y = (x0 + x).astype(rdtype)
    return jax.lax.complex(y[..., 0], y[..., 1]).astype(h_t.dtype)


def apply_complex_2d(params, h_t: jnp.ndarray) -> jnp.ndarray:
    """Denoise (n_layers, n_dsym, n_re) complex per-symbol pilot estimates."""
    rdtype = jnp.real(h_t).dtype
    x = jnp.stack([jnp.real(h_t), jnp.imag(h_t)], axis=-1).astype(jnp.float32)
    y = PilotDenoiser2D().apply(params, x)
    y = y.astype(rdtype)
    return jax.lax.complex(y[..., 0], y[..., 1]).astype(h_t.dtype)


# ---------------------------------------------------------------------------
# Synthetic training data: noisy LS estimates + ground truth at pilot REs
# ---------------------------------------------------------------------------


def make_training_batch(
    rng: np.random.Generator,
    batch: int,
    n_re: int,
    snr_db_range: Tuple[float, float] = (0.0, 30.0),
    n_taps: int = 6,
    max_delay_frac: float = 0.02,
):
    """(noisy_ls, truth): (B, n_re, 2) float32 pairs.

    Physics matches utils/synthetic._tdl_frequency_response: multipath frequency
    responses sampled at comb-spaced pilot positions, pilot-despread LS estimates
    corrupted by AWGN at a per-sample random SNR.
    """
    nfft = 2048.0
    delays = rng.uniform(0.0, max_delay_frac * nfft, size=(batch, n_taps))
    delays[:, 0] = 0.0
    power = np.exp(-delays / (max_delay_frac * nfft / 3.0 + 1e-9))
    power /= power.sum(axis=1, keepdims=True)
    gains = (rng.standard_normal((batch, n_taps)) + 1j * rng.standard_normal((batch, n_taps)))
    gains *= np.sqrt(power / 2.0)
    k = np.arange(n_re, dtype=np.float64) * 2.0  # comb-2 pilot spacing
    phase = np.exp(-2j * np.pi * k[None, :, None] * delays[:, None, :] / nfft)
    truth = np.einsum("brt,bt->br", phase, gains)

    snr_db = rng.uniform(*snr_db_range, size=(batch, 1))
    noise_std = 10.0 ** (-snr_db / 20.0)
    noisy = truth + noise_std * (
        rng.standard_normal((batch, n_re)) + 1j * rng.standard_normal((batch, n_re))
    ) / np.sqrt(2.0)

    to_ri = lambda z: np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return to_ri(noisy), to_ri(truth)


def nmse_loss(params, noisy_ri: jnp.ndarray, truth_ri: jnp.ndarray) -> jnp.ndarray:
    pred = PilotDenoiser().apply(params, noisy_ri)
    err = jnp.sum((pred - truth_ri) ** 2)
    ref = jnp.sum(truth_ri**2) + 1e-12
    return err / ref


def make_training_batch_2d(
    rng: np.random.Generator,
    batch: int,
    n_re: int,
    n_dsym: int = 4,
    snr_db_range: Tuple[float, float] = (0.0, 30.0),
    doppler_hz_max: float = 600.0,
    scs_hz: float = 30e3,
    n_taps: int = 6,
    max_delay_frac: float = 0.02,
):
    """(noisy_ls, truth): (B, n_dsym, n_re, 2) float32 pairs.

    Same multipath physics as make_training_batch plus per-tap Doppler rotation
    across DM-RS symbol times (utils/synthetic.make_case doppler_hz path): each
    sample draws a Doppler spread in [0, doppler_hz_max], so the model learns both
    frequency smoothing and time tracking.
    """
    nfft = 2048.0
    delays = rng.uniform(0.0, max_delay_frac * nfft, size=(batch, n_taps))
    delays[:, 0] = 0.0
    power = np.exp(-delays / (max_delay_frac * nfft / 3.0 + 1e-9))
    power /= power.sum(axis=1, keepdims=True)
    gains = (rng.standard_normal((batch, n_taps)) + 1j * rng.standard_normal((batch, n_taps)))
    gains *= np.sqrt(power / 2.0)
    k = np.arange(n_re, dtype=np.float64) * 2.0  # comb-2 pilot spacing
    phase_f = np.exp(-2j * np.pi * k[None, :, None] * delays[:, None, :] / nfft)  # (B, n_re, T)

    # DM-RS symbols spread across a 14-symbol slot; times in seconds (~1/scs units)
    sym_idx = np.unique(np.linspace(0, 13, n_dsym).round().astype(int))
    t_sym = (sym_idx * (1.0 + 144.0 / 2048.0)) / scs_hz  # (n_dsym,)
    dop = rng.uniform(0.0, doppler_hz_max, size=(batch, 1))
    f_d = rng.uniform(-1.0, 1.0, size=(batch, n_taps)) * dop  # (B, T)
    phase_t = np.exp(2j * np.pi * t_sym[None, :, None] * f_d[:, None, :])  # (B, n_dsym, T)

    truth = np.einsum("brt,bst,bt->bsr", phase_f, phase_t, gains)  # (B, n_dsym, n_re)

    snr_db = rng.uniform(*snr_db_range, size=(batch, 1, 1))
    noise_std = 10.0 ** (-snr_db / 20.0)
    noisy = truth + noise_std * (
        rng.standard_normal(truth.shape) + 1j * rng.standard_normal(truth.shape)
    ) / np.sqrt(2.0)

    to_ri = lambda z: np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return to_ri(noisy), to_ri(truth)


def nmse_loss_2d(params, noisy_ri: jnp.ndarray, truth_ri: jnp.ndarray) -> jnp.ndarray:
    pred = PilotDenoiser2D().apply(params, noisy_ri)
    err = jnp.sum((pred - truth_ri) ** 2)
    ref = jnp.sum(truth_ri**2) + 1e-12
    return err / ref
