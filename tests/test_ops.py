"""Primitive-level parity: jnp DSP ops vs the float64 numpy oracle implementations."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from srsran_ce.ops import dsp
from srsran_ce.utils import oracle


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unwrap_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(rng.uniform(-2.5, 2.5, size=64))
    ph_wrapped = np.angle(np.exp(1j * ph))
    got = np.asarray(dsp.unwrap_phase(jnp.asarray(ph_wrapped)))
    want = np.unwrap(ph_wrapped)
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(oracle.unwrap_phase(ph_wrapped), want, atol=1e-12)


@pytest.mark.parametrize("n,k", [(16, 3), (32, 7), (57, 15), (5, 5)])
def test_conv_same_zero_matches_matlab_same(n, k):
    rng = np.random.default_rng(n * k)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    h = rng.standard_normal(k)
    want = oracle.conv_same(x, h)
    got = np.asarray(dsp.conv_same_zero(jnp.asarray(x), h))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_conv_same_zero_batched():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 33)) + 1j * rng.standard_normal((4, 33))
    h = rng.standard_normal(9)
    got = np.asarray(dsp.conv_same_zero(jnp.asarray(x), h))
    for i in range(4):
        np.testing.assert_allclose(got[i], oracle.conv_same(x[i], h), atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64])
def test_conv3_reflect_matches_oracle(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = oracle.conv_same_reflect(x, np.array([0.25, 0.5, 0.25]))
    got = np.asarray(dsp.conv3_reflect(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_cnn_lowpass(passes):
    rng = np.random.default_rng(passes)
    x = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    want = oracle.cnn_lowpass(x, passes=passes)
    got = np.asarray(dsp.cnn_lowpass(jnp.asarray(x), passes=passes))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n,comb", [(24, 2), (48, 4), (36, 3)])
def test_cnn_inpaint_matches_oracle(n, comb):
    rng = np.random.default_rng(n)
    known = np.zeros(n, dtype=bool)
    known[::comb] = True
    x = np.where(known, rng.standard_normal(n) + 1j * rng.standard_normal(n), 0.0)
    n_iters = max(6, n // 8)
    want = oracle.cnn_inpaint(x, known, n_iters=n_iters)
    got = np.asarray(dsp.cnn_inpaint(jnp.asarray(x), known, n_iters))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4, 8, 12])
def test_virtual_pilot_matrix_matches_oracle(n):
    from srsran_ce.models.plan import _virtual_pilot_matrix

    rng = np.random.default_rng(n)
    p = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = oracle.create_virtual_pilots(p, n)
    M = _virtual_pilot_matrix(n, n)
    amp = M @ np.abs(p)
    ph = M @ oracle.unwrap_phase(np.angle(p))
    got = amp * np.exp(1j * ph)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_rc_filter_properties():
    rc, corr = oracle.get_rc_filter(2, 3)
    assert rc.size % 2 == 1
    np.testing.assert_allclose(rc.sum(), 1.0, atol=1e-14)
    assert np.all(np.isfinite(corr))


def test_lerp_gather_linear_interp():
    # pilots at positions 0, 3, 6 of a length-8 lattice
    filled = np.array([0, 3, 6])
    n_re = 3
    pos = np.arange(8)
    right = np.clip(np.searchsorted(filled, pos, side="left"), 0, n_re - 1)
    left = np.clip(right - 1, 0, n_re - 1)
    fl, fr = filled[left].astype(float), filled[right].astype(float)
    alpha = np.where(fr > fl, (pos - fl) / np.maximum(fr - fl, 1), 0.0)
    alpha = np.where(pos <= filled[0], 0.0, alpha)
    alpha = np.where(pos >= filled[-1], 0.0, alpha)
    left = np.where(pos >= filled[-1], n_re - 1, left)
    right = np.where(pos >= filled[-1], n_re - 1, right)
    vals = jnp.asarray(np.array([1.0 + 0j, 4.0, 7.0]))
    got = np.asarray(dsp.lerp_gather(vals, left, right, alpha))
    want = np.array([1, 2, 3, 4, 5, 6, 7, 7], dtype=np.complex128)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_variant_presets():
    """Reference-variant presets map onto the shared core's config space."""
    from srsran_ce import baseline_config, cnn_config, tensorized_config

    b = baseline_config(30e3)
    t = tensorized_config(30e3)
    c = cnn_config(30e3, cnn_alpha=0.2)
    assert b == t  # mathematically identical in the reference too
    assert b.interp == "linear" and c.interp == "cnn"
    assert c.cnn_alpha == 0.2


@pytest.mark.parametrize(
    "name,algorithm",
    [
        ("default", jax.lax.DotAlgorithmPreset.BF16_BF16_F32),
        ("high", jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3),
        ("highest", jax.lax.DotAlgorithmPreset.F32_F32_F32),
    ],
)
def test_precision_names_map_to_dot_algorithms(name, algorithm):
    """A precision name is one explicit dot algorithm for float32 operands,
    real or complex — the same arithmetic on every backend."""
    assert dsp.precision_of(name, jnp.float32) is algorithm
    assert dsp.precision_of(name, jnp.complex64) is algorithm
    assert dsp.precision_of(name) is algorithm


@pytest.mark.parametrize("name", ["default", "high", "highest"])
def test_precision_of_wide_operands_is_exact(name):
    """float64 operands never go through a float32 algorithm (it would round
    them to float32 first): every name multiplies them exactly."""
    assert dsp.precision_of(name, jnp.float64) is jax.lax.Precision.HIGHEST
    assert dsp.precision_of(name, jnp.complex128) is jax.lax.Precision.HIGHEST
    a = np.random.default_rng(0).standard_normal((4, 8))
    got = jnp.matmul(a, a.T, precision=dsp.precision_of(name, a.dtype))
    np.testing.assert_allclose(np.asarray(got), a @ a.T, rtol=1e-14)


def test_precision_of_unknown_name():
    with pytest.raises(ValueError, match="unknown matmul precision"):
        dsp.precision_of("tf32")
