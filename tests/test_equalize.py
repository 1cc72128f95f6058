"""MMSE equalization (ops/equalize) — the downstream consumer of the estimates.

Checks, in order of increasing integration depth:
  1. dense path vs an independent float64 numpy oracle of the per-RE MMSE solve;
  2. factored path == dense path on the hop's symbols (the rank-1 Gram-sharing
     optimization must be a pure refactoring, not an approximation);
  3. closed-form SINR for the scalar (1 rx, 1 layer) case;
  4. end-to-end: estimate a synthetic channel with out_layout="factored", then
     equalize a payload transmitted through the TRUE channel — recovered QPSK
     must match the transmitted constellation at high SNR.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srsran_ce.models import estimator
from srsran_ce.ops import equalize
from srsran_ce.utils import synthetic


def _numpy_mmse(y, h, noise_var, beta):
    """Independent per-RE oracle: x = (H^H H + s I)^-1 H^H y / beta, SINR from
    the diagonal of the regularized inverse. y (n_rx, n_sc, n_sym), h
    (n_rx, n_sc, n_sym, nL)."""
    n_rx, n_sc, n_sym = y.shape
    nL = h.shape[-1]
    s = noise_var / (beta * beta)
    x = np.zeros((n_sc, n_sym, nL), dtype=np.complex128)
    sinr = np.zeros((n_sc, n_sym, nL))
    for k in range(n_sc):
        for t in range(n_sym):
            hm = h[:, k, t, :]  # (n_rx, nL)
            a = hm.conj().T @ hm + s * np.eye(nL)
            inv = np.linalg.inv(a)
            x[k, t] = inv @ (hm.conj().T @ y[:, k, t]) / beta
            d = np.real(np.diag(inv))
            sinr[k, t] = np.maximum(1.0 / np.maximum(d * s, 1e-30) - 1.0, 0.0)
    return x, sinr


def _rand_cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("n_rx,n_layers", [(1, 1), (2, 2), (4, 2), (2, 1)])
def test_dense_matches_numpy_oracle(n_rx, n_layers):
    rng = np.random.default_rng(7)
    n_sc, n_sym, beta, noise_var = 24, 5, 1.4142, 0.03
    h = _rand_cplx(rng, (n_rx, n_sc, n_sym, n_layers))
    y = _rand_cplx(rng, (n_rx, n_sc, n_sym))
    x_j, sinr_j = equalize.mmse_equalize(
        jnp.asarray(y), jnp.asarray(h), jnp.asarray(noise_var), beta=beta
    )
    x_o, sinr_o = _numpy_mmse(y, h, noise_var, beta)
    np.testing.assert_allclose(np.asarray(x_j), x_o, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sinr_j), sinr_o, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n_rx,n_layers", [(1, 1), (2, 2), (4, 4)])
def test_factored_matches_dense(n_rx, n_layers):
    """The factored path's once-per-subcarrier filter must equal the dense
    per-RE filter whenever H[sc,sym] = P[sc]·r[sym] with |r| = 1."""
    rng = np.random.default_rng(3)
    n_sc, n_sym, sym_start, n_alloc = 36, 14, 2, 9
    noise_var, beta = 0.05, 0.9
    prof = _rand_cplx(rng, (n_rx, n_layers, n_sc))
    rot = np.exp(1j * rng.uniform(-np.pi, np.pi, n_sym))
    h = np.einsum("rlk,t->rktl", prof, rot)  # (n_rx, n_sc, n_sym, nL)
    y = _rand_cplx(rng, (n_rx, n_sc, n_sym))

    x_d, sinr_d = equalize.mmse_equalize(
        jnp.asarray(y), jnp.asarray(h), jnp.asarray(noise_var), beta=beta
    )
    x_f, sinr_f = equalize.mmse_equalize_factored(
        jnp.asarray(y), jnp.asarray(prof), jnp.asarray(rot),
        jnp.asarray(noise_var), sym_start, n_alloc, beta=beta,
    )
    sl = slice(sym_start, sym_start + n_alloc)
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_d)[:, sl], rtol=1e-9, atol=1e-11)
    # dense SINR is per (sc, sym) but time-invariant here; factored is per sc
    np.testing.assert_allclose(
        np.asarray(sinr_f)[:, None, :].repeat(n_alloc, 1),
        np.asarray(sinr_d)[:, sl], rtol=1e-8, atol=1e-8,
    )


def test_sinr_closed_form_scalar():
    """1 rx, 1 layer: post-MMSE SINR == |h|² β² / σ² exactly."""
    h = np.array([0.7 - 0.4j])
    noise_var, beta = 0.02, 1.3
    _, sinr = equalize.mmse_equalize(
        jnp.ones((1, 1, 1), jnp.complex128),
        jnp.asarray(h.reshape(1, 1, 1, 1)),
        jnp.asarray(noise_var),
        beta=beta,
    )
    expect = abs(h[0]) ** 2 * beta**2 / noise_var
    np.testing.assert_allclose(float(np.asarray(sinr)[0, 0, 0]), expect, rtol=1e-9)


def test_end_to_end_estimate_then_equalize():
    """Estimate (factored layout) on a synthetic sounding, then equalize a QPSK
    payload sent through the TRUE channel (with the same CFO ramp) using the
    ESTIMATED factors. At 35 dB the symbol decisions must be error-free and the
    EVM small."""
    case = synthetic.make_case(seed=11, n_prbs=24, n_layers=1, snr_db=35.0, cfo_hz=250.0)
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, 1, out_layout="factored")
    res = fn(
        estimator.split_ri(case.received_rg),
        estimator.split_ri(case.pilots),
        jnp.asarray(case.beta),
    )
    prof = estimator.merge_ri(np.asarray(res.profiles))  # (1, 1, n_sc)
    rot = estimator.merge_ri(np.asarray(res.sym_rot))  # (14,)
    noise = float(np.asarray(res.noise_est))

    # Transmit a fresh QPSK payload through the true channel + true CFO ramp.
    rng = np.random.default_rng(99)
    n_sc, n_sym = case.true_channel.shape[:2]
    x_tx = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, (n_sc, n_sym))))
    scs = case.config.scs_hz
    cpds = case.config.cp_durations_np * scs / 1000.0
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    cfo_rot = np.exp(1j * 2 * np.pi * np.cumsum(vec) * (250.0 / scs))
    y = case.true_channel[:, :, 0] * x_tx * cfo_rot[None, :n_sym]
    y += 10 ** (-35.0 / 20.0) / np.sqrt(2) * _rand_cplx(rng, y.shape)

    x_hat, sinr = equalize.mmse_equalize_factored(
        jnp.asarray(y[None]), jnp.asarray(prof[0][None]), jnp.asarray(rot),
        jnp.asarray(noise), case.hop1.start_symbol, case.hop1.n_allocated_symbols,
        beta=case.beta,
    )
    x_hat = np.asarray(x_hat)[:, :, 0]
    ref = x_tx[:, case.hop1.start_symbol : case.hop1.start_symbol + case.hop1.n_allocated_symbols]
    # hard-decision QPSK: all symbols correct
    dec = np.exp(1j * (np.floor(np.angle(x_hat * np.exp(-1j * np.pi / 4)) / (np.pi / 2) + 0.5) * np.pi / 2 + np.pi / 4))
    assert np.all(np.abs(dec - ref) < 1e-6), "QPSK symbol errors after equalization"
    evm = np.sqrt(np.mean(np.abs(x_hat - ref) ** 2))
    assert evm < 0.1, f"EVM too high: {evm}"
    # per-subcarrier SINR tracks the channel: high typically, lower in fades
    assert float(np.median(np.asarray(sinr))) > 100.0  # >20 dB typical
    assert float(np.min(np.asarray(sinr))) > 1.0  # >0 dB even in fades


@pytest.mark.parametrize("nL", [1, 2, 3, 4, 5])
def test_hermitian_inverse_lead_closed_forms(nL):
    """Closed-form leading-axis inverses (adjugate nL<=3, 2x2-block Schur nL=4,
    linalg fallback above) vs numpy.linalg.inv on random regularized Gram
    matrices — the exact structure the equalizer feeds them."""
    from srsran_ce.ops.equalize import _hermitian_inverse_lead

    rng = np.random.default_rng(5)
    n_rx, n_b = max(nL, 2), 37
    h = _rand_cplx(rng, (n_b, n_rx, nL))
    a = np.swapaxes(h.conj(), -1, -2) @ h + 0.01 * np.eye(nL)
    inv_ref = np.linalg.inv(a)
    a_lead = np.moveaxis(a, (-2, -1), (0, 1))  # (nL, nL, n_b)
    inv = np.asarray(_hermitian_inverse_lead(jnp.asarray(a_lead)))
    np.testing.assert_allclose(
        np.moveaxis(inv, (0, 1), (-2, -1)), inv_ref, rtol=1e-9, atol=1e-11
    )
