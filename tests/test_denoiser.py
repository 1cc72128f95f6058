"""Trainable denoiser: training improves NMSE, checkpoints round-trip, and the
smoothing='learned' estimator path runs end-to-end (dp-sharded training included)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from srsran_ce.models import denoiser, estimator, training
from srsran_ce.parallel import mesh as mesh_lib
from srsran_ce.utils import synthetic


def test_training_reduces_nmse(tmp_path):
    rng = np.random.default_rng(0)
    state, tx = training.init_state(seed=0, n_re=64)
    noisy, truth = denoiser.make_training_batch(rng, 512, 64, snr_db_range=(5.0, 15.0))
    loss0 = float(denoiser.nmse_loss(state.params, noisy, truth))

    state, last_loss = training.train(n_steps=60, batch=128, n_re=64, seed=1, log_every=0, state=state)
    loss1 = float(denoiser.nmse_loss(state.params, noisy, truth))
    assert loss1 < 0.6 * loss0, (loss0, loss1)

    # checkpoint round trip (.npz)
    path = tmp_path / "ckpt"
    training.save_checkpoint(path, state)
    restored = training.load_checkpoint(path, seed=0, n_re=64)
    assert restored.step == state.step
    for a, b in zip(jax.tree_util.tree_leaves(restored.params), jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dp_sharded_train_step_matches_single():
    mesh = mesh_lib.make_mesh((8, 1), ("dp", "sp"))
    state, tx = training.init_state(seed=3, n_re=64)
    # Perturb the zero-init output conv: with exactly-zero gradients adam's
    # m/sqrt(v) normalization amplifies reassociation noise into sign flips,
    # which is an optimizer property, not a sharding bug.
    state = training.TrainState(
        jax.tree_util.tree_map(
            lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(7), x.shape, x.dtype),
            state.params,
        ),
        state.opt_state,
        state.step,
    )
    rng = np.random.default_rng(4)
    noisy, truth = denoiser.make_training_batch(rng, 64, 64)

    step_single = training.build_train_step(tx)
    step_dp = training.build_train_step(tx, mesh)
    p1, o1, l1 = step_single(state.params, state.opt_state, noisy, truth)
    p2, o2, l2 = step_dp(state.params, state.opt_state, noisy, truth)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-7)


def test_learned_smoothing_estimator_path():
    case = synthetic.make_case(seed=9, n_prbs=24, n_layers=2, smoothing="none", snr_db=10.0)
    # same geometry but learned smoothing
    from srsran_ce.config import EstimatorConfig

    cfg = EstimatorConfig(
        scs_hz=case.config.scs_hz,
        cp_durations_ms=case.config.cp_durations_ms,
        smoothing="learned",
        cfo_compensate=case.config.cfo_compensate,
    )
    n_re = case.pilots.shape[0]
    state, _ = training.init_state(seed=0, n_re=n_re)
    fn = estimator.build_ri(case.hop1, case.hop2, cfg, 2)
    out = fn(
        estimator.split_ri(case.received_rg),
        estimator.split_ri(case.pilots),
        case.beta,
        state.params,
    )
    ch = np.asarray(out.channel_est_rg)
    assert np.isfinite(ch).all()

    # with zero-init output conv, the residual net starts as identity ==
    # smoothing="none" output
    cfg_none = EstimatorConfig(
        scs_hz=case.config.scs_hz,
        cp_durations_ms=case.config.cp_durations_ms,
        smoothing="none",
        cfo_compensate=case.config.cfo_compensate,
    )
    out_none = estimator.build_ri(case.hop1, case.hop2, cfg_none, 2)(
        estimator.split_ri(case.received_rg), estimator.split_ri(case.pilots), case.beta
    )
    np.testing.assert_allclose(
        ch, np.asarray(out_none.channel_est_rg), atol=1e-6
    )


def test_trained_denoiser_beats_raw_ls_at_low_snr():
    state, _ = training.train(n_steps=120, batch=256, n_re=64, seed=7, log_every=0)
    rng = np.random.default_rng(11)
    noisy, truth = denoiser.make_training_batch(rng, 256, 64, snr_db_range=(5.0, 5.0))
    raw_nmse = float(np.sum((noisy - truth) ** 2) / np.sum(truth**2))
    den = np.asarray(denoiser.PilotDenoiser().apply(state.params, jnp.asarray(noisy)))
    den_nmse = float(np.sum((den - truth) ** 2) / np.sum(truth**2))
    assert den_nmse < 0.7 * raw_nmse, (raw_nmse, den_nmse)


def test_quality_sweep_learned_beats_filter_at_low_snr():
    """The trained denoiser must beat the reference's fixed RC-filter chain on
    channel NMSE vs ground truth at 0 dB SNR (validation/quality.py; deterministic
    seeds, CPU)."""
    from srsran_ce.models import training
    from srsran_ce.validation import quality

    state, _ = training.train(n_steps=250, batch=128, n_re=64, seed=0, lr=2e-3, log_every=10**9)
    kw = dict(n_cases=6, n_prbs=16, n_layers=1)
    f = quality.channel_nmse_vs_truth("filter", 0.0, **kw)
    l = quality.channel_nmse_vs_truth("learned", 0.0, params=state.params, **kw)
    n = quality.channel_nmse_vs_truth("none", 0.0, **kw)
    assert np.isfinite(f) and np.isfinite(l) and np.isfinite(n)
    assert f < n, "RC filter must beat no smoothing at 0 dB"
    assert l < f, f"learned ({l:.4f}) must beat filter ({f:.4f}) at 0 dB SNR"


def test_quality_wiener_beats_filter_at_low_snr():
    """The MMSE (wiener) smoother must beat the reference's fixed RC-filter chain
    on channel NMSE vs ground truth at low SNR (deterministic seeds, CPU)."""
    from srsran_ce.validation import quality

    kw = dict(n_cases=6, n_prbs=16, n_layers=1)
    f = quality.channel_nmse_vs_truth("filter", 0.0, **kw)
    w = quality.channel_nmse_vs_truth("wiener", 0.0, **kw)
    assert np.isfinite(w) and w < f, (w, f)
    kw2 = dict(n_cases=4, n_prbs=16, n_layers=2)
    f2 = quality.channel_nmse_vs_truth("filter", 5.0, **kw2)
    w2 = quality.channel_nmse_vs_truth("wiener", 5.0, **kw2)
    assert np.isfinite(w2) and w2 < f2, (w2, f2)


def test_shipped_checkpoint_wins_across_geometries():
    """One conv checkpoint must beat the reference RC-filter chain at 0 dB SNR
    on narrowband (24-RE), mid (312-RE) and wideband (1638-RE) pilot lattices
    (geometry generalization)."""
    from pathlib import Path

    from srsran_ce.models import training
    from srsran_ce.validation import quality

    ckpt = Path(__file__).resolve().parents[1] / "srsran_ce" / "artifacts" / "denoiser_ckpt.npz"
    if not ckpt.exists():
        pytest.skip("shipped checkpoint missing")
    state = training.load_checkpoint(str(ckpt))
    table = quality.geometry_sweep(state.params, snr_db=0.0, n_cases=3)
    assert set(table) == {4, 52, 273}
    for p, row in table.items():
        assert row["learned_wins"], (p, row)
        assert row["gain_db"] > 0.2, (p, row)  # comfortably ahead, not a tie


def test_multi_geometry_training_api():
    """train(n_re=(a, b)) cycles geometries (conv params are shared) and the
    resulting params apply at any length."""
    import jax.numpy as jnp

    from srsran_ce.models import denoiser, training

    state, loss = training.train(n_steps=4, batch=16, n_re=(24, 48), log_every=0)
    assert np.isfinite(loss)
    h = jnp.ones((2, 96), jnp.complex64)
    out = denoiser.apply_complex(state.params, h)
    assert out.shape == (2, 96) and bool(np.isfinite(np.asarray(out)).all())


def _np_conv_same(x, k, b):
    """numpy SAME cross-correlation: x (B, W, Ci), k (K, Ci, Co), b (Co,)."""
    K = k.shape[0]
    xp = np.pad(x, ((0, 0), (K // 2, K // 2), (0, 0)))
    out = np.zeros(x.shape[:2] + (k.shape[2],))
    for t in range(K):
        out += xp[:, t : t + x.shape[1], :] @ k[t]
    return out + b


def test_denoiser_matches_numpy_convolution():
    """The lax.conv stack == a numpy SAME convolution stack with ReLU between
    layers and the residual added (float64 end to end)."""
    params = denoiser.init_params(jax.random.PRNGKey(4), n_re=40)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * np.random.default_rng(1).standard_normal(np.shape(a)),
        params,
    )
    x = np.random.default_rng(2).standard_normal((3, 40, 2))
    got = np.asarray(denoiser.PilotDenoiser().apply(params, jnp.asarray(x)))
    h = x
    names = sorted(params["params"], key=lambda s: int(s.rsplit("_", 1)[1]))
    for i, name in enumerate(names):
        p = params["params"][name]
        h = _np_conv_same(h, np.asarray(p["kernel"]), np.asarray(p["bias"]))
        if i < len(names) - 1:
            h = np.maximum(h, 0.0)
    np.testing.assert_allclose(got, x + h, rtol=1e-10, atol=1e-10)


def test_init_is_identity_and_matches_the_tree_layout():
    """Zero-init output conv: an untrained network is the identity; the params
    tree is {"params": {"Conv_i": {"kernel", "bias"}}} with the (K, Ci, Co)
    kernel shapes the shipped checkpoints carry."""
    params = denoiser.init_params(jax.random.PRNGKey(0))
    shapes = {k: (v["kernel"].shape, v["bias"].shape) for k, v in params["params"].items()}
    assert shapes == {
        "Conv_0": ((13, 2, 48), (48,)),
        "Conv_1": ((13, 48, 48), (48,)),
        "Conv_2": ((13, 48, 2), (2,)),
    }
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 24, 2)), jnp.float32)
    np.testing.assert_array_equal(np.asarray(denoiser.PilotDenoiser().apply(params, x)), x)


def test_checkpoint_file_is_plain_npz(tmp_path):
    """A checkpoint is one numpy .npz: arrays keyed by tree path plus the step,
    readable without this package; a mismatched model is refused."""
    state, _ = training.init_state(seed=2, n_re=32)
    path = tmp_path / "ckpt.npz"
    training.save_checkpoint(path, state)
    with np.load(path) as f:
        keys = set(f.files)
        assert "step" in keys and "params/params/Conv_0/kernel" in keys
        assert int(f["step"]) == 0
    with pytest.raises(ValueError, match="does not match"):
        training.load_checkpoint_2d(path)
