"""2-D (time x frequency) trainable denoiser — smoothing="learned2d".

DL-based time-frequency channel estimation (PAPERS.md: arXiv:2109.10667,
arXiv:1810.05893 treat the pilot grid as a 2-channel image). Operates on the
per-DM-RS-symbol estimate grid of the time-interp path, learning both frequency
smoothing and Doppler tracking; no reference counterpart.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from srsran_ce.config import EstimatorConfig
from srsran_ce.models import denoiser, estimator, training
from srsran_ce.utils import synthetic


def _cfg(base, **over):
    fields = dict(
        scs_hz=base.scs_hz,
        cp_durations_ms=base.cp_durations_ms,
        cfo_compensate=base.cfo_compensate,
    )
    fields.update(over)
    return EstimatorConfig(**fields)


def test_learned2d_requires_time_interp():
    case = synthetic.make_case(seed=1, n_prbs=8, n_layers=1)
    with pytest.raises(ValueError):
        _cfg(case.config, smoothing="learned2d")  # time_interp defaults to "none"


def test_untrained_2d_is_identity():
    """Zero-init residual: untrained learned2d == time_interp + smoothing 'none'."""
    case = synthetic.make_case(
        seed=9, n_prbs=24, n_layers=2, snr_db=10.0, doppler_hz=200.0
    )
    n_re = case.pilots.shape[0]
    state, _ = training.init_state_2d(seed=0, n_re=n_re, n_dsym=4)
    cfg_2d = _cfg(case.config, smoothing="learned2d", time_interp="linear")
    out = estimator.build_ri(case.hop1, case.hop2, cfg_2d, 2)(
        estimator.split_ri(case.received_rg),
        estimator.split_ri(case.pilots),
        case.beta,
        state.params,
    )
    cfg_none = _cfg(case.config, smoothing="none", time_interp="linear")
    out_none = estimator.build_ri(case.hop1, case.hop2, cfg_none, 2)(
        estimator.split_ri(case.received_rg), estimator.split_ri(case.pilots), case.beta
    )
    np.testing.assert_allclose(
        np.asarray(out.channel_est_rg), np.asarray(out_none.channel_est_rg), atol=1e-6
    )


def test_train2d_beats_raw_ls_under_doppler():
    state, _ = training.train2d(n_steps=120, batch=128, n_re=64, n_dsym=4, seed=7, log_every=0)
    rng = np.random.default_rng(11)
    noisy, truth = denoiser.make_training_batch_2d(
        rng, 128, 64, n_dsym=4, snr_db_range=(5.0, 5.0), doppler_hz_max=500.0
    )
    raw_nmse = float(np.sum((noisy - truth) ** 2) / np.sum(truth**2))
    den = np.asarray(denoiser.PilotDenoiser2D().apply(state.params, jnp.asarray(noisy)))
    den_nmse = float(np.sum((den - truth) ** 2) / np.sum(truth**2))
    assert den_nmse < 0.7 * raw_nmse, (raw_nmse, den_nmse)


def test_learned2d_beats_filter_under_doppler():
    """End-to-end: a briefly-trained 2-D denoiser must beat the reference RC-filter
    chain (both with time interpolation) on channel NMSE at low SNR with Doppler."""
    from srsran_ce.validation import quality

    state, _ = training.train2d(
        n_steps=250, batch=128, n_re=32, n_dsym=4, seed=0, lr=2e-3, log_every=10**9
    )
    kw = dict(n_cases=6, n_prbs=16, n_layers=1, time_interp="linear",
              doppler_hz=400.0, cfo_hz=0.0)
    f = quality.channel_nmse_vs_truth("filter", 5.0, **kw)
    l2 = quality.channel_nmse_vs_truth("learned2d", 5.0, params=state.params, **kw)
    assert np.isfinite(f) and np.isfinite(l2)
    assert l2 < f, f"learned2d ({l2:.4f}) must beat filter ({f:.4f}) at 5 dB SNR + Doppler"


def test_learned2d_dp_sharded():
    """The SP assertion points learned2d problems at the DP path — prove it works:
    build_dp_batched passes the params pytree as a trailing replicated argument."""
    import jax
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.data_parallel import build_dp_batched

    case = synthetic.make_case(seed=13, n_prbs=16, n_layers=1, snr_db=15.0, doppler_hz=200.0)
    cfg = _cfg(case.config, smoothing="learned2d", time_interp="linear")
    n_re = case.pilots.shape[0]
    state, _ = training.init_state_2d(seed=0, n_re=n_re, n_dsym=4)
    mesh = mesh_lib.make_mesh((8,), ("dp",))
    fn = build_dp_batched(case.hop1, case.hop2, cfg, 1, mesh)
    B = 8
    rg = np.stack([estimator.split_ri(case.received_rg)] * B)
    pil = np.stack([estimator.split_ri(case.pilots)] * B)
    beta = np.full(B, case.beta)
    out = fn(rg, pil, beta, state.params)
    ch = np.asarray(out.channel_est_rg)
    assert np.isfinite(ch).all()
    # untrained == identity == smoothing 'none' on the same (unsharded) path
    ref = estimator.build_ri(case.hop1, case.hop2, _cfg(case.config, smoothing="none",
                                                        time_interp="linear"), 1)(
        estimator.split_ri(case.received_rg), estimator.split_ri(case.pilots), case.beta
    )
    np.testing.assert_allclose(ch[0], np.asarray(ref.channel_est_rg), atol=1e-6)


def test_learned2d_sp_matches_unsharded():
    """Subcarrier-sharded learned2d (frequency-halo layer-wise conv) must equal the
    unsharded path bit-tight, with non-trivial (briefly trained) weights."""
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.subcarrier import build_sp

    state, _ = training.train2d(n_steps=25, batch=64, n_re=32, n_dsym=4, seed=2, log_every=0)
    case = synthetic.make_case(
        seed=17, n_prbs=32, n_layers=2, snr_db=15.0, doppler_hz=250.0
    )
    cfg = _cfg(case.config, smoothing="learned2d", time_interp="linear")
    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    fn_sp = build_sp(case.hop1, case.hop2, cfg, 2, mesh)
    out_sp = fn_sp(
        estimator.split_ri(case.received_rg),
        estimator.split_ri(case.pilots),
        case.beta,
        state.params,
    )
    fn_1 = estimator.build_ri(case.hop1, case.hop2, cfg, 2)
    out_1 = fn_1(
        estimator.split_ri(case.received_rg),
        estimator.split_ri(case.pilots),
        case.beta,
        state.params,
    )
    np.testing.assert_allclose(
        np.asarray(out_sp.channel_est_rg),
        np.asarray(out_1.channel_est_rg),
        rtol=1e-10,
        atol=1e-12,
    )
    np.testing.assert_allclose(float(out_sp.noise_est), float(out_1.noise_est), rtol=1e-8)


def test_shipped_2d_checkpoint_loads_and_round_trips(tmp_path):
    """The shipped learned2d checkpoint (.npz) loads into the 2-D model and
    survives a save/load round trip bit for bit."""
    from pathlib import Path

    ckpt = Path(__file__).resolve().parents[1] / "srsran_ce" / "artifacts" / "denoiser2d_ckpt.npz"
    state = training.load_checkpoint_2d(str(ckpt))
    assert state.step > 0
    path = tmp_path / "again.npz"
    training.save_checkpoint(path, state)
    back = training.load_checkpoint_2d(path)
    assert back.step == state.step
    tree = lambda s: (s.params, s.opt_state)
    for a, b in zip(jax.tree_util.tree_leaves(tree(state)), jax.tree_util.tree_leaves(tree(back))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
