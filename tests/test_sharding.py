"""Sharding correctness on the 8-virtual-device CPU mesh.

The DP path must be bit-identical to the unsharded batched path; the SP
(subcarrier + halo exchange) path must match the unsharded estimator at every
shard seam — the halo-exchange bound in SURVEY.md §7 "hard parts".
"""
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from srsran_ce.models import estimator
from srsran_ce.parallel import mesh as mesh_lib
from srsran_ce.parallel.data_parallel import build_dp_batched
from srsran_ce.parallel.subcarrier import (
    build_sp,
    build_sp_batched,
    build_sp_tracked,
    make_shard_plan,
)
from srsran_ce.models.plan import make_plan
from srsran_ce.utils import oracle, synthetic


def _ri(x):
    return estimator.split_ri(x)


def _stack_cases(cases):
    rg = np.stack([_ri(c.received_rg) for c in cases])
    pil = np.stack([_ri(c.pilots) for c in cases])
    beta = np.array([c.beta for c in cases])
    return rg, pil, beta


def test_dp_batched_matches_oracle():
    mesh = mesh_lib.make_mesh((8, 1), ("dp", "sp"))
    cases = [synthetic.make_case(seed=i, n_prbs=24, n_layers=2, snr_db=30.0) for i in range(8)]
    c0 = cases[0]
    fn = build_dp_batched(c0.hop1, c0.hop2, c0.config, 2, mesh)
    rg, pil, beta = _stack_cases(cases)
    out = fn(rg, pil, beta)
    assert len(out.channel_est_rg.sharding.device_set) == 8
    ch_all = np.asarray(out.channel_est_rg)
    noise_all = np.asarray(out.noise_est)
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        ch = estimator.merge_ri(ch_all[i])
        nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
        assert nmse < 1e-18, (i, nmse)
        np.testing.assert_allclose(noise_all[i], res_o.noise_est, rtol=1e-8)


SP_CASES = [
    ("1layer_filter", dict(n_prbs=32, n_layers=1, smoothing="filter")),
    ("2layer_filter", dict(n_prbs=32, n_layers=2, smoothing="filter")),
    ("4layer", dict(n_prbs=64, n_layers=4, smoothing="filter")),
    ("mean", dict(n_prbs=32, n_layers=1, smoothing="mean")),
    ("none", dict(n_prbs=32, n_layers=1, smoothing="none")),
    ("comb4", dict(n_prbs=32, n_layers=1, comb=4)),
    ("cfo_off", dict(n_prbs=32, n_layers=1, cfo_compensate=False)),
    ("wideband_272", dict(n_prbs=272, n_layers=1)),
    ("cnn_inpaint", dict(n_prbs=32, n_layers=1, interp="cnn")),
    ("cnn_inpaint_2layer_wide", dict(n_prbs=272, n_layers=2, interp="cnn")),
    ("filter_alpha_blend", dict(n_prbs=32, n_layers=2, cnn_alpha=0.4)),
    ("wiener", dict(n_prbs=32, n_layers=2, smoothing="wiener")),
    # time interpolation (config.time_interp="linear") under Doppler: the
    # per-symbol rows take the same halo-exchange smoothing + sharded fill
    ("time_interp", dict(n_prbs=32, n_layers=2, time_interp="linear", doppler_hz=300.0)),
    ("time_interp_cnn", dict(n_prbs=32, n_layers=1, interp="cnn", time_interp="linear", doppler_hz=300.0)),
    ("time_interp_wiener", dict(n_prbs=32, n_layers=2, smoothing="wiener", time_interp="linear", doppler_hz=300.0)),
    # WLS CFO estimator: per-pair inner products are global psums
    ("cfo_wls", dict(n_prbs=32, n_layers=2, cfo_estimator="wls")),
]


@pytest.mark.parametrize("name,kwargs", SP_CASES, ids=[c[0] for c in SP_CASES])
def test_sp_matches_unsharded(name, kwargs):
    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    case = synthetic.make_case(seed=zlib.crc32(name.encode()), snr_db=30.0, **kwargs)
    nL = case.pilots.shape[2]
    fn = build_sp(case.hop1, case.hop2, case.config, nL, mesh)
    out = fn(_ri(case.received_rg), _ri(case.pilots), case.beta)
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config)
    ch = estimator.merge_ri(np.asarray(out.channel_est_rg))
    err = np.abs(ch - res_o.channel_est_rg)
    nmse = np.sum(err**2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
    assert nmse < 1e-18, f"{name}: NMSE {nmse}, max err {err.max()}"
    np.testing.assert_allclose(float(out.noise_est), res_o.noise_est, rtol=1e-8)
    np.testing.assert_allclose(float(out.epre), res_o.epre, rtol=1e-9)
    np.testing.assert_allclose(float(out.rsrp), res_o.rsrp, rtol=1e-9)
    np.testing.assert_allclose(float(out.time_alignment), res_o.time_alignment, rtol=1e-9, atol=1e-15)
    if res_o.cfo_hz is not None:
        np.testing.assert_allclose(float(out.cfo_hz), res_o.cfo_hz, rtol=1e-8)


def test_sp_seams_bitwise_vs_unsharded():
    """Channel estimate at shard seams must equal the unsharded jitted path (same
    dtype), not just the oracle: checks the halo construction exactly."""
    n_sp = 8
    mesh = mesh_lib.make_mesh((1, n_sp), ("dp", "sp"))
    case = synthetic.make_case(seed=77, n_prbs=64, n_layers=2, snr_db=25.0)
    fn_sp = build_sp(case.hop1, case.hop2, case.config, 2, mesh)
    out_sp = fn_sp(_ri(case.received_rg), _ri(case.pilots), case.beta)
    fn_1 = estimator.build(case.hop1, case.hop2, case.config, 2)
    out_1 = fn_1(case.received_rg, case.pilots, case.beta)
    ch_sp = estimator.merge_ri(np.asarray(out_sp.channel_est_rg))
    ch_1 = out_1.channel_est_rg
    # seam columns: +-2 subcarriers around each shard boundary
    L = ch_1.shape[0] // n_sp
    seams = np.concatenate([[s * L - 2, s * L - 1, s * L, s * L + 1] for s in range(1, n_sp)])
    np.testing.assert_allclose(ch_sp[seams], ch_1[seams], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ch_sp, ch_1, rtol=1e-12, atol=1e-14)


def test_sp_batched_dp_combo():
    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    cases = [synthetic.make_case(seed=200 + i, n_prbs=32, n_layers=1, snr_db=30.0) for i in range(4)]
    c0 = cases[0]
    fn = build_sp_batched(c0.hop1, c0.hop2, c0.config, 1, mesh)
    rg, pil, beta = _stack_cases(cases)
    out = fn(rg, pil, beta)
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        ch = estimator.merge_ri(np.asarray(out.channel_est_rg)[i])
        nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
        assert nmse < 1e-18, (i, nmse)


def test_shard_plan_rejects_bad_geometry():
    case = synthetic.make_case(seed=1, n_prbs=24, n_layers=1, two_hops=True)
    plan = make_plan(case.hop1, case.hop2, case.config, 1)
    with pytest.raises(AssertionError):
        make_shard_plan(plan, 4)
    # non-divisible shard counts are PADDED (round-3 lift of the n_sp | n_prbs
    # restriction): 25 PRBs over 4 shards -> 2 padded pilot slots on the last
    case2 = synthetic.make_case(seed=2, n_prbs=25, n_layers=1)
    plan2 = make_plan(case2.hop1, case2.hop2, case2.config, 1)
    sp2 = make_shard_plan(plan2, 4)
    assert sp2.pad > 0 and sp2.n_rlast == sp2.R - sp2.pad
    assert 4 * sp2.R == sp2.pad + plan2.hop1.n_re


PADDED_SP_CASES = [
    # the north-star wideband geometry: 273 PRB = 3*7*13 is divisible by NO
    # power-of-two shard count — the whole reason the padding route exists
    ("wideband_273_filter", dict(n_prbs=273, n_layers=1, smoothing="filter")),
    ("pad_mean", dict(n_prbs=25, n_layers=1, smoothing="mean")),
    ("pad_none", dict(n_prbs=25, n_layers=1, smoothing="none")),
    ("pad_wiener", dict(n_prbs=25, n_layers=2, smoothing="wiener")),
    ("pad_cnn_interp", dict(n_prbs=27, n_layers=1, interp="cnn")),
    ("pad_2layer", dict(n_prbs=25, n_layers=2, smoothing="filter")),
    ("pad_alpha_blend", dict(n_prbs=25, n_layers=1, cnn_alpha=0.4)),
    ("pad_comb4", dict(n_prbs=27, n_layers=1, comb=4)),
    ("pad_time_interp", dict(n_prbs=25, n_layers=1, time_interp="linear", doppler_hz=300.0)),
]


@pytest.mark.parametrize("name,kwargs", PADDED_SP_CASES, ids=[c[0] for c in PADDED_SP_CASES])
def test_sp_padded_matches_unsharded(name, kwargs):
    """Non-divisible shard counts (pad + mask) must still match the oracle."""
    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    case = synthetic.make_case(seed=zlib.crc32(name.encode()), snr_db=30.0, **kwargs)
    nL = case.pilots.shape[2]
    sp = make_shard_plan(make_plan(case.hop1, case.hop2, case.config, nL), n_sp)
    assert sp.pad > 0, "case must actually exercise the padded route"
    fn = build_sp(case.hop1, case.hop2, case.config, nL, mesh)
    out = fn(_ri(case.received_rg), _ri(case.pilots), case.beta)
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config)
    ch = estimator.merge_ri(np.asarray(out.channel_est_rg))
    assert ch.shape == res_o.channel_est_rg.shape
    nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(
        np.abs(res_o.channel_est_rg) ** 2
    )
    assert nmse < 1e-18, f"{name}: NMSE {nmse}"
    np.testing.assert_allclose(float(out.noise_est), res_o.noise_est, rtol=1e-8)
    np.testing.assert_allclose(float(out.epre), res_o.epre, rtol=1e-9)
    np.testing.assert_allclose(float(out.rsrp), res_o.rsrp, rtol=1e-9)
    np.testing.assert_allclose(
        float(out.time_alignment), res_o.time_alignment, rtol=1e-9, atol=1e-15
    )


def test_sp_padded_batched_and_factored():
    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    cases = [synthetic.make_case(seed=300 + i, n_prbs=25, n_layers=1, snr_db=30.0) for i in range(4)]
    c0 = cases[0]
    fn = build_sp_batched(c0.hop1, c0.hop2, c0.config, 1, mesh)
    rg, pil, beta = _stack_cases(cases)
    out = fn(rg, pil, beta)
    assert np.asarray(out.channel_est_rg).shape[2] == 25 * 12
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        ch = estimator.merge_ri(np.asarray(out.channel_est_rg)[i])
        nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(
            np.abs(res_o.channel_est_rg) ** 2
        )
        assert nmse < 1e-18, (i, nmse)
    # factored output through the padded wrapper
    fn_f = build_sp_batched(c0.hop1, c0.hop2, c0.config, 1, mesh, out_layout="factored")
    out_f = fn_f(rg, pil, beta)
    prof = np.asarray(out_f.profiles)
    assert prof.shape[-1] == 25 * 12
    ch0 = estimator.reconstruct_factored(
        estimator.merge_ri(np.moveaxis(prof, 1, 0))[0],
        estimator.merge_ri(np.moveaxis(np.asarray(out_f.sym_rot), 1, 0))[0],
        c0.hop1, c0.hop2,
    )
    res_o0 = oracle.estimate(
        cases[0].received_rg, cases[0].pilots, cases[0].beta, c0.hop1, c0.hop2, c0.config
    )
    nmse0 = np.sum(np.abs(ch0 - res_o0.channel_est_rg) ** 2) / np.sum(
        np.abs(res_o0.channel_est_rg) ** 2
    )
    assert nmse0 < 1e-14, nmse0


def test_sp_padded_hopped():
    """Frequency-hopped problems over a shard count not dividing the grid."""
    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    case = synthetic.make_case(seed=91, n_prbs=25, n_layers=1, snr_db=30.0, two_hops=True)
    fn = build_sp(case.hop1, case.hop2, case.config, 1, mesh)
    out = fn(_ri(case.received_rg), _ri(case.pilots), case.beta)
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config)
    ch = estimator.merge_ri(np.asarray(out.channel_est_rg))
    assert ch.shape == res_o.channel_est_rg.shape
    nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(
        np.abs(res_o.channel_est_rg) ** 2
    )
    assert nmse < 1e-18, nmse


def test_sp_learned_smoothing_matches_unsharded():
    """Sharded learned smoothing (layer-wise conv halo exchange) must reproduce the
    unsharded denoiser path exactly — including at band edges, where each conv
    layer's SAME zero padding must not be contaminated by halo activations."""
    from srsran_ce.models import denoiser

    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    case = synthetic.make_case(seed=5, n_prbs=32, n_layers=2, smoothing="learned", snr_db=25.0)
    params = denoiser.init_params(jax.random.PRNGKey(0), n_re=case.pilots.shape[0])
    # perturb: a zero-init output conv would make the denoiser the identity and
    # mask edge bugs
    params = jax.tree.map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(1), x.shape, x.dtype),
        params,
    )
    fn_sp = build_sp(case.hop1, case.hop2, case.config, 2, mesh)
    out_sp = fn_sp(_ri(case.received_rg), _ri(case.pilots), case.beta, params)
    fn_1 = estimator.build_ri(case.hop1, case.hop2, case.config, 2)
    out_1 = fn_1(_ri(case.received_rg), _ri(case.pilots), jnp.asarray(case.beta), params)
    ch_sp = estimator.merge_ri(np.asarray(out_sp.channel_est_rg))
    ch_1 = estimator.merge_ri(np.asarray(out_1.channel_est_rg))
    # the denoiser computes in float32 (apply_complex casts); the sharded VALID
    # conv vs the SAME-padded conv reassociate differently -> ~1e-7 relative
    np.testing.assert_allclose(ch_sp, ch_1, rtol=3e-6, atol=1e-8)
    np.testing.assert_allclose(float(out_sp.noise_est), float(out_1.noise_est), rtol=1e-6)


def test_apply_sharded_single_shard_equals_apply():
    """apply_sharded with zero halos (n_sp=1) == the plain apply, bitwise-ish."""
    from srsran_ce.models import denoiser

    params = denoiser.init_params(jax.random.PRNGKey(2), n_re=48)
    params = jax.tree.map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(3), x.shape, x.dtype),
        params,
    )
    rng = np.random.default_rng(9)
    h = (rng.standard_normal((3, 48)) + 1j * rng.standard_normal((3, 48))).astype(np.complex64)

    def zero_exchange(x, hw):
        z = jnp.zeros(x.shape[:-1] + (hw,), x.dtype)
        return z, z

    a = np.asarray(denoiser.apply_sharded(params, jnp.asarray(h), zero_exchange))
    b = np.asarray(denoiser.apply_complex(params, jnp.asarray(h)))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "interp,time_interp",
    [("linear", "none"), ("cnn", "none"), ("linear", "linear"), ("cnn", "linear")],
)
def test_sp_hopped_matches_unsharded(interp, time_interp):
    """Frequency-hopped SP path (BASELINE.json config[4]): replicated tiny front +
    sharded fill must match the float64 oracle and the unsharded jitted path."""
    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    case = synthetic.make_case(
        seed=61, n_prbs=12, n_layers=2, snr_db=30.0, two_hops=True, interp=interp,
        time_interp=time_interp, doppler_hz=200.0 if time_interp == "linear" else 0.0,
    )
    fn_sp = build_sp(case.hop1, case.hop2, case.config, 2, mesh)
    out = fn_sp(_ri(case.received_rg), _ri(case.pilots), case.beta)
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config)
    ch = estimator.merge_ri(np.asarray(out.channel_est_rg))
    nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
    assert nmse < 1e-18, nmse
    np.testing.assert_allclose(float(out.noise_est), res_o.noise_est, rtol=1e-8)
    np.testing.assert_allclose(float(out.epre), res_o.epre, rtol=1e-9)
    np.testing.assert_allclose(float(out.time_alignment), res_o.time_alignment, rtol=1e-9, atol=1e-15)
    if res_o.cfo_hz is not None:
        np.testing.assert_allclose(float(out.cfo_hz), res_o.cfo_hz, rtol=1e-8)
    # also exact vs the unsharded jitted path (same dtype, same fused front)
    fn_1 = estimator.build(case.hop1, case.hop2, case.config, 2)
    out_1 = fn_1(case.received_rg, case.pilots, case.beta)
    np.testing.assert_allclose(ch, out_1.channel_est_rg, rtol=1e-12, atol=1e-14)


def test_sp_hopped_batched():
    n_sp = 2
    mesh = mesh_lib.make_mesh((4, n_sp), ("dp", "sp"))
    cases = [
        synthetic.make_case(seed=70 + i, n_prbs=12, n_layers=1, snr_db=30.0, two_hops=True)
        for i in range(4)
    ]
    c0 = cases[0]
    fn = build_sp_batched(c0.hop1, c0.hop2, c0.config, 1, mesh)
    rg, pil, beta = _stack_cases(cases)
    out = fn(rg, pil, beta)
    ch_all = np.asarray(out.channel_est_rg)
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        ch = estimator.merge_ri(ch_all[i])
        nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
        assert nmse < 1e-18, (i, nmse)


def test_all_device_barrier_and_heartbeat():
    """Failure-detection subsystem: the barrier touches all 8 virtual devices and
    verifies participation; the heartbeat reports healthy and can be stopped."""
    dt = mesh_lib.all_device_barrier()
    assert dt >= 0.0
    hb = mesh_lib.Heartbeat(interval_s=0.1, timeout_s=60.0).start()
    import time

    time.sleep(0.5)
    hb.stop()
    assert hb.healthy and hb.error is None
    assert hb.last_latency_s is not None

    # failure path: an on_failure callback fires and healthy flips
    seen = []
    hb2 = mesh_lib.Heartbeat(interval_s=0.05, on_failure=seen.append)
    hb2._fail("injected")
    assert not hb2.healthy and seen == ["injected"]


def test_dp_batched_factored():
    """DP sharding with out_layout='factored': per-problem factors reconstruct the
    oracle-quality grid; outputs stay batch-sharded."""
    mesh = mesh_lib.make_mesh((8, 1), ("dp", "sp"))
    cases = [
        synthetic.make_case(seed=50 + i, n_prbs=24, n_layers=2, snr_db=30.0, cfo_hz=200.0)
        for i in range(8)
    ]
    c0 = cases[0]
    fn = build_dp_batched(c0.hop1, c0.hop2, c0.config, 2, mesh, out_layout="factored")
    rg, pil, beta = _stack_cases(cases)
    out = fn(rg, pil, beta)
    assert len(out.profiles.sharding.device_set) == 8
    prof_all = np.asarray(out.profiles)  # (B, 2, n_hops, nL, n_sc)
    rot_all = np.asarray(out.sym_rot)  # (B, 2, 14)
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        grid = estimator.reconstruct_factored(
            estimator.merge_ri(prof_all[i]), estimator.merge_ri(rot_all[i]),
            c.hop1, c.hop2,
        )
        nmse = np.sum(np.abs(grid - res_o.channel_est_rg) ** 2) / np.sum(
            np.abs(res_o.channel_est_rg) ** 2
        )
        assert nmse < 1e-18, (i, nmse)


@pytest.mark.parametrize("kwargs", [
    dict(n_prbs=32, n_layers=2, cfo_hz=250.0),
    dict(n_prbs=32, n_layers=2, smoothing="wiener"),
    dict(n_prbs=16, n_layers=1, two_hops=True, cfo_hz=150.0),
])
def test_sp_factored_matches_unsharded_factored(kwargs):
    """SP out_layout='factored': sharded profiles/rotation equal the unsharded
    factored output, and the reconstruction matches the SP grid path."""
    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    case = synthetic.make_case(seed=71, snr_db=30.0, **kwargs)
    nL = case.pilots.shape[2]
    f_fac = build_sp(case.hop1, case.hop2, case.config, nL, mesh, out_layout="factored")
    out = f_fac(_ri(case.received_rg), _ri(case.pilots), case.beta)
    prof = estimator.merge_ri(np.asarray(out.profiles))
    rot = estimator.merge_ri(np.asarray(out.sym_rot))

    r_un = estimator.build_ri(case.hop1, case.hop2, case.config, nL, out_layout="factored")(
        _ri(case.received_rg), _ri(case.pilots), np.asarray(case.beta)
    )
    prof_un = estimator.merge_ri(np.asarray(r_un.profiles))
    rot_un = estimator.merge_ri(np.asarray(r_un.sym_rot))
    np.testing.assert_allclose(rot, rot_un, rtol=1e-12, atol=0)
    # single-hop overlap-save profiles are bitwise vs unsharded; the hopped path
    # fills via the embedded operator matmul (reassociated sums) — allow ulps
    tol = 0 if case.hop2 is None else 1e-12
    np.testing.assert_allclose(prof, prof_un, rtol=tol, atol=1e-13)

    f_grid = build_sp(case.hop1, case.hop2, case.config, nL, mesh)
    grid = estimator.merge_ri(np.asarray(
        f_grid(_ri(case.received_rg), _ri(case.pilots), case.beta).channel_est_rg
    ))
    recon = estimator.reconstruct_factored(prof, rot, case.hop1, case.hop2)
    np.testing.assert_allclose(recon, grid, rtol=1e-12, atol=1e-13)
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        # psum vs serial-sum reassociation: ulp-level
        np.testing.assert_allclose(
            np.asarray(getattr(out, f)), np.asarray(getattr(r_un, f)), rtol=1e-12
        )


def test_sp_factored_batched():
    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    cases = [synthetic.make_case(seed=72 + i, snr_db=30.0, n_prbs=32, n_layers=2,
                                 cfo_hz=200.0) for i in range(4)]
    c0 = cases[0]
    fn = build_sp_batched(c0.hop1, c0.hop2, c0.config, 2, mesh, out_layout="factored")
    rg, pil, beta = _stack_cases(cases)
    out = fn(rg, pil, beta)
    prof = np.asarray(out.profiles)  # (B, 2, 1, nL, n_sc)
    rot = np.asarray(out.sym_rot)
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        grid = estimator.reconstruct_factored(
            estimator.merge_ri(prof[i]), estimator.merge_ri(rot[i]), c.hop1, c.hop2
        )
        nmse = np.sum(np.abs(grid - res_o.channel_est_rg) ** 2) / np.sum(
            np.abs(res_o.channel_est_rg) ** 2
        )
        assert nmse < 1e-18, (i, nmse)


def test_sp_factored_rejects_time_interp():
    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    case = synthetic.make_case(seed=3, n_prbs=32, n_layers=1, time_interp="linear",
                               doppler_hz=200.0)
    with pytest.raises(ValueError):
        build_sp(case.hop1, case.hop2, case.config, 1, mesh, out_layout="factored")
    with pytest.raises(ValueError):
        build_sp_batched(case.hop1, case.hop2, case.config, 1, mesh, out_layout="factored")


def test_sp_tracked_matches_unsharded_tracker():
    """Multi-slot tracking on the SP path: gains, state, and tracked grids equal
    the unsharded tracker's across a 3-sounding sequence (fresh noise each slot)."""
    from srsran_ce.models import tracking

    n_sp = 4
    mesh = mesh_lib.make_mesh((2, n_sp), ("dp", "sp"))
    kw = dict(n_prbs=32, n_layers=2, cfo_hz=0.0, cfo_compensate=False)
    cases = [synthetic.make_case(seed=55, snr_db=0.0, noise_seed=700 + s, **kw)
             for s in range(3)]
    c0 = cases[0]

    f_sp = build_sp_tracked(c0.hop1, c0.hop2, c0.config, 2, mesh)
    f_un = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 2)
    st_sp = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2)
    st_un = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2)

    for s, c in enumerate(cases):
        args = (_ri(c.received_rg), _ri(c.pilots), np.asarray(c.beta))
        r_sp, h_sp, w_sp = f_sp(*args, st_sp[0], st_sp[1])
        r_un, h_un, w_un = f_un(*args, st_un[0], st_un[1])
        st_sp = (tuple(np.asarray(h) for h in h_sp), np.asarray(w_sp))
        st_un = (tuple(np.asarray(h) for h in h_un), np.asarray(w_un))
        np.testing.assert_allclose(float(w_sp), float(w_un), rtol=1e-10)
        for a, b in zip(st_sp[0], st_un[0]):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            np.asarray(r_sp.channel_est_rg), np.asarray(r_un.channel_est_rg),
            rtol=1e-10, atol=1e-14,
        )
    assert float(st_sp[1]) > 2.0  # static channel: weight accumulates


def test_sp_tracked_factored():
    """SP tracking + factored output: reconstruction matches the SP tracked grid."""
    from srsran_ce.models import tracking

    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    kw = dict(n_prbs=32, n_layers=2, cfo_hz=200.0)
    c = synthetic.make_case(seed=56, snr_db=10.0, **kw)
    f_grid = build_sp_tracked(c.hop1, c.hop2, c.config, 2, mesh)
    f_fac = build_sp_tracked(c.hop1, c.hop2, c.config, 2, mesh, out_layout="factored")
    st = tracking.init_state(c.hop1, c.hop2, c.config, 2)
    args = (_ri(c.received_rg), _ri(c.pilots), np.asarray(c.beta))
    r_g, h_g, w_g = f_grid(*args, st[0], st[1])
    r_f, h_f, w_f = f_fac(*args, st[0], st[1])
    grid = estimator.reconstruct_factored(
        estimator.merge_ri(np.asarray(r_f.profiles)),
        estimator.merge_ri(np.asarray(r_f.sym_rot)),
        c.hop1, c.hop2,
    )
    np.testing.assert_allclose(
        grid, estimator.merge_ri(np.asarray(r_g.channel_est_rg)), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_array_equal(np.asarray(h_f[0]), np.asarray(h_g[0]))


def test_sp_tracked_hopped_matches_unsharded():
    """Hopped SP tracking (replicated front): equals the unsharded tracker across
    soundings; factored variant reconstructs the tracked grid."""
    from srsran_ce.models import tracking

    mesh = mesh_lib.make_mesh((2, 4), ("dp", "sp"))
    kw = dict(n_prbs=8, n_layers=2, two_hops=True, cfo_hz=0.0, cfo_compensate=False)
    cases = [synthetic.make_case(seed=57, snr_db=0.0, noise_seed=800 + s, **kw)
             for s in range(3)]
    c0 = cases[0]
    f_sp = build_sp_tracked(c0.hop1, c0.hop2, c0.config, 2, mesh)
    f_un = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 2)
    st_sp = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2)
    st_un = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2)
    for c in cases:
        args = (_ri(c.received_rg), _ri(c.pilots), np.asarray(c.beta))
        r_sp, h_sp, w_sp = f_sp(*args, st_sp[0], st_sp[1])
        r_un, h_un, w_un = f_un(*args, st_un[0], st_un[1])
        st_sp = (tuple(np.asarray(h) for h in h_sp), np.asarray(w_sp))
        st_un = (tuple(np.asarray(h) for h in h_un), np.asarray(w_un))
        np.testing.assert_allclose(float(w_sp), float(w_un), rtol=1e-10)
        for a, b in zip(st_sp[0], st_un[0]):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            np.asarray(r_sp.channel_est_rg), np.asarray(r_un.channel_est_rg),
            rtol=1e-10, atol=1e-14,
        )
    # factored variant agrees with the tracked grid
    f_fac = build_sp_tracked(c0.hop1, c0.hop2, c0.config, 2, mesh, out_layout="factored")
    st = tracking.init_state(c0.hop1, c0.hop2, c0.config, 2)
    c = cases[0]
    args = (_ri(c.received_rg), _ri(c.pilots), np.asarray(c.beta))
    r_g, _, _ = f_sp(*args, st[0], st[1])
    r_f, _, _ = f_fac(*args, st[0], st[1])
    grid = estimator.reconstruct_factored(
        estimator.merge_ri(np.asarray(r_f.profiles)),
        estimator.merge_ri(np.asarray(r_f.sym_rot)),
        c.hop1, c.hop2,
    )
    np.testing.assert_allclose(
        grid, estimator.merge_ri(np.asarray(r_g.channel_est_rg)), rtol=1e-12, atol=1e-14
    )
