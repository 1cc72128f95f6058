"""End-to-end conformance: jitted JAX estimator vs float64 numpy oracle.

Every case runs the full chain (gather -> LS -> CFO -> CDM average -> smoothing ->
time alignment -> reconstruction -> grid fill -> normalization) on a synthetic golden
problem and checks all six outputs. With x64 enabled both paths are complex128, so
tolerances are tight (the only differences are summation order and FFT backend).
"""
import zlib

import numpy as np
import jax.numpy as jnp
import pytest

from srsran_ce.models import estimator
from srsran_ce.utils import oracle, synthetic


def run_both(case):
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    return res_j, res_o


def assert_match(res_j, res_o, tol=1e-9):
    ch_j = np.asarray(res_j.channel_est_rg)
    ch_o = res_o.channel_est_rg
    scale = np.sqrt(np.mean(np.abs(ch_o) ** 2)) + 1e-30
    nmse = np.sum(np.abs(ch_j - ch_o) ** 2) / (np.sum(np.abs(ch_o) ** 2) + 1e-30)
    assert nmse < tol**2, f"channel NMSE {nmse}"
    np.testing.assert_allclose(float(res_j.noise_est), res_o.noise_est, rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(float(res_j.rsrp), res_o.rsrp, rtol=1e-9)
    np.testing.assert_allclose(float(res_j.epre), res_o.epre, rtol=1e-9)
    np.testing.assert_allclose(float(res_j.time_alignment), res_o.time_alignment, rtol=1e-9, atol=1e-15)
    if res_o.cfo_hz is None:
        assert np.isnan(float(res_j.cfo_hz))
    else:
        np.testing.assert_allclose(float(res_j.cfo_hz), res_o.cfo_hz, rtol=1e-8, atol=1e-10)


CASES = [
    # (name, kwargs)
    ("c0_52prb_filter", dict(n_prbs=52, n_layers=1, scs_hz=15e3)),
    ("c0_cfo_off", dict(n_prbs=52, n_layers=1, scs_hz=15e3, cfo_compensate=False)),
    ("smoothing_mean", dict(n_prbs=24, n_layers=1, smoothing="mean")),
    ("smoothing_none", dict(n_prbs=24, n_layers=1, smoothing="none")),
    ("two_layers", dict(n_prbs=24, n_layers=2)),
    ("four_layers_106prb", dict(n_prbs=106, n_layers=4, scs_hz=30e3)),
    ("three_layers_odd", dict(n_prbs=16, n_layers=3)),
    ("comb4", dict(n_prbs=24, n_layers=1, comb=4)),
    ("two_hops", dict(n_prbs=24, n_layers=1, two_hops=True)),
    ("two_hops_2layer", dict(n_prbs=12, n_layers=2, two_hops=True)),
    ("single_prb", dict(n_prbs=1, n_layers=1)),
    ("two_prbs", dict(n_prbs=2, n_layers=1)),
    ("cnn_interp", dict(n_prbs=24, n_layers=1, interp="cnn")),
    ("cnn_interp_alpha", dict(n_prbs=52, n_layers=2, interp="cnn", cnn_alpha=0.4)),
    ("wideband_273", dict(n_prbs=273, n_layers=1, scs_hz=30e3)),
    ("one_dmrs_sym", dict(n_prbs=24, n_layers=1, n_dmrs_syms=1, cfo_compensate=True)),
    ("offset_band", dict(n_prbs=20, n_layers=1, prb_start=30, n_prb_total=106)),
    ("filter_alpha_linear", dict(n_prbs=24, n_layers=2, cnn_alpha=0.3)),
    ("wideband_273_4layer", dict(n_prbs=273, n_layers=4, scs_hz=30e3)),
    ("comb6", dict(n_prbs=24, n_layers=1, comb=6)),
    ("two_hops_4layer", dict(n_prbs=12, n_layers=4, two_hops=True)),
    ("prb_mask_hole", dict(n_prbs=24, n_layers=2, prb_hole=(10, 14))),
    ("prb_mask_hole_cnn", dict(n_prbs=24, n_layers=1, interp="cnn", prb_hole=(6, 8))),
    ("wiener", dict(n_prbs=24, n_layers=1, smoothing="wiener")),
    ("wiener_2layer", dict(n_prbs=24, n_layers=2, smoothing="wiener")),
    ("wiener_hopped", dict(n_prbs=12, n_layers=1, smoothing="wiener", two_hops=True)),
    # degenerate / odd wiener lattices (fuzz-found): 1-point paired lattice is a
    # pass-through; odd n_re with >=2 layers runs on the full duplicated lattice
    ("wiener_degenerate_1prb_comb6", dict(n_prbs=1, n_layers=2, comb=6, smoothing="wiener")),
    ("wiener_odd_re_comb4", dict(n_prbs=5, n_layers=2, comb=4, smoothing="wiener")),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[c[0] for c in CASES])
def test_estimator_matches_oracle(name, kwargs):
    case = synthetic.make_case(seed=zlib.crc32(name.encode()), snr_db=30.0, **kwargs)
    res_j, res_o = run_both(case)
    assert_match(res_j, res_o)


def test_estimates_track_ground_truth():
    """Physical sanity: high-SNR estimate approaches the true channel."""
    case = synthetic.make_case(seed=11, n_prbs=52, n_layers=1, snr_db=45.0, cfo_hz=150.0)
    res = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    cpds = case.config.cp_durations_np * case.config.scs_hz / 1000.0
    sst = oracle.symbol_start_times(cpds)
    truth = case.true_channel[:, :, 0] * np.exp(1j * 2 * np.pi * sst * (150.0 / case.config.scs_hz))
    ch = np.asarray(res.channel_est_rg)[:, :, 0]
    nmse = np.sum(np.abs(ch - truth) ** 2) / np.sum(np.abs(truth) ** 2)
    assert nmse < 1e-3, nmse
    assert abs(float(res.cfo_hz) - 150.0) < 5.0
    # noise estimate should be near the injected noise power
    noise_power = 10 ** (-case.snr_db / 10)
    assert 0.2 * noise_power < float(res.noise_est) < 5 * noise_power


def test_float32_accuracy_bound():
    """complex64 path (the serving default) stays within a realistic NMSE bound of the
    float64 oracle."""
    case = synthetic.make_case(seed=21, n_prbs=106, n_layers=2, snr_db=30.0)
    res32 = estimator.estimate(
        case.received_rg.astype(np.complex64),
        case.pilots.astype(np.complex64),
        np.float32(case.beta),
        case.hop1,
        case.hop2,
        case.config,
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch = np.asarray(res32.channel_est_rg).astype(np.complex128)
    nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
    assert nmse < 1e-9, nmse  # ~ -90 dB: f32 rounding only
    np.testing.assert_allclose(float(res32.noise_est), res_o.noise_est, rtol=1e-3)
    np.testing.assert_allclose(float(res32.cfo_hz), res_o.cfo_hz, rtol=1e-3, atol=1e-3)


def test_batched_matches_single():
    case_kwargs = dict(n_prbs=24, n_layers=2, snr_db=30.0)
    cases = [synthetic.make_case(seed=100 + i, **case_kwargs) for i in range(4)]
    c0 = cases[0]
    fn = estimator.build_batched(c0.hop1, c0.hop2, c0.config, n_layers=2)
    rg = jnp.stack([jnp.asarray(c.received_rg) for c in cases])
    pil = jnp.stack([jnp.asarray(c.pilots) for c in cases])
    beta = jnp.asarray([c.beta for c in cases])
    out = fn(rg, pil, beta)
    for i, c in enumerate(cases):
        res_o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        ch = np.asarray(out.channel_est_rg[i])
        nmse = np.sum(np.abs(ch - res_o.channel_est_rg) ** 2) / np.sum(np.abs(res_o.channel_est_rg) ** 2)
        assert nmse < 1e-18, (i, nmse)
        np.testing.assert_allclose(float(out.noise_est[i]), res_o.noise_est, rtol=1e-8)


def test_beta_dmrs_scaling():
    """Non-unit DMRS amplitude (the srsRAN vectors use beta=1.4125) matches oracle."""
    case = synthetic.make_case(seed=31, n_prbs=24, n_layers=2, beta=1.4125, snr_db=30.0)
    res_j, res_o = run_both(case)
    assert_match(res_j, res_o)


def test_plan_bucketing_shares_executable():
    """Identical configurations must return the identical compiled callable."""
    c1 = synthetic.make_case(seed=1, n_prbs=24, n_layers=1)
    c2 = synthetic.make_case(seed=2, n_prbs=24, n_layers=1)
    f1 = estimator.build_ri(c1.hop1, c1.hop2, c1.config, 1)
    f2 = estimator.build_ri(c2.hop1, c2.hop2, c2.config, 1)
    assert f1 is f2


def test_checked_wrapper_catches_nan():
    from srsran_ce.utils import debug

    case = synthetic.make_case(seed=3, n_prbs=8, n_layers=1)
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, 1)
    rg = estimator.split_ri(case.received_rg)
    bad = rg.copy()
    bad[0, 0, 0] = np.nan
    checked = debug.checked(lambda r, p, b: fn(r, p, b).noise_est)
    err, _ = checked(rg, estimator.split_ri(case.pilots), case.beta)
    err.throw()  # clean input -> no error
    err, _ = checked(bad, estimator.split_ri(case.pilots), case.beta)
    import pytest as _pytest

    with _pytest.raises(Exception):
        err.throw()


@pytest.mark.parametrize("two_hops", [False, True])
def test_serve_layout_is_transposed_ref(two_hops):
    """out_layout="serve" returns (layer, sym, sc) — the transpose of the
    reference-layout (sc, sym, layer) grid to within one ulp (the serve fill
    runs in explicit real ri arithmetic, whose final rotate rounds once
    differently than the complex-multiply lowering), scalars identical."""
    case = synthetic.make_case(seed=7, n_prbs=24, n_layers=2, snr_db=30.0, two_hops=two_hops)
    f_ref = estimator.build_ri(case.hop1, case.hop2, case.config, 2, out_layout="ref")
    f_srv = estimator.build_ri(case.hop1, case.hop2, case.config, 2, out_layout="serve")
    rg = estimator.split_ri(case.received_rg)
    pil = estimator.split_ri(case.pilots)
    beta = jnp.asarray(case.beta)
    r_ref = f_ref(rg, pil, beta)
    r_srv = f_srv(rg, pil, beta)
    ch_ref = np.asarray(r_ref.channel_est_rg)  # (2, sc, sym, layer)
    ch_srv = np.asarray(r_srv.channel_est_rg)  # (2, layer, sym, sc)
    np.testing.assert_allclose(
        np.moveaxis(ch_srv, (1, 2, 3), (3, 2, 1)), ch_ref, rtol=0, atol=1e-14
    )
    np.testing.assert_array_equal(np.asarray(r_srv.noise_est), np.asarray(r_ref.noise_est))
    np.testing.assert_array_equal(np.asarray(r_srv.cfo_hz), np.asarray(r_ref.cfo_hz))


def test_matmul_precision_config():
    """matmul_precision threads through (distinct executables, near-identical numerics
    on CPU) and rejects unknown values."""
    import dataclasses

    case = synthetic.make_case(seed=11, n_prbs=24, n_layers=2, snr_db=30.0)
    cfg_hi = case.config
    cfg_h = dataclasses.replace(cfg_hi, matmul_precision="high")
    f_hi = estimator.build_ri(case.hop1, case.hop2, cfg_hi, 2)
    f_h = estimator.build_ri(case.hop1, case.hop2, cfg_h, 2)
    assert f_hi is not f_h  # precision keys the jit cache
    rg = estimator.split_ri(case.received_rg)
    pil = estimator.split_ri(case.pilots)
    a = np.asarray(f_hi(rg, pil, jnp.asarray(case.beta)).channel_est_rg)
    b = np.asarray(f_h(rg, pil, jnp.asarray(case.beta)).channel_est_rg)
    denom = np.sum(a[0] ** 2 + a[1] ** 2)
    nmse = np.sum((a - b) ** 2) / denom
    assert nmse < 1e-10, nmse
    with pytest.raises(ValueError):
        dataclasses.replace(cfg_hi, matmul_precision="fast")


def test_fused_smooth_precision_pinned():
    """The fused smoothing matmuls must stay HIGHEST even under
    matmul_precision='high' — at 'high' (three bf16 passes) their ~1e-5 relative
    error dominated every multi-layer config's conformance NMSE (round-2 'c2
    outlier', 6.3e-11 vs 5e-15). Pin via the lowered HLO: a 'high' multi-layer
    serve program must carry BOTH precisions — HIGHEST on the skinny profile
    matmuls, the 'high' dot algorithm (three bf16 passes) on the wide fill."""
    import dataclasses

    import jax

    case = synthetic.make_case(seed=13, n_prbs=24, n_layers=4, snr_db=30.0)
    cfg = dataclasses.replace(case.config, matmul_precision="high")
    from srsran_ce.models.plan import make_plan

    plan = make_plan(case.hop1, case.hop2, cfg, 4)
    assert plan.hop1.smooth_mat is not None, "case must take the fused-smooth path"
    rg = estimator.split_ri(case.received_rg).astype(np.float32)
    pil = estimator.split_ri(case.pilots).astype(np.float32)

    def run(rg_ri, pil_ri, beta):
        return estimator._estimate_impl(
            plan,
            estimator._ri_to_complex(rg_ri),
            estimator._ri_to_complex(pil_ri),
            beta, None, "serve",
        ).channel_est_rg

    txt = jax.jit(run).lower(rg, pil, jnp.float32(1.0)).as_text()
    assert "precision = [HIGHEST" in txt, (
        "fused smoothing matmuls must be pinned to HIGHEST"
    )
    assert (
        "lhs_precision_type = bf16, rhs_precision_type = bf16, accumulation_type = f32"
        in txt and "num_primitive_operations = 3" in txt
    ), "the wide fill matmuls must still honor matmul_precision='high'"


def test_bf16_serving_output():
    """out_dtype='bfloat16' returns a (2, layer, sym, sc) bf16 grid ~4e-3-close to
    the f32 serve output, with full-precision scalars."""
    case = synthetic.make_case(seed=13, n_prbs=24, n_layers=2, snr_db=30.0)
    f32 = estimator.build_ri(case.hop1, case.hop2, case.config, 2, out_layout="serve")
    f16 = estimator.build_ri(
        case.hop1, case.hop2, case.config, 2, out_layout="serve", out_dtype="bfloat16"
    )
    rg = estimator.split_ri(case.received_rg).astype(np.float32)
    pil = estimator.split_ri(case.pilots).astype(np.float32)
    beta = jnp.asarray(np.float32(case.beta))
    a = f32(rg, pil, beta)
    b = f16(rg, pil, beta)
    assert b.channel_est_rg.dtype == jnp.bfloat16
    assert b.channel_est_rg.shape == a.channel_est_rg.shape
    ch_a = np.asarray(a.channel_est_rg, np.float64)
    ch_b = np.asarray(b.channel_est_rg, np.float64)
    nmse = np.sum((ch_a - ch_b) ** 2) / np.sum(ch_a**2)
    assert nmse < 1e-4, nmse  # bf16 rounding only
    np.testing.assert_allclose(float(b.noise_est), float(a.noise_est), rtol=1e-6)
    with pytest.raises(AssertionError):
        estimator.build_ri(case.hop1, case.hop2, case.config, 2, out_dtype="bfloat16")
