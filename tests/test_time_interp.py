"""Time-domain interpolation (config.time_interp="linear") — conformance + quality.

The reference broadcasts one time-averaged frequency profile across all allocated
OFDM symbols (ce_rule_baseline.py:625, :333-358), which is exact only for
time-invariant channels. time_interp="linear" smooths each DM-RS symbol's estimate
separately and interpolates between DM-RS symbol times — a beyond-parity capability
for Doppler / time-varying channels. Conformance: the jitted estimator must match
the float64 oracle's independent implementation. Quality: under Doppler it must
beat the broadcast path by a wide margin and stay identical without Doppler.
"""
import zlib

import numpy as np
import pytest

from srsran_ce.models import estimator
from srsran_ce.utils import oracle, synthetic


def _nmse(a, b):
    return np.sum(np.abs(a - b) ** 2) / (np.sum(np.abs(b) ** 2) + 1e-30)


CASES = [
    ("filter_1layer", dict(n_prbs=24, n_layers=1)),
    ("filter_2layer", dict(n_prbs=24, n_layers=2)),
    ("filter_4layer", dict(n_prbs=52, n_layers=4)),
    ("two_hops", dict(n_prbs=12, n_layers=1, two_hops=True)),
    ("cnn_interp", dict(n_prbs=24, n_layers=1, interp="cnn")),
    ("wiener", dict(n_prbs=24, n_layers=2, smoothing="wiener")),
    ("mean", dict(n_prbs=24, n_layers=1, smoothing="mean")),
    ("none_smoothing", dict(n_prbs=24, n_layers=1, smoothing="none")),
    ("cfo_off", dict(n_prbs=24, n_layers=1, cfo_compensate=False)),
    ("two_dmrs_syms", dict(n_prbs=24, n_layers=1, n_dmrs_syms=2)),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[c[0] for c in CASES])
def test_time_interp_matches_oracle(name, kwargs):
    case = synthetic.make_case(
        seed=zlib.crc32(name.encode()), snr_db=30.0, doppler_hz=200.0, time_interp="linear", **kwargs
    )
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    assert _nmse(np.asarray(res_j.channel_est_rg), res_o.channel_est_rg) < 1e-18
    np.testing.assert_allclose(float(res_j.noise_est), res_o.noise_est, rtol=1e-8)
    np.testing.assert_allclose(float(res_j.rsrp), res_o.rsrp, rtol=1e-9)
    np.testing.assert_allclose(
        float(res_j.time_alignment), res_o.time_alignment, rtol=1e-9, atol=1e-15
    )


def test_single_dmrs_symbol_degenerates_to_broadcast():
    """n_dsym < 2: the plan drops the time-interp matrix and the output is
    bit-identical to the reference broadcast behavior."""
    kw = dict(seed=7, n_prbs=24, n_layers=1, n_dmrs_syms=1, snr_db=30.0)
    a = synthetic.make_case(time_interp="linear", **kw)
    b = synthetic.make_case(time_interp="none", **kw)
    res_a = estimator.estimate(a.received_rg, a.pilots, a.beta, a.hop1, a.hop2, a.config)
    res_b = estimator.estimate(b.received_rg, b.pilots, b.beta, b.hop1, b.hop2, b.config)
    np.testing.assert_array_equal(
        np.asarray(res_a.channel_est_rg), np.asarray(res_b.channel_est_rg)
    )


def test_scalar_metrics_unchanged_by_time_interp():
    """noise/RSRP/EPRE/TA/CFO stay on the time-averaged path — identical outputs."""
    kw = dict(seed=9, n_prbs=24, n_layers=2, snr_db=25.0, doppler_hz=150.0)
    a = synthetic.make_case(time_interp="linear", **kw)
    b = synthetic.make_case(time_interp="none", **kw)
    res_a = estimator.estimate(a.received_rg, a.pilots, a.beta, a.hop1, a.hop2, a.config)
    res_b = estimator.estimate(b.received_rg, b.pilots, b.beta, b.hop1, b.hop2, b.config)
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(
            float(getattr(res_a, f)), float(getattr(res_b, f)), rtol=1e-12
        )


def test_time_interp_beats_broadcast_under_doppler():
    """Quality: with a 400 Hz Doppler channel at 30 kHz SCS, time interpolation
    tracks the channel and the broadcast path doesn't."""
    nmse = {}
    for ti in ("none", "linear"):
        errs = []
        for seed in range(4):
            case = synthetic.make_case(
                seed=100 + seed,
                n_prbs=52,
                n_layers=1,
                snr_db=40.0,
                doppler_hz=400.0,
                cfo_hz=0.0,
                time_interp=ti,
            )
            res = estimator.estimate(
                case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
            )
            ch = np.asarray(res.channel_est_rg)[:, :, 0]
            truth = case.true_channel[:, :, 0]
            errs.append(_nmse(ch, truth))
        nmse[ti] = float(np.mean(errs))
    # time interpolation should cut the tracking error by well over an order
    # of magnitude in this regime
    assert nmse["linear"] < nmse["none"] / 10.0, nmse


def test_time_interp_harmless_without_doppler():
    """On a time-flat channel the interpolated estimate stays as good as the
    broadcast one (per-symbol estimates are noisier, but smoothing + high SNR
    keep the gap tiny)."""
    nmse = {}
    for ti in ("none", "linear"):
        case = synthetic.make_case(
            seed=3, n_prbs=52, n_layers=1, snr_db=35.0, cfo_hz=100.0, time_interp=ti
        )
        res = estimator.estimate(
            case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
        )
        ch = np.asarray(res.channel_est_rg)[:, :, 0]
        nmse[ti] = _nmse(ch, case.true_channel[:, :, 0])
    assert nmse["linear"] < 4.0 * nmse["none"], nmse


def test_serve_layout_matches_ref_layout_time_interp():
    case = synthetic.make_case(
        seed=5, n_prbs=24, n_layers=2, snr_db=30.0, doppler_hz=200.0, time_interp="linear"
    )
    from srsran_ce.models.plan import make_plan

    plan = make_plan(case.hop1, case.hop2, case.config, case.pilots.shape[2])
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    ref = estimator._estimate_impl(
        plan, estimator._ri_to_complex(rg), estimator._ri_to_complex(pil),
        np.float32(case.beta), None, "ref",
    )
    srv = estimator._estimate_impl(
        plan, estimator._ri_to_complex(rg), estimator._ri_to_complex(pil),
        np.float32(case.beta), None, "serve",
    )
    np.testing.assert_allclose(
        np.asarray(srv.channel_est_rg),
        np.transpose(np.asarray(ref.channel_est_rg), (2, 1, 0)),
        rtol=1e-6,
        atol=1e-7,
    )
