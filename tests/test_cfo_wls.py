"""WLS CFO estimator (config.cfo_estimator="wls") — conformance + quality.

The reference estimates CFO from the inner product of the FIRST two DM-RS symbols
only (ce_rule_baseline.py:415-428). The WLS mode fits the phase slope over ALL
consecutive DM-RS pairs with magnitude weights — a beyond-parity accuracy feature.
"""
import zlib

import numpy as np
import pytest

from srsran_ce.models import estimator
from srsran_ce.utils import oracle, synthetic


CASES = [
    ("1layer_4dmrs", dict(n_prbs=24, n_layers=1, n_dmrs_syms=4)),
    ("2layer_4dmrs", dict(n_prbs=24, n_layers=2, n_dmrs_syms=4)),
    ("3layer_odd", dict(n_prbs=16, n_layers=3, n_dmrs_syms=4)),
    ("two_hops", dict(n_prbs=12, n_layers=1, two_hops=True, n_dmrs_syms=4)),
    ("wiener_time_interp", dict(n_prbs=24, n_layers=2, smoothing="wiener",
                                time_interp="linear", doppler_hz=100.0)),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[c[0] for c in CASES])
def test_wls_cfo_matches_oracle(name, kwargs):
    case = synthetic.make_case(
        seed=zlib.crc32(name.encode()), snr_db=25.0, cfo_hz=250.0, cfo_estimator="wls", **kwargs
    )
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch_j = np.asarray(res_j.channel_est_rg)
    nmse = np.sum(np.abs(ch_j - res_o.channel_est_rg) ** 2) / np.sum(
        np.abs(res_o.channel_est_rg) ** 2
    )
    assert nmse < 1e-18, nmse
    np.testing.assert_allclose(float(res_j.cfo_hz), res_o.cfo_hz, rtol=1e-8)
    np.testing.assert_allclose(float(res_j.noise_est), res_o.noise_est, rtol=1e-8)


def test_wls_equals_first_pair_with_two_dmrs_symbols():
    """With exactly 2 DM-RS symbols the WLS fit degenerates to the reference
    estimator: cfo = theta / (2 pi dt), weights cancel."""
    kw = dict(seed=21, n_prbs=24, n_layers=1, n_dmrs_syms=2, snr_db=25.0, cfo_hz=180.0)
    a = synthetic.make_case(cfo_estimator="wls", **kw)
    b = synthetic.make_case(cfo_estimator="first_pair", **kw)
    res_a = estimator.estimate(a.received_rg, a.pilots, a.beta, a.hop1, a.hop2, a.config)
    res_b = estimator.estimate(b.received_rg, b.pilots, b.beta, b.hop1, b.hop2, b.config)
    np.testing.assert_allclose(float(res_a.cfo_hz), float(res_b.cfo_hz), rtol=1e-12)


def test_wls_reduces_cfo_error():
    """With 4 DM-RS symbols at low SNR, the WLS estimator's CFO RMS error must be
    meaningfully below the reference first-pair estimator's."""
    true_cfo = 220.0
    errs = {"first_pair": [], "wls": []}
    for mode in errs:
        for seed in range(24):
            case = synthetic.make_case(
                seed=300 + seed,
                n_prbs=24,
                n_layers=1,
                n_dmrs_syms=4,
                snr_db=5.0,
                cfo_hz=true_cfo,
                cfo_estimator=mode,
            )
            res = estimator.estimate(
                case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
            )
            errs[mode].append(float(res.cfo_hz) - true_cfo)
    rmse = {m: float(np.sqrt(np.mean(np.square(e)))) for m, e in errs.items()}
    assert rmse["wls"] < 0.75 * rmse["first_pair"], rmse
