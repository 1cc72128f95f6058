"""Failure forensics (conformance.debug_case — the reference's DEBUG_CASES dump
plus validate_case4's complex-gain alignment): a deliberately corrupted golden
must be diagnosed as "wrong by a global complex gain", and a healthy golden as
simply correct."""
import numpy as np

from srsran_ce.utils import vectors
from srsran_ce.validation import conformance, synth_vectors


def _suite(tmp_path):
    header = synth_vectors.generate_suite(
        tmp_path, [dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3)], seed0=7100
    )
    return header


def test_debug_case_healthy(tmp_path):
    header = _suite(tmp_path)
    case = vectors.parse_test_header(header)[0]
    rep = conformance.debug_case(case, tmp_path)
    best = rep["candidates"][0]
    assert best["nmse"] < 1e-9
    assert abs(best["gain_abs"] - 1.0) < 1e-4 and abs(best["gain_deg"]) < 0.1
    assert rep["n_layers"] == 2 and rep["dmrs_coords"]
    assert rep["dmrs_coords"][0]["dmrs_symbols"]  # coordinate dump present


def test_debug_case_detects_global_gain(tmp_path):
    header = _suite(tmp_path)
    case = vectors.parse_test_header(header)[0]
    # corrupt the golden: scale every reference value by a complex gain
    g_true = 0.8 * np.exp(1j * np.deg2rad(37.0))
    path = tmp_path / f"port_channel_estimator_test_output_ch_est{case.idx}.dat"
    ent = vectors.load_entries(path)
    vectors.write_entries(path, ent["sym"], ent["port"], ent["sc"], ent["value"] * g_true)

    r = conformance.run_case(case, tmp_path)
    assert not r.passed  # the suite correctly fails the corrupted case

    rep = conformance.debug_case(case, tmp_path)
    best = rep["candidates"][0]
    # the forensics recover the injected gain and show the residual collapses
    assert abs(best["gain_abs"] - 0.8) < 1e-3
    assert abs(best["gain_deg"] - 37.0) < 0.1
    assert best["nmse_after_gain"] < 1e-9 < best["nmse"]
