"""Vector-I/O + conformance pipeline tests (hermetic: synthetic srsRAN-format suite).

Covers SURVEY.md §2 components #15-#22: record reader/writer round-trip, native C++
loader parity, header parsing, pilot-layout search, and the full suite runner over
oracle-generated golden vectors.
"""
import numpy as np
import pytest

from srsran_ce.utils import vectors
from srsran_ce.validation import conformance, synth_vectors


def test_entry_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n = 500
    sym = rng.integers(0, 14, n)
    port = rng.integers(0, 4, n)
    sc = rng.integers(0, 624, n)
    vals = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    p = tmp_path / "e.dat"
    vectors.write_entries(p, sym, port, sc, vals)
    e = vectors.load_entries(p)
    assert np.array_equal(e["sym"], sym)
    assert np.array_equal(e["port"], port)
    assert np.array_equal(e["sc"], sc)
    assert np.array_equal(e["value"], vals)


def test_native_loader_matches_numpy(tmp_path):
    pytest.importorskip("ctypes")
    try:
        from srsran_ce.native import loader
    except Exception:
        pytest.skip("native loader unavailable (no compiler)")
    rng = np.random.default_rng(1)
    n = 1000
    sym = rng.integers(0, 14, n)
    port = rng.integers(0, 2, n)
    sc = rng.integers(0, 300, n)
    vals = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    p = tmp_path / "e.dat"
    vectors.write_entries(p, sym, port, sc, vals)
    raw = p.read_bytes()
    e_native = loader.parse_entries(raw)
    e_np = vectors.parse_entries_np(raw)
    for f in ("sym", "port", "sc", "value"):
        assert np.array_equal(e_native[f], e_np[f])
    g_native = loader.entries_to_grid(raw, 300, 14, 2)
    g_np = vectors.entries_to_grid(e_np, 300, 14, 2)
    assert np.array_equal(g_native, g_np)


def test_native_ri_converters():
    try:
        from srsran_ce.native import loader
    except Exception:
        pytest.skip("native loader unavailable")
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 33)) + 1j * rng.standard_normal((4, 33))).astype(np.complex64)
    ri = loader.complex_to_ri(x)
    assert np.array_equal(ri[:, 0], x.real) and np.array_equal(ri[:, 1], x.imag)
    assert np.array_equal(loader.ri_to_complex(ri), x)


def test_header_parse_and_suite(tmp_path):
    specs = [
        dict(n_prbs=24, n_layers=1, comb=2, scs_hz=15e3),
        dict(n_prbs=12, n_layers=2, comb=2, scs_hz=30e3),
        dict(n_prbs=12, n_layers=1, comb=2, scs_hz=30e3, two_hops=True),
        dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, n_rx_ports=2),
    ]
    header = synth_vectors.generate_suite(tmp_path, specs)
    cases = vectors.parse_test_header(header)
    assert len(cases) == 4
    assert cases[0].scs_hz == 15e3
    assert cases[0].grid_size_prbs == 52
    assert len(cases[2].hops) == 2
    assert cases[2].hops[0].hop_symbol is not None

    report = conformance.run_suite(header, tmp_path, nmse_bound_db=-40.0)
    assert report["n_pass"] == report["n_cases"] == 4, report


def test_pilot_candidate_search_finds_true_layout():
    rng = np.random.default_rng(3)
    n_re, n_dsym, n_layers = 36, 4, 2
    canonical = (rng.standard_normal((n_re, n_dsym, n_layers))
                 + 1j * rng.standard_normal((n_re, n_dsym, n_layers))).astype(np.complex64)
    stored = np.transpose(canonical, (1, 0, 2)).reshape(-1)  # sym-major dump
    cands = vectors.pilot_candidates(stored, n_dsym, n_re, n_layers)
    tags = [t for t, c in cands if np.array_equal(c, canonical)]
    assert any(t.startswith("sym-re-layer") for t in tags), tags


def test_native_assemble_batch_ri_matches_numpy():
    try:
        from srsran_ce.native import loader
    except Exception:
        pytest.skip("native loader unavailable")
    rng = np.random.default_rng(8)
    arrs = [
        (rng.standard_normal((9, 14)) + 1j * rng.standard_normal((9, 14))).astype(np.complex64)
        for _ in range(5)
    ]
    out = loader.assemble_batch_ri(arrs, n_threads=3)
    want = np.stack([np.stack([a.real, a.imag]) for a in arrs]).astype(np.float32)
    assert out.dtype == np.float32 and np.array_equal(out, want)


def test_run_case_batched_matches_sequential(tmp_path, monkeypatch):
    """The batched candidate search (round 3: all ordering x port problems
    through one batched executable) must select the same ordering and report
    the same errors as the sequential single-problem path."""
    import srsran_ce.validation.conformance as _conf

    specs = [dict(n_prbs=12, n_layers=4, comb=2, scs_hz=30e3)]
    header = synth_vectors.generate_suite(tmp_path, specs, seed0=777)
    case = vectors.parse_test_header(header)[0]

    res_batched = _conf.run_case(case, tmp_path)  # 4 layers: 144 candidates

    # raise the threshold so the same case runs the sequential branch
    monkeypatch.setattr(_conf, "_BATCH_SEARCH_MIN_PROBLEMS", 10**9)
    res_seq = _conf.run_case(case, tmp_path)

    assert res_batched.ordering == res_seq.ordering
    assert res_batched.passed and res_seq.passed
    np.testing.assert_allclose(res_batched.rms_err, res_seq.rms_err, rtol=1e-9)
    np.testing.assert_allclose(res_batched.max_err, res_seq.max_err, rtol=1e-9)
    np.testing.assert_allclose(res_batched.nmse, res_seq.nmse, rtol=1e-9)
