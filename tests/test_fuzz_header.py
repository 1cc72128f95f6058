"""Full-format-fidelity fuzz of the C++ test-header parser + hop regrouping.

The real 248-vector header is unavailable in this environment, so the parser
(vectors.parse_test_header, mirroring validate_all.py:55-263) and the hop
regrouping heuristics (conformance._group_hops, mirroring :393-437) have to be
hardened against every structural quirk the real format exhibits: per-layer
repeated hop blocks, multiple 52-length maskPRBs runs inside one hop entry,
hop_symbol present/absent, std::nullopt second hops, PRB masks with interior
holes, string paths with digits, erratic whitespace, len-14 vs len-n_alloc
DMRS masks. generate_fuzz_header emits those quirks FROM INTENT, so this test
checks recovery of the truth — not reproduction of the parser's own output.

The sweep logic lives in srsran_ce/validation/deepfuzz.py (shared with
`cli selftest --deep`). CE_FUZZ_HEADER_N (default 120) controls the count.
"""
import os

from srsran_ce.validation import deepfuzz

N_CASES = int(os.environ.get("CE_FUZZ_HEADER_N", "120"))


def test_header_fuzz(tmp_path):
    report = deepfuzz.run_header_fuzz(N_CASES, tmp_dir=str(tmp_path))
    assert report["n_pass"] == report["n_cases"], report["failures"]
