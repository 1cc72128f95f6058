"""Randomized-geometry fuzz conformance: jitted estimator vs float64 oracle.

The reference suite spans 248 heterogeneous srsRAN cases (SCS, smoothing, CFO,
grid sizes, 1-4 layers, single/dual hop — scripts/validation/validate_all.py:208-231).
Those vectors are not shipped, so this fuzzer samples the same geometry space
at random and asserts the production path matches the float64 numpy oracle on
every draw (incl. scalar measurements and the factored-output reconstruction).
Seeded and deterministic; widen with CE_FUZZ_N=<draws>.

The draw/check logic lives in srsran_ce/validation/deepfuzz.py — the same
code `cli selftest --deep` runs at depth to produce the committed
DEEPFUZZ_REPORT.json, so the recorded evidence and the CI gate cannot drift
apart.
"""
import os

import pytest

from srsran_ce.validation import deepfuzz

N_DRAWS = int(os.environ.get("CE_FUZZ_N", "12"))


@pytest.mark.parametrize("draw", range(N_DRAWS))
def test_fuzzed_geometry_matches_oracle(draw):
    row = deepfuzz.check_geometry(draw)
    assert row["ok"], row
