"""Randomized-geometry fuzz across the shard_map seams.

The fixed-geometry sharding examples (tests/test_sharding.py) pin the halo
exchange / pad+mask / hopped routes at known shapes; this fuzzer samples the
same geometry space at random — estimator (single + dp-batched + factored),
joint receiver (with and without the fused demap), and the multi-slot tracker
— on the 8-virtual-device CPU mesh and gates every draw against the float64
oracle (estimator) or the unsharded builder (receiver/tracked). Seeded and
deterministic; widen with CE_FUZZ_SP_N=<draws>.

The draw/check logic lives in srsran_ce/validation/deepfuzz.py — the same
code `cli selftest --deep` runs at depth (N>=30) to produce the committed
DEEPFUZZ_REPORT.json `sp` section, so the recorded evidence and the CI gate
cannot drift apart.
"""
import os

import pytest

from srsran_ce.validation import deepfuzz

N_DRAWS = int(os.environ.get("CE_FUZZ_SP_N", "6"))


@pytest.mark.parametrize("draw", range(N_DRAWS))
def test_fuzzed_geometry_matches_across_shard_seams(draw):
    row = deepfuzz.check_sp_case(draw)
    assert row["ok"], row
