"""Coded-chain geometry fuzz: random (geometry, modulation, code, options)
configurations through the FULL served chain — encode -> (CRC) -> interleave
-> (scramble) -> modulate -> MIMO channel -> estimate -> joint MMSE -> fused
int8 demap -> descramble -> deinterleave -> min-sum decode — each must
recover the exact payload at high SNR. Covers corners the targeted tests
don't: frequency-hopped allocations, 1..3 RX ports, BPSK..1024QAM, CRC kinds,
layered schedule, early termination. CE_FUZZ_CODED_N widens the sweep.

The trial logic lives in srsran_ce/validation/deepfuzz.py (shared with
`cli selftest --deep`, which records the committed DEEPFUZZ_REPORT.json).
"""
import os

import pytest

from srsran_ce.validation import deepfuzz

N = int(os.environ.get("CE_FUZZ_CODED_N", "6"))


@pytest.mark.parametrize("trial", range(N))
def test_coded_chain_fuzz(trial):
    row = deepfuzz.coded_trial(trial)
    assert row["ok"], row["config"]
