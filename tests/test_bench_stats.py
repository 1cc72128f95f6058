"""Regression net for the round-4 measurement hardening: the min-of-K robust
slope aggregation (bench.py SlopeRow.stats and profiling.chained_slope_stats
share the policy) must discard broken fits — clamped/negative slopes and
estimates implausibly far BELOW the median (pollution only ever ADDS time, so
"too fast" means a broken fit, not a fast device) — before taking the min.
Round 4's first run published a 0.000 ms latency (5.9e15 "REs/s") from exactly
this failure mode."""
import importlib.util
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _load_bench():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("bench_mod", root / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row_with_slopes(bench, slopes):
    row = bench.SlopeRow("t", lambda reps: None, ())
    row.slopes = list(slopes)
    return row


def test_min_of_k_discards_broken_fits():
    bench = _load_bench()
    # a clamped fit (1e-9) and a 10x-low garbage fit must NOT become the min
    st = _row_with_slopes(bench, [3.0e-4, 1e-9, 2.8e-4, 2.5e-5, 3.1e-4]).stats()
    assert st["s_per_batch"] == 2.8e-4
    assert st["n_slopes_discarded"] == 2
    # spread computed over the SURVIVING estimates only
    assert abs(st["slope_spread"] - (3.1e-4 - 2.8e-4) / 2.8e-4) < 1e-12


def test_min_of_k_keeps_honest_minimum():
    bench = _load_bench()
    st = _row_with_slopes(bench, [2.0e-4, 2.2e-4, 1.9e-4]).stats()
    assert st["s_per_batch"] == 1.9e-4
    assert st["n_slopes_discarded"] == 0


def test_spread_warn_threshold():
    bench = _load_bench()
    st = _row_with_slopes(bench, [2.0e-4, 2.5e-4, 2.1e-4]).stats()
    assert st["spread_warn"]  # 25% > 10%
    assert st["slope_spread"] > 0.10


def test_all_broken_falls_back_gracefully():
    bench = _load_bench()
    st = _row_with_slopes(bench, [1e-9, 1e-9]).stats()
    assert st["s_per_batch"] > 0  # never zero/negative


def test_uncorroborated_fast_min_discarded_c0_pattern():
    """The c0 failure mode: a min-of-4 fit 40% below ALL
    THREE siblings (0.025 vs 0.040/0.040/0.043 ms) must be discarded — the
    old 0.3x-median rule passed it and published 44.7e9 REs/s."""
    bench = _load_bench()
    st = _row_with_slopes(bench, [2.5e-5, 4.0e-5, 4.0e-5, 4.3e-5]).stats()
    assert st["s_per_batch"] == 4.0e-5
    assert st["n_slopes_discarded"] == 1
    assert not st["spread_warn"]  # surviving spread 7.5%


def test_corroborated_fast_min_survives():
    """Two independent agreeing fast estimates are believable (pollution adds
    time; two passes both measuring fast = the device IS that fast)."""
    bench = _load_bench()
    st = _row_with_slopes(bench, [2.0e-5, 2.1e-5, 4.0e-5, 4.1e-5]).stats()
    assert st["s_per_batch"] == 2.0e-5
    assert st["n_slopes_discarded"] == 0


def test_escalation_archives_and_advances_tiers():
    """Post-hoc escalation: each escalate() call moves to the next longer
    REPS tier, archives the noisy pool (audit trail), and counts; exhausted
    tiers return False and leave the pool intact."""
    bench = _load_bench()
    row = _row_with_slopes(bench, [2.0e-4, 3.0e-4])
    tiers_taken = []
    while row.escalate():
        tiers_taken.append(tuple(row.rep_points))
        row.slopes = [1.0e-4]  # pretend a fresh (clean) longer-chain pool
    assert tiers_taken == list(bench.REPS_LONGER)
    assert row.escalations == len(bench.REPS_LONGER)
    assert 2.0e-4 in row.archived_slopes and 3.0e-4 in row.archived_slopes
    st = row.stats()
    assert st["s_per_batch"] == 1.0e-4
    assert st["archived_slope_estimates_ms"]  # recorded for audit


def test_chained_slope_stats_policy_matches():
    from srsran_ce.utils import profiling

    # drive the shared aggregation through a fake fast step on CPU: k=3
    # estimates of a trivially cheap op must produce a finite positive slope
    # and record any discards
    import jax.numpy as jnp

    st = profiling.chained_slope_stats(
        lambda x: x * 1.0000001,
        lambda c, o: o,
        (jnp.ones((8, 8)),),
        reps_lo=4,
        reps_hi=16,
        trials=1,
        k=3,
    )
    assert st["s_per_step"] > 0
    assert len(st["slopes"]) == 3
    assert st["n_discarded"] >= 0
