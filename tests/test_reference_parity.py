"""Optional exact-parity test against the reference implementation itself.

Runs the reference (torch CPU, /root/reference mounted read-only) as a black box on
synthetic cases and checks our float64 oracle agrees to machine precision. Skipped
when the reference checkout or torch is unavailable (normal CI relies on the
oracle-vs-JAX chain in test_estimator_vs_oracle.py; this closes the remaining link
reference == oracle).

Measured agreement when run: channel NMSE ~1e-32, scalars ~1e-16 (pure float64
rounding) across baseline/tensorized/cnn variants, all smoothing modes, 1-4 layers,
dual hops, and CNN alpha blending.
"""
import os
import sys

import numpy as np
import pytest

REF = "/root/reference/src"
torch = pytest.importorskip("torch")
if not os.path.isdir(REF):  # pragma: no cover
    pytest.skip("reference checkout not available", allow_module_level=True)

from srsran_ce.utils import oracle, synthetic


def _run_reference(variant, case, cnn_alpha=0.0):
    sys.path.insert(0, REF)
    try:
        if variant == "cnn":
            import ce_dl_cnn as mod
        elif variant == "baseline":
            import ce_rule_baseline as mod
        else:
            import ce_rule_tensorized as mod
    finally:
        sys.path.remove(REF)

    def hop_t(h):
        return mod.HopConfig(
            DMRSsymbols=torch.as_tensor(h.dmrs_symbol_mask_np),
            DMRSREmask=torch.as_tensor(h.dmrs_re_mask_np),
            PRBstart=h.prb_start,
            nPRBs=h.n_prbs,
            maskPRBs=torch.as_tensor(h.prb_mask_np),
            startSymbol=h.start_symbol,
            nAllocatedSymbols=h.n_allocated_symbols,
        )

    hop1 = hop_t(case.hop1)
    hop2 = (
        hop_t(case.hop2)
        if case.hop2 is not None
        else mod.HopConfig(
            DMRSsymbols=torch.zeros(0, dtype=torch.bool),
            DMRSREmask=torch.as_tensor(case.hop1.dmrs_re_mask_np),
            PRBstart=0,
            nPRBs=0,
            maskPRBs=torch.zeros(0, dtype=torch.bool),
            startSymbol=0,
            nAllocatedSymbols=0,
        )
    )
    cfg = mod.EstimatorConfig(
        scs=case.config.scs_hz,
        CyclicPrefixDurations=torch.as_tensor(case.config.cp_durations_np),
        Smoothing=case.config.smoothing,
        CFOCompensate=case.config.cfo_compensate,
    )
    if variant == "cnn" and cnn_alpha > 0:
        cfg.CNNSmoothingAlpha = cnn_alpha  # duck-typed optional (ce_dl_cnn.py:864-867)
    rg = torch.as_tensor(case.received_rg.astype(np.complex128))
    pil = torch.as_tensor(case.pilots.astype(np.complex128))
    ch, noise, rsrp, epre, ta, cfo = mod.srs_channel_estimator(
        rg, pil, case.beta, hop1, hop2, cfg
    )
    return ch.numpy(), float(noise), float(rsrp), float(epre), float(ta), (
        float(cfo) if cfo.numel() else None
    )


PARITY_CASES = [
    ("baseline", dict(n_prbs=52, n_layers=1, scs_hz=15e3), 0.0),
    ("tensorized", dict(n_prbs=106, n_layers=4, scs_hz=30e3), 0.0),
    ("tensorized", dict(n_prbs=24, n_layers=1, two_hops=True), 0.0),
    ("tensorized", dict(n_prbs=24, n_layers=2, smoothing="mean"), 0.0),
    ("tensorized", dict(n_prbs=24, n_layers=1, smoothing="none", cfo_compensate=False), 0.0),
    ("baseline", dict(n_prbs=24, n_layers=3), 0.0),
    ("cnn", dict(n_prbs=52, n_layers=1, interp="cnn"), 0.0),
    ("cnn", dict(n_prbs=52, n_layers=2, interp="cnn", cnn_alpha=0.4), 0.4),
    # non-contiguous maskPRBs (interior hole): nPRBs = set-PRB count
    ("tensorized", dict(n_prbs=24, n_layers=1, prb_hole=(10, 14)), 0.0),
    ("baseline", dict(n_prbs=16, n_layers=2, prb_hole=(5, 7), two_hops=True), 0.0),
]


@pytest.mark.parametrize("variant,kwargs,alpha", PARITY_CASES)
def test_oracle_matches_reference(variant, kwargs, alpha):
    case = synthetic.make_case(seed=999, snr_db=30.0, **kwargs)
    ch_r, noise_r, rsrp_r, epre_r, ta_r, cfo_r = _run_reference(variant, case, alpha)
    ours = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    nmse = np.sum(np.abs(ours.channel_est_rg - ch_r) ** 2) / (np.sum(np.abs(ch_r) ** 2) + 1e-30)
    assert nmse < 1e-24, nmse
    np.testing.assert_allclose(ours.noise_est, noise_r, rtol=1e-10)
    np.testing.assert_allclose(ours.rsrp, rsrp_r, rtol=1e-12)
    np.testing.assert_allclose(ours.epre, epre_r, rtol=1e-12)
    np.testing.assert_allclose(ours.time_alignment, ta_r, rtol=1e-12, atol=1e-18)
    if cfo_r is None:
        assert ours.cfo_hz is None
    else:
        np.testing.assert_allclose(ours.cfo_hz, cfo_r, rtol=1e-10)
