"""TS 38.211 sequence generation: Gold LFSR, DM-RS, low-PAPR ZC SRS.

3GPP conformance vectors are not available in this environment, so these tests pin
the generators down structurally (vectorized LFSR vs naive bit loop, ZC ideal
autocorrelation, OCC orthogonality, determinism) and end-to-end (estimator NMSE vs
the float64 oracle, channel NMSE vs ground truth, on cases driven by these pilots).
"""
import numpy as np
import pytest

from srsran_ce.models import estimator
from srsran_ce.ops import sequences
from srsran_ce.utils import oracle, synthetic


# ---------------------------------------------------------------------------
# Gold sequence
# ---------------------------------------------------------------------------


def _gold_naive(c_init: int, length: int) -> np.ndarray:
    """Straightforward bit-by-bit TS 38.211 §5.2.1 implementation (test oracle)."""
    nc = 1600
    total = nc + length + 31
    x1 = [0] * total
    x1[0] = 1
    x2 = [(c_init >> b) & 1 for b in range(31)] + [0] * (total - 31)
    for n in range(total - 31):
        x1[n + 31] = (x1[n + 3] + x1[n]) % 2
        x2[n + 31] = (x2[n + 3] + x2[n + 2] + x2[n + 1] + x2[n]) % 2
    return np.array([(x1[n + nc] + x2[n + nc]) % 2 for n in range(length)], np.uint8)


@pytest.mark.parametrize("c_init", [0, 1, 12345, 2**31 - 1, 0x5A5A5A5A % 2**31])
def test_gold_matches_naive(c_init):
    np.testing.assert_array_equal(
        sequences.gold_sequence(c_init, 500), _gold_naive(c_init, 500)
    )


def test_gold_balance_and_distinct():
    c0 = sequences.gold_sequence(7, 4096)
    c1 = sequences.gold_sequence(8, 4096)
    assert abs(float(c0.mean()) - 0.5) < 0.05  # near-balanced
    assert (c0 != c1).mean() > 0.3  # different inits decorrelate


def test_gold_rejects_out_of_range():
    with pytest.raises(ValueError):
        sequences.gold_sequence(2**31, 8)


def test_pseudo_random_qpsk_start_offset():
    full = sequences.pseudo_random_qpsk(99, 100)
    tail = sequences.pseudo_random_qpsk(99, 60, start=40)
    np.testing.assert_allclose(tail, full[40:], atol=0)
    np.testing.assert_allclose(np.abs(full), 1.0, atol=1e-12)


# ---------------------------------------------------------------------------
# Zadoff-Chu / low-PAPR base sequences
# ---------------------------------------------------------------------------


def test_zc_ideal_autocorrelation():
    n_zc = sequences.largest_prime_below(144)  # 139
    x = sequences.zadoff_chu(5, n_zc)
    np.testing.assert_allclose(np.abs(x), 1.0, atol=1e-12)
    for k in (1, 7, 50):
        r = np.vdot(x, np.roll(x, k))
        assert abs(r) < 1e-9 * n_zc, f"lag {k}: |R|={abs(r)}"


@pytest.mark.parametrize("m_zc", [36, 72, 144, 288, 1638])
def test_low_papr_is_low_papr(m_zc):
    rng = np.random.default_rng(0)
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, m_zc)))
    for u in (0, 7, 29):
        seq = sequences.low_papr_base_sequence(u, 0, m_zc)
        assert seq.shape == (m_zc,)
        np.testing.assert_allclose(np.abs(seq), 1.0, atol=1e-12)
        # cyclic extension costs ~1-2 dB over pure ZC (~2.6 dB); still well under
        # random QPSK (~7-11 dB)
        assert sequences.papr_db(seq) < 5.0 < sequences.papr_db(qpsk)


def test_low_papr_validates_args():
    with pytest.raises(ValueError):
        sequences.low_papr_base_sequence(0, 0, 24)  # tabulated short lengths
    with pytest.raises(ValueError):
        sequences.low_papr_base_sequence(30, 0, 144)
    with pytest.raises(ValueError):
        sequences.low_papr_base_sequence(0, 1, 36)  # v=1 needs M_ZC >= 72
    sequences.low_papr_base_sequence(0, 1, 72)


def test_group_hopping_varies_u():
    us = {
        sequences.srs_group_sequence(42, slot, sym, 144, "groupHopping")[0]
        for slot in range(10)
        for sym in range(14)
    }
    assert len(us) > 5  # hops over many groups
    # deterministic
    a = sequences.srs_group_sequence(42, 3, 9, 144, "groupHopping")
    assert a == sequences.srs_group_sequence(42, 3, 9, 144, "groupHopping")
    with pytest.raises(ValueError):
        sequences.srs_group_sequence(42, 0, 0, 144, "bogus")


# ---------------------------------------------------------------------------
# Framework-layout pilots
# ---------------------------------------------------------------------------


def _hop(n_prbs=24, n_layers=1, comb=2, n_sym=14, dmrs_syms=(0, 4, 9, 13), prb_start=0,
         n_prb_total=None):
    import math

    from srsran_ce.config import HopConfig

    n_cdm = math.ceil(n_layers / 2)
    re_mask = synthetic.comb_re_mask(comb, n_cdm)
    sym_mask = np.zeros(n_sym, bool)
    sym_mask[list(dmrs_syms)] = True
    n_prb_total = n_prb_total or (prb_start + n_prbs)
    prb_mask = np.zeros(n_prb_total, bool)
    prb_mask[prb_start : prb_start + n_prbs] = True
    return HopConfig.make(sym_mask, re_mask, prb_start, n_prbs, prb_mask, 0, n_sym)


def test_dmrs_pilots_layout_and_occ():
    hop = _hop(n_layers=4)
    p = sequences.pusch_dmrs_pilots(hop, 4, slot=3, n_id=17)
    assert p.shape == (24 * 6, 4, 4)
    np.testing.assert_allclose(np.abs(p), 1.0, atol=1e-12)
    occ = np.where(np.arange(p.shape[0]) % 2 == 0, 1.0, -1.0)
    np.testing.assert_allclose(p[:, :, 1], p[:, :, 0] * occ[:, None], atol=1e-12)
    np.testing.assert_allclose(p[:, :, 3], p[:, :, 2] * occ[:, None], atol=1e-12)
    # per-symbol sequences differ (c_init depends on l)
    assert np.abs(p[:, 0, 0] - p[:, 1, 0]).max() > 0.1


def test_dmrs_prb_offset_is_sequence_slice():
    """A hop at PRB k must carry the slice of the band-wide sequence, not restart."""
    wide = sequences.pusch_dmrs_pilots(_hop(n_prbs=24), 1, slot=1, n_id=5)
    shifted = sequences.pusch_dmrs_pilots(
        _hop(n_prbs=8, prb_start=10, n_prb_total=24), 1, slot=1, n_id=5
    )
    np.testing.assert_allclose(shifted[:, :, 0], wide[60 : 60 + 48, :, 0], atol=0)


def test_srs_pilots_cyclic_shift_pairs():
    hop = _hop(n_prbs=24, n_layers=2)
    p = sequences.srs_pilots(hop, 2, slot=0, n_id=11)
    n = np.arange(p.shape[0])
    np.testing.assert_allclose(np.abs(p), 1.0, atol=1e-12)
    # port 1 = port 0 * (-1)^n (cyclic shift n_cs_max/2 at comb-2)
    np.testing.assert_allclose(p[:, :, 1], p[:, :, 0] * ((-1.0) ** n)[:, None], atol=1e-9)


# ---------------------------------------------------------------------------
# End-to-end: the estimator on standard-sequence-driven cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(pilot_source="dmrs", n_prbs=24, n_layers=2),
        dict(pilot_source="dmrs", n_prbs=52, n_layers=4, scs_hz=15e3),
        dict(pilot_source="srs", n_prbs=24, n_layers=1),
        dict(pilot_source="srs", n_prbs=16, n_layers=2, two_hops=True),
    ],
)
def test_estimator_conformance_on_standard_pilots(kwargs):
    case = synthetic.make_case(seed=77, snr_db=25.0, **kwargs)
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch_j, ch_o = np.asarray(res_j.channel_est_rg), res_o.channel_est_rg
    nmse = np.sum(np.abs(ch_j - ch_o) ** 2) / np.sum(np.abs(ch_o) ** 2)
    assert nmse < 1e-18
    np.testing.assert_allclose(float(res_j.noise_est), res_o.noise_est, rtol=1e-8)


def test_estimation_quality_on_standard_pilots():
    """With standard sequences the estimate must actually track the true channel
    (OCC/cyclic-shift layer separation works through the CDM averaging)."""
    for src in ("dmrs", "srs"):
        case = synthetic.make_case(seed=3, snr_db=30.0, n_prbs=24, n_layers=2,
                                   pilot_source=src, cfo_hz=0.0)
        res = oracle.estimate(
            case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
        )
        sym = 4  # a DM-RS symbol; channel is time-flat here
        err = res.channel_est_rg[:, sym, :] - case.true_channel[:, sym, :]
        nmse = np.sum(np.abs(err) ** 2) / np.sum(np.abs(case.true_channel[:, sym, :]) ** 2)
        assert nmse < 1e-2, f"{src}: channel NMSE vs truth {nmse}"


def test_default_qpsk_draws_unchanged():
    """pilot_source default must reproduce the historical rng stream bit-for-bit."""
    a = synthetic.make_case(seed=5, n_prbs=4)
    b = synthetic.make_case(seed=5, n_prbs=4, pilot_source="qpsk")
    np.testing.assert_array_equal(a.received_rg, b.received_rg)
    np.testing.assert_array_equal(a.pilots, b.pilots)


# ---------------------------------------------------------------------------
# Short low-PAPR sequences (M_ZC = 30) and DM-RS configuration type 2
# ---------------------------------------------------------------------------


def test_low_papr_m30_closed_form():
    """TS 38.211 §5.2.2.2: M_ZC = 30 is the length-31 ZC of root u+1 at m = n+1."""
    n = np.arange(30, dtype=np.float64)
    for u in (0, 7, 29):
        seq = sequences.low_papr_base_sequence(u, 0, 30)
        expect = np.exp(-1j * np.pi * (u + 1) * (n + 1.0) * (n + 2.0) / 31.0)
        np.testing.assert_allclose(seq, expect, atol=1e-12)
        np.testing.assert_allclose(np.abs(seq), 1.0, atol=1e-12)
        assert sequences.papr_db(seq) < 5.0
    # distinct groups give distinct sequences; v=1 undefined below 72
    assert np.abs(
        sequences.low_papr_base_sequence(0, 0, 30)
        - sequences.low_papr_base_sequence(1, 0, 30)
    ).max() > 0.1
    with pytest.raises(ValueError):
        sequences.low_papr_base_sequence(0, 1, 30)
    # the four tabulated lengths still raise rather than guess
    for m_zc in (6, 12, 18, 24):
        with pytest.raises(ValueError):
            sequences.low_papr_base_sequence(0, 0, m_zc)


def test_srs_5prb_comb2_end_to_end():
    """5 PRBs at comb-2 is M_ZC = 30 — previously unsupported, now closed-form."""
    case = synthetic.make_case(seed=11, snr_db=25.0, n_prbs=5, n_layers=2,
                               pilot_source="srs")
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch_j, ch_o = np.asarray(res_j.channel_est_rg), res_o.channel_est_rg
    nmse = np.sum(np.abs(ch_j - ch_o) ** 2) / np.sum(np.abs(ch_o) ** 2)
    assert nmse < 1e-18


def test_dmrs_type2_mask_layout():
    m = sequences.dmrs_re_mask(2, 3)
    assert m.shape == (12, 3)
    for lam in range(3):
        np.testing.assert_array_equal(
            np.nonzero(m[:, lam])[0], [2 * lam, 2 * lam + 1, 2 * lam + 6, 2 * lam + 7]
        )
    # type 1 helper matches the comb builder used everywhere else
    np.testing.assert_array_equal(
        sequences.dmrs_re_mask(1, 2), synthetic.comb_re_mask(2, 2)
    )
    with pytest.raises(ValueError):
        sequences.dmrs_re_mask(3, 1)
    with pytest.raises(ValueError):
        sequences.dmrs_re_mask(2, 4)


def test_dmrs_type2_pilots_occ_and_ordinals():
    import math

    from srsran_ce.config import HopConfig

    n_prbs, n_layers = 12, 4
    re_mask = sequences.dmrs_re_mask(2, math.ceil(n_layers / 2))
    sym_mask = np.zeros(14, bool)
    sym_mask[[2, 7, 11]] = True
    hop = HopConfig.make(sym_mask, re_mask, 0, n_prbs, np.ones(n_prbs, bool), 0, 14)
    p = sequences.pusch_dmrs_pilots(hop, n_layers, slot=5, n_id=301, config_type=2)
    assert p.shape == (n_prbs * 4, 3, n_layers)
    np.testing.assert_allclose(np.abs(p), 1.0, atol=1e-12)
    # w_f alternates with k' = m mod 2; for a contiguous type-2 allocation the
    # selected REs are consecutive ordinals, so ports alternate sign per RE
    occ = np.where(np.arange(p.shape[0]) % 2 == 0, 1.0, -1.0)
    np.testing.assert_allclose(p[:, :, 1], p[:, :, 0] * occ[:, None], atol=1e-12)
    np.testing.assert_allclose(p[:, :, 3], p[:, :, 2] * occ[:, None], atol=1e-12)
    # both CDM groups carry the same scrambling sequence (mapped to own offsets)
    np.testing.assert_allclose(p[:, :, 2], p[:, :, 0], atol=1e-12)
    # a type-1 mask with config_type=2 is rejected
    hop1 = _hop(n_prbs=n_prbs)
    with pytest.raises(ValueError):
        sequences.pusch_dmrs_pilots(hop1, 1, slot=0, n_id=1, config_type=2)


def test_dmrs_type2_end_to_end():
    """Type-2 adjacent-pair CDM flows through the estimator's pair averaging."""
    case = synthetic.make_case(seed=21, snr_db=30.0, n_prbs=24, n_layers=4,
                               pilot_source="dmrs", dmrs_type=2, cfo_hz=0.0)
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch_j, ch_o = np.asarray(res_j.channel_est_rg), res_o.channel_est_rg
    nmse = np.sum(np.abs(ch_j - ch_o) ** 2) / np.sum(np.abs(ch_o) ** 2)
    assert nmse < 1e-18
    # and the estimate tracks the true channel (layer separation works)
    sym = 7
    err = res_o.channel_est_rg[:, sym, :] - case.true_channel[:, sym, :]
    nmse_true = np.sum(np.abs(err) ** 2) / np.sum(np.abs(case.true_channel[:, sym, :]) ** 2)
    assert nmse_true < 1e-2, f"channel NMSE vs truth {nmse_true}"
