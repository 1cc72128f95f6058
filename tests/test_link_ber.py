"""Link-level BER evaluation (validation/quality.ber_sweep + utils/synthetic.
make_mimo_case): the full chain — estimate -> joint MMSE -> soft demap ->
descramble — scored in bits against the transmitted payload and against the
perfect-CSI MMSE bound. The reference has no link-level evaluation at all
(it stops at the channel estimate, ce_rule_baseline.py:761-768).
"""
import numpy as np

from srsran_ce.utils import synthetic
from srsran_ce.validation import quality


def test_mimo_case_construction():
    """Pilot REs carry beta * pilot * H summed over the CDM pair; data_mask
    excludes DM-RS symbols and anything outside the hop band."""
    case = synthetic.make_mimo_case(
        seed=3, n_rx=2, n_layers=2, n_prbs=12, modulation="qpsk",
        snr_db=300.0, cfo_hz=0.0,  # effectively noiseless, no CFO
    )
    hop = case.hop1
    dmrs_syms = np.nonzero(hop.dmrs_symbol_mask_np)[0]
    re_full = np.kron(hop.prb_mask_np, hop.dmrs_re_mask_np[:, 0])
    re_idx = np.nonzero(re_full)[0]
    for r in range(2):
        H = case.true_channels[r]
        s = dmrs_syms[0]
        want = sum(
            case.beta * case.pilots[:, 0, l] * H[re_idx, s, l] for l in range(2)
        )
        np.testing.assert_allclose(case.received_rg[r, re_idx, s], want, rtol=1e-9)
    # data REs carry the payload through the channel
    k = np.nonzero(case.data_mask[:, 2])[0][0]
    want = sum(case.true_channels[0, k, 2, l] * case.payload[k, 2, l] for l in range(2))
    np.testing.assert_allclose(case.received_rg[0, k, 2], want, rtol=1e-9)
    assert not case.data_mask[:, dmrs_syms].any()
    assert case.data_mask.sum() > 0
    # scrambling: bits XOR c modulate to the transmitted payload
    from srsran_ce.ops import demap

    tx = demap.modulate(case.bits ^ case.scramble_c, "qpsk")[..., 0]
    np.testing.assert_allclose(tx, case.payload)


def test_ber_high_snr_near_zero_and_scramble_transparent():
    t = quality.ber_sweep(
        snrs_db=(35.0,), modulation="qpsk", n_rx=2, n_layers=1,
        n_prbs=12, n_cases=2, scramble=True,
    )[35.0]
    assert t["ber"] < 2e-3, t
    assert t["ber_perfect_csi"] < 2e-3, t
    # scrambling must be transparent to the (descrambled) error count
    u = quality.ber_sweep(
        snrs_db=(35.0,), modulation="qpsk", n_rx=2, n_layers=1,
        n_prbs=12, n_cases=2, scramble=False,
    )[35.0]
    assert u["ber"] == t["ber"], (u, t)


def test_ber_tracks_perfect_csi_bound():
    """At moderate SNR the estimated-CSI BER must stay within a small factor
    of the perfect-CSI MMSE bound (same noise/channel realizations)."""
    t = quality.ber_sweep(
        snrs_db=(10.0,), modulation="16qam", n_rx=2, n_layers=2,
        n_prbs=24, n_cases=2,
    )[10.0]
    assert t["ber_perfect_csi"] > 0  # 2x2 16QAM at 10 dB: errors expected
    assert t["ber"] < 2.0 * t["ber_perfect_csi"] + 1e-3, t
