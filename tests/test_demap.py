"""Soft demapper (ops/demap): exact max-log parity + end-to-end bit recovery."""
import numpy as np
import jax.numpy as jnp
import pytest

from srsran_ce.ops import demap


@pytest.mark.parametrize("mod", demap.MODULATIONS)
def test_constellation_unit_energy_gray(mod):
    pts = demap.constellation(mod)
    n = demap.bits_per_symbol(mod)
    assert pts.size == 1 << n
    assert np.unique(np.round(pts, 12)).size == pts.size
    np.testing.assert_allclose(np.mean(np.abs(pts) ** 2), 1.0, rtol=1e-12)
    # Gray property: adjacent levels on each axis differ in exactly one bit
    # (check via sorting the I-axis bit groups); BPSK has a single level pair
    if n == 1:
        return
    m = n // 2
    levels, bits = demap._pam_table(m)
    order = np.argsort(levels)
    for a, b in zip(order[:-1], order[1:]):
        assert np.sum(bits[a] != bits[b]) == 1


def test_qpsk_spec_value():
    # TS 38.211 5.1.3: d(i) = 1/sqrt(2) [(1-2b0) + j (1-2b1)]
    pts = demap.constellation("qpsk")
    np.testing.assert_allclose(pts[0], (1 + 1j) / np.sqrt(2), rtol=1e-12)
    np.testing.assert_allclose(pts[3], (-1 - 1j) / np.sqrt(2), rtol=1e-12)


def test_16qam_spec_value():
    # 5.1.4: b=0000 -> (1+j)/sqrt(10); b=1010 -> (-3-3j)... b0 b1 b2 b3 = 1 0 1 0:
    # I: (1-2*1)(2-(1-2*1)) = -(2+1) = -3; Q: (1-2*0)(2-(1-2*0)) = 1
    pts = demap.constellation("16qam")
    np.testing.assert_allclose(pts[0b0000], (1 + 1j) / np.sqrt(10), rtol=1e-12)
    np.testing.assert_allclose(pts[0b1010], (-3 + 1j) / np.sqrt(10), rtol=1e-12)
    np.testing.assert_allclose(pts[0b0101], (1 - 3j) / np.sqrt(10), rtol=1e-12)


@pytest.mark.parametrize("mod", demap.MODULATIONS)
def test_exact_maxlog_vs_bruteforce(mod):
    """The vectorized per-axis demapper must equal a brute-force max-log over
    the full 2-D constellation, for biased MMSE outputs at mixed SINRs."""
    rng = np.random.default_rng(17)
    pts = demap.constellation(mod)
    nbits = demap.bits_per_symbol(mod)
    n = 500
    sinr = 10.0 ** rng.uniform(-0.5, 2.5, n)
    alpha = sinr / (1.0 + sinr)
    x_true = pts[rng.integers(0, pts.size, n)]
    nz = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * np.sqrt(
        alpha * (1 - alpha) / 2.0
    )
    x_hat = alpha * x_true + nz  # the biased per-RE MMSE observation model
    got = np.asarray(demap.llrs(jnp.asarray(x_hat), jnp.asarray(sinr), mod))

    xt = x_hat / alpha
    d2 = np.abs(xt[:, None] - pts[None, :]) ** 2  # (n, n_pts)
    words = np.arange(pts.size)
    for k in range(nbits):
        bit = (words >> (nbits - 1 - k)) & 1
        d0 = np.min(d2[:, bit == 0], axis=1)
        d1 = np.min(d2[:, bit == 1], axis=1)
        ref = (d1 - d0) * sinr  # complex noise variance 1/sinr
        np.testing.assert_allclose(got[:, k], ref, rtol=1e-5, atol=1e-6)


def test_zero_sinr_is_erasure():
    x = jnp.asarray([0.3 + 0.1j, -0.2 - 0.5j])
    out = np.asarray(demap.llrs(x, jnp.asarray([0.0, 0.0]), "64qam"))
    assert np.all(out == 0.0)


@pytest.mark.parametrize("mod,snr_db", [("bpsk", 12.0), ("qpsk", 15.0), ("16qam", 20.0), ("1024qam", 42.0),
                                        ("64qam", 26.0), ("256qam", 33.0)])
def test_end_to_end_bits_roundtrip(mod, snr_db):
    """modulate -> AWGN at high SNR -> llrs: hard decisions recover the bits."""
    rng = np.random.default_rng(23)
    nbits = demap.bits_per_symbol(mod)
    n = 4096
    bits = rng.integers(0, 2, n * nbits)
    x = demap.modulate(bits, mod)
    sinr = 10.0 ** (snr_db / 10.0)
    # unbiased AWGN channel == MMSE model at alpha->..., feed the biased form:
    alpha = sinr / (1.0 + sinr)
    y = alpha * (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                 * np.sqrt(1.0 / (2.0 * sinr)))
    llr = np.asarray(demap.llrs(jnp.asarray(y), jnp.asarray(sinr), mod))
    dec = (llr.reshape(-1) < 0).astype(np.int64)  # positive LLR -> bit 0
    ber = np.mean(dec != bits)
    assert ber < 2e-3, (mod, ber)


def test_pusch_scrambling_roundtrip_and_descramble():
    """TS 38.211 §6.3.1.1: scrambling is an involution; descrambling soft bits
    (sign flips where c=1) recovers the original bits, int8 and float alike."""
    from srsran_ce.ops import sequences

    rng = np.random.default_rng(17)
    c_init = sequences.pusch_scrambling_c_init(rnti=0x4601, n_id=17)
    assert c_init == 0x4601 * 2**15 + 17
    bits = rng.integers(0, 2, 6 * 200).astype(np.uint8)
    scr = sequences.scramble_bits(bits, c_init)
    assert not np.array_equal(scr, bits)
    np.testing.assert_array_equal(sequences.scramble_bits(scr, c_init), bits)
    # offset consumption matches slicing the full sequence
    np.testing.assert_array_equal(
        sequences.scramble_bits(bits[60:], c_init, start=60),
        sequences.scramble_bits(bits, c_init)[60:],
    )

    # soft-bit path: modulate the SCRAMBLED bits, demap cleanly, descramble LLRs
    x = demap.modulate(scr, "64qam")
    llr = np.asarray(demap.llrs(jnp.asarray(x), jnp.asarray(100.0), "64qam"))
    llr_flat = llr.reshape(-1)
    c = sequences.gold_sequence(c_init, bits.size)
    desc = demap.descramble_llrs(llr_flat, c)
    np.testing.assert_array_equal((desc < 0).astype(np.uint8), bits)
    # int8 quantized LLRs descramble identically (sign flip commutes with clip)
    q = np.clip(np.round(llr_flat * 8.0), -127, 127).astype(np.int8)
    desc_q = demap.descramble_llrs(q, c)
    assert desc_q.dtype == np.int8
    np.testing.assert_array_equal((desc_q < 0).astype(np.uint8), bits)
    # jnp in-graph variant agrees
    desc_j = np.asarray(demap.descramble_llrs(jnp.asarray(q), c))
    np.testing.assert_array_equal(desc_j, desc_q)
