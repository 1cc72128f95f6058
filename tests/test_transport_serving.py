"""Coded-transport layout (transport.py) + decoded serving
(serving.process(out="decoded")): the full uplink PHY served end to end —
encode -> interleave -> scramble -> modulate -> MIMO channel -> estimate ->
joint MMSE -> fused int8 demap -> descramble -> deinterleave -> batched
min-sum decode — with the TX and RX sides agreeing through ONE shared layout
implementation."""
import numpy as np
import pytest

from srsran_ce import serving, transport
from srsran_ce.ops import demap, ldpc, sequences
from srsran_ce.utils import synthetic


def test_data_mask_matches_synthetic_convention():
    for kwargs in (
        dict(n_prbs=12, n_layers=2),
        dict(n_prbs=6, n_layers=1, two_hops=True),
    ):
        case = synthetic.make_mimo_case(seed=9, n_rx=1, modulation="qpsk", **kwargs)
        n_sc, n_sym = case.data_mask.shape
        got = transport.data_mask(case.hop1, case.hop2, n_sc, n_sym)
        assert np.array_equal(got, case.data_mask), kwargs


def test_scramble_planes_match_synthetic_tx():
    case = synthetic.make_mimo_case(
        seed=7, n_rx=1, modulation="16qam", n_prbs=6, n_layers=2, scramble=True
    )
    n_sc, n_sym = case.data_mask.shape
    c_init = sequences.pusch_scrambling_c_init(0x4601, 7 % 1024, q=0)
    got = transport.scramble_planes(c_init, n_sc, n_sym, 2, 4)
    assert np.array_equal(got, case.scramble_c)


def test_place_extract_roundtrip():
    code = ldpc.array_code(3, 8, 13)
    case = synthetic.make_mimo_case(seed=3, n_rx=1, modulation="qpsk", n_prbs=12)
    n_sc, n_sym = case.data_mask.shape
    coding = transport.TransportCoding(code=code, interleave_seed=5)
    lay = transport.layout(coding, case.hop1, case.hop2, n_sc, n_sym, 1, 2)
    rng = np.random.default_rng(0)
    cw = rng.integers(0, 2, (lay.c_words, code.n), dtype=np.uint8)
    bits = transport.place_codewords(lay, cw, 1, 2, fill_rng=rng)
    # hard "LLRs": +1 for bit 0, -1 for bit 1 -> extract recovers the words
    llr = 1.0 - 2.0 * bits.astype(np.float64)
    got = (transport.extract_streams(lay, llr) < 0).astype(np.uint8)
    assert np.array_equal(got, cw)


def test_decoded_serving_end_to_end():
    """Transmit LDPC codewords through the synthetic MIMO link and recover the
    exact payloads with serving.process(out='decoded') — scrambling included."""
    code = ldpc.array_code(8, 16, 61)  # rate ~0.5: decodes with margin at 20 dB
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    n_layers, n_rx = 2, 2
    mk = dict(n_rx=n_rx, modulation="16qam", scramble=True, n_prbs=12, n_layers=n_layers)

    problems, payloads, cases = [], [], []
    for seed in (5100, 5101):
        probe = synthetic.make_mimo_case(seed=seed, snr_db=20.0, **mk)
        n_sc, n_sym = probe.data_mask.shape
        c_init = sequences.pusch_scrambling_c_init(0x4601, seed % 1024, q=0)
        coding = transport.TransportCoding(
            code=code, n_iters=30, interleave_seed=77, scramble_c_init=c_init
        )
        lay = transport.layout(coding, probe.hop1, probe.hop2, n_sc, n_sym, n_layers, nbits)
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
        bits = transport.place_codewords(lay, ldpc.encode(code, u), n_layers, nbits, fill_rng=rng)
        case = synthetic.make_mimo_case(seed=seed, snr_db=20.0, bits=bits, **mk)
        problems.append(
            serving.Problem(
                case.received_rg.astype(np.complex64),
                case.pilots.astype(np.complex64),
                case.beta,
                case.hop1,
                case.hop2,
                case.config,
            )
        )
        payloads.append(u)
        cases.append((coding, case))

    # both problems share one c_init convention only if seeds match mod 1024 —
    # here they differ, so serve each with its own coding (separate calls)
    for prob, u, (coding, case) in zip(problems, payloads, cases):
        res = serving.process(
            [prob], batch_size=4, out="decoded", modulation="16qam", coding=coding,
            matmul_precision=None,
        )[0]
        assert isinstance(res, serving.DecodedServeResult)
        assert res.info.shape == (u.shape[0], plan.k)
        assert bool(np.asarray(res.ok).all()), "parity must pass at 20 dB with rate 0.5"
        assert np.array_equal(res.info, u), "decoded payload must be exact"
        # raw channel must have had work to do (hard decisions imperfect)
        lay = transport.layout(
            coding, case.hop1, case.hop2, *case.data_mask.shape, n_layers, nbits
        )
        llr = res.soft.llr * (
            1 - 2 * transport.scramble_planes(
                coding.scramble_c_init, *case.data_mask.shape, n_layers, nbits
            ).astype(np.int8)
        )
        raw = (transport.extract_streams(lay, llr) < 0).astype(np.uint8)
        tx = ldpc.encode(code, u)
        assert int(np.sum(raw != tx)) > 0, "SNR chosen so the uncoded channel errs"


def test_decoded_requires_coding_and_modulation():
    case = synthetic.make_mimo_case(seed=1, n_rx=1, modulation="qpsk", n_prbs=6)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64),
        case.pilots.astype(np.complex64),
        case.beta,
        case.hop1,
        case.hop2,
        case.config,
    )
    with pytest.raises(ValueError):
        serving.process([prob], out="decoded", modulation="qpsk")
    with pytest.raises(ValueError):
        serving.process([prob], out="decoded", coding=transport.TransportCoding(
            code=ldpc.array_code(2, 6, 11)))


def test_crc_known_vector_and_detection():
    # CRC-16/CCITT (poly 0x1021, zero init — the TS 38.212 gCRC16) of the
    # ASCII bits of "123456789" is 0x31C3 (the classic XMODEM check value).
    msg = np.unpackbits(np.frombuffer(b"123456789", np.uint8))
    got = transport.crc_bits(msg, "crc16")
    want = np.array([int(b) for b in f"{0x31C3:016b}"], np.uint8)
    assert np.array_equal(got, want)
    word = transport.crc_attach(msg, "crc24a")
    assert transport.crc_check(word, "crc24a")
    bad = word.copy()
    bad[5] ^= 1
    assert not transport.crc_check(bad, "crc24a")
    # vectorized over words
    words = np.stack([word, bad])
    assert np.array_equal(transport.crc_check(words, "crc24a"), [True, False])


def test_decoded_serving_with_crc_gate():
    """coding.crc: payload carries a CRC24A inside each codeword; serving
    checks it, strips it, and the undecodable-at-zero-SNR case flags ok=False
    even when min-sum happens to satisfy the LDPC parity."""
    code = ldpc.array_code(8, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    n_layers, n_rx = 2, 2
    mk = dict(n_rx=n_rx, modulation="16qam", scramble=False, n_prbs=12, n_layers=n_layers)
    seed = 5100
    probe = synthetic.make_mimo_case(seed=seed, snr_db=20.0, **mk)
    n_sc, n_sym = probe.data_mask.shape
    coding = transport.TransportCoding(code=code, n_iters=30, interleave_seed=3, crc="crc24a")
    lay = transport.layout(coding, probe.hop1, probe.hop2, n_sc, n_sym, n_layers, nbits)
    kp = transport.payload_bits(coding, plan.k)
    assert kp == plan.k - 24
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (lay.c_words, kp), dtype=np.uint8)
    cw = ldpc.encode(code, transport.crc_attach(u, "crc24a"))
    bits = transport.place_codewords(lay, cw, n_layers, nbits, fill_rng=rng)
    case = synthetic.make_mimo_case(seed=seed, snr_db=20.0, bits=bits, **mk)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    res = serving.process(
        [prob], batch_size=4, out="decoded", modulation="16qam", coding=coding,
        matmul_precision=None,
    )[0]
    assert res.info.shape == (lay.c_words, kp)
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(res.info, u)


def test_harq_chase_combining_recovers_failed_transmissions():
    """transport.combine_llrs: two transmissions of the SAME codewords at an
    SNR where each alone fails; chase-combined soft bits must decode exactly
    (int8 path, with saturation semantics)."""
    code = ldpc.array_code(8, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    n_layers, n_rx = 2, 2
    snr = 11.0  # each transmission alone is below the code's waterfall
    mk = dict(n_rx=n_rx, modulation="16qam", scramble=False, n_prbs=12, n_layers=n_layers)
    seed = 6200
    geo = synthetic.make_case(seed=seed, snr_db=snr, n_prbs=12, n_layers=n_layers)
    n_sc, n_sym = geo.received_rg.shape
    coding = transport.TransportCoding(code=code, n_iters=30, interleave_seed=1)
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
    bits = transport.place_codewords(lay, ldpc.encode(code, u), n_layers, nbits, fill_rng=rng)

    soft = []
    per_tx_ok = []
    for tx in range(2):
        case = synthetic.make_mimo_case(
            seed=seed, snr_db=snr, bits=bits, noise_seed=7000 + tx, **mk
        )
        prob = serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            case.beta, case.hop1, case.hop2, case.config,
        )
        res = serving.process(
            [prob], batch_size=4, out="decoded", modulation="16qam", coding=coding,
            matmul_precision=None,
        )[0]
        per_tx_ok.append(bool(np.asarray(res.ok).all()))
        soft.append(res.soft.llr)
    assert not all(per_tx_ok), "SNR chosen so a single transmission fails sometimes"
    combined = transport.combine_llrs(soft)
    assert combined.dtype == np.int8
    dec = ldpc.build_decoder(code, n_iters=30)(transport.extract_streams(lay, combined))
    assert bool(np.asarray(dec.ok).all()), "chase combining must rescue the block"
    assert np.array_equal(
        np.asarray(dec.bits)[:, ldpc.make_ldpc_plan(code).info_cols], u
    )


def test_decoded_serving_mixed_geometries_one_call():
    """One process(out='decoded') call over problems with DIFFERENT
    geometries (12 vs 18 PRB): per-geometry layouts, cross-problem word
    batching and the scatter-back ordering must all hold."""
    code = ldpc.array_code(8, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    coding = transport.TransportCoding(code=code, n_iters=30, interleave_seed=9)
    problems, payloads, counts = [], [], []
    for seed, prbs in ((7300, 12), (7301, 18), (7302, 12)):
        mk = dict(n_rx=2, modulation="16qam", scramble=False, n_prbs=prbs, n_layers=2)
        geo = synthetic.make_case(seed=seed, snr_db=22.0, n_prbs=prbs, n_layers=2)
        n_sc, n_sym = geo.received_rg.shape
        lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 2, nbits)
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
        bits = transport.place_codewords(lay, ldpc.encode(code, u), 2, nbits, fill_rng=rng)
        case = synthetic.make_mimo_case(seed=seed, snr_db=22.0, bits=bits, **mk)
        problems.append(serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            case.beta, case.hop1, case.hop2, case.config))
        payloads.append(u)
        counts.append(lay.c_words)
    res = serving.process(problems, batch_size=4, out="decoded", modulation="16qam",
                          coding=coding, matmul_precision=None)
    assert counts[0] != counts[1], "geometries must differ in word count"
    for r, u in zip(res, payloads):
        assert r.info.shape[0] == u.shape[0]
        assert bool(np.asarray(r.ok).all())
        assert np.array_equal(r.info, u)


def test_ir_harq_punctured_rvs_combine_and_decode():
    """Incremental redundancy: tx_bits = n/2 sends half the codeword per
    transmission (effective rate ~1 — undecodable alone even at high SNR);
    RV0 + RV1 cover the full codeword, and combine_llrs of the extracted
    streams decodes exactly."""
    code = ldpc.array_code(8, 16, 61)  # n=976, mother rate ~0.5
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    n_layers = 2
    mk = dict(n_rx=2, modulation="16qam", scramble=False, n_prbs=12, n_layers=n_layers)
    seed = 8400
    geo = synthetic.make_case(seed=seed, snr_db=25.0, n_prbs=12, n_layers=n_layers)
    n_sc, n_sym = geo.received_rg.shape
    base = dict(code=code, n_iters=30, interleave_seed=4, tx_bits=code.n // 2)
    lay0 = transport.layout(transport.TransportCoding(**base, rv=0),
                            geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
    lay1 = transport.layout(transport.TransportCoding(**base, rv=1),
                            geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
    assert lay0.c_words == lay1.c_words
    assert np.intersect1d(lay0.cw_sel, lay1.cw_sel).size == 0, "RV windows disjoint"
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (lay0.c_words, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)

    streams = []
    for rv, lay in ((0, lay0), (1, lay1)):
        bits = transport.place_codewords(lay, cw, n_layers, nbits, fill_rng=rng)
        case = synthetic.make_mimo_case(
            seed=seed, snr_db=25.0, bits=bits, noise_seed=8500 + rv, **mk
        )
        prob = serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            case.beta, case.hop1, case.hop2, case.config,
        )
        soft = serving.process(
            [prob], batch_size=4, out="llrs", modulation="16qam",
            matmul_precision=None,
        )[0]
        streams.append(transport.extract_streams(lay, soft.llr))
        # a single punctured RV is rate ~1: parity cannot be satisfied reliably
        d1 = ldpc.build_decoder(code, n_iters=30)(streams[-1])
        assert not bool(np.asarray(d1.ok).all()), f"rv{rv} alone must not decode"
    combined = transport.combine_llrs(streams)
    d = ldpc.build_decoder(code, n_iters=30)(combined)
    assert bool(np.asarray(d.ok).all()), "RV0+RV1 must decode"
    assert np.array_equal(np.asarray(d.info), u)


def test_decoded_serving_per_problem_codings():
    """coding= accepts a list aligned with problems: per-UE scrambling
    initializers decode correctly in ONE process call."""
    code = ldpc.array_code(8, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    n_layers = 2
    problems, payloads, codings = [], [], []
    for seed, rnti in ((7500, 0x1111), (7501, 0x2222)):
        mk = dict(n_rx=2, modulation="16qam", scramble=True, rnti=rnti,
                  n_prbs=12, n_layers=n_layers)
        geo = synthetic.make_case(seed=seed, snr_db=22.0, n_prbs=12, n_layers=n_layers)
        n_sc, n_sym = geo.received_rg.shape
        c_init = sequences.pusch_scrambling_c_init(rnti, seed % 1024)
        coding = transport.TransportCoding(
            code=code, n_iters=30, interleave_seed=2, scramble_c_init=c_init
        )
        lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
        bits = transport.place_codewords(lay, ldpc.encode(code, u), n_layers, nbits, fill_rng=rng)
        case = synthetic.make_mimo_case(seed=seed, snr_db=22.0, bits=bits, **mk)
        problems.append(serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            case.beta, case.hop1, case.hop2, case.config))
        payloads.append(u)
        codings.append(coding)
    assert codings[0] != codings[1]
    res = serving.process(problems, batch_size=4, out="decoded", modulation="16qam",
                          coding=codings, matmul_precision=None)
    for r, u in zip(res, payloads):
        assert bool(np.asarray(r.ok).all())
        assert np.array_equal(r.info, u)


def test_payload_bits_rejects_crc_wider_than_k():
    """payload_bits must raise when the CRC leaves no payload (k <= degree) —
    otherwise decoded serving would slice with a non-positive bound and
    silently return empty payloads."""
    code = ldpc.array_code(3, 8, 11)
    plan = ldpc.make_ldpc_plan(code)
    assert plan.k > 24
    ok = transport.TransportCoding(code=code, crc="crc24a")
    assert transport.payload_bits(ok, plan.k) == plan.k - 24
    with pytest.raises(ValueError):
        transport.payload_bits(ok, 24)  # k == degree
    with pytest.raises(ValueError):
        transport.payload_bits(ok, 20)  # k < degree


def test_decoded_serving_nr_rate_match():
    """serving.process(out='decoded') with rate_match='nr' end to end: the TS
    38.212 §5.4.2 chain (punctured 2Z head, filler priors, Qm interleaving,
    CRC11 gate) through the real served receiver — not just the transport-layer
    roundtrip. Payload must come back exact with CRC and parity both passing."""
    from srsran_ce.ops import nr_ldpc as nr

    code = nr.nr_base_graph(2, 32)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("qpsk")
    rnti, seed = 0x3344, 4242
    c_init = sequences.pusch_scrambling_c_init(rnti, seed % 1024)
    coding = transport.TransportCoding(
        code=code, rate_match="nr", n_filler=16, crc="crc11", n_iters=20,
        scramble_c_init=c_init,
    )
    geo = synthetic.make_case(seed=seed, snr_db=22.0, n_prbs=24, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    assert lay.filler_pos is not None and lay.c_words >= 1
    rng = np.random.default_rng(seed)
    k_pay = transport.payload_bits(coding, plan.k)
    u = rng.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    words = transport.crc_attach(u, "crc11")
    words_full = np.concatenate(
        [words, np.zeros((lay.c_words, coding.n_filler), np.uint8)], axis=1
    )
    bits = transport.place_codewords(
        lay, ldpc.encode(code, words_full), 1, nbits, fill_rng=rng
    )
    case = synthetic.make_mimo_case(
        seed=seed, n_rx=2, modulation="qpsk", scramble=True, rnti=rnti,
        bits=bits, n_prbs=24, n_layers=1, snr_db=22.0,
    )
    res = serving.process(
        [serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            case.beta, case.hop1, case.hop2, case.config,
        )],
        batch_size=4, out="decoded", modulation="qpsk", coding=coding,
        matmul_precision=None,
    )
    assert bool(np.asarray(res[0].ok).all())
    assert np.array_equal(res[0].info, u)


def test_decoded_serving_layered_group():
    """serving.process(out='decoded') with the layered schedule + row-group
    option threaded through TransportCoding (schedule='layered',
    layered_group=2): the plumbing that routes served decodes onto the
    grouped layered decoder that kernels="auto" picks."""
    code = ldpc.array_code(4, 8, 23)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("qpsk")
    mk = dict(n_rx=1, modulation="qpsk", scramble=False, n_prbs=12, n_layers=1)
    coding = transport.TransportCoding(
        code=code, n_iters=12, interleave_seed=3, schedule="layered",
        layered_group=2, early_iters=None,
    )
    geo = synthetic.make_case(seed=51, snr_db=25.0, n_prbs=12, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
    bits = transport.place_codewords(lay, ldpc.encode(code, u), 1, nbits, fill_rng=rng)
    case = synthetic.make_mimo_case(seed=51, snr_db=25.0, bits=bits, **mk)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    res = serving.process(
        [prob], batch_size=2, out="decoded", modulation="qpsk", coding=coding,
        matmul_precision=None,
    )[0]
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(res.info, u)


@pytest.mark.parametrize("scramble", [False, True])
def test_decoded_on_device_matches_host_path(scramble):
    """serving.process(out='decoded', decode_on_device=True): the fully
    device-resident chain (in-graph descramble sign flips, per-bit gather
    deinterleave, rate recovery, decode) must return EXACTLY the host path's
    payloads and parity flags, with soft=None (only decoded bits cross the
    host link)."""
    code = ldpc.array_code(8, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    n_layers, n_rx = 2, 2
    seed = 5100
    mk = dict(n_rx=n_rx, modulation="16qam", scramble=scramble, n_prbs=12,
              n_layers=n_layers)
    probe = synthetic.make_mimo_case(seed=seed, snr_db=20.0, **mk)
    n_sc, n_sym = probe.data_mask.shape
    c_init = sequences.pusch_scrambling_c_init(0x4601, seed % 1024, q=0)
    coding = transport.TransportCoding(
        code=code, n_iters=30, interleave_seed=77,
        scramble_c_init=c_init if scramble else None, crc="crc16",
        early_iters=None,
    )
    lay = transport.layout(coding, probe.hop1, probe.hop2, n_sc, n_sym, n_layers, nbits)
    rng = np.random.default_rng(seed)
    k_pay = transport.payload_bits(coding, plan.k)
    u = rng.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    words = transport.crc_attach(u, "crc16")
    bits = transport.place_codewords(
        lay, ldpc.encode(code, words), n_layers, nbits, fill_rng=rng
    )
    case = synthetic.make_mimo_case(seed=seed, snr_db=20.0, bits=bits, **mk)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    kw = dict(batch_size=2, out="decoded", modulation="16qam", coding=coding,
              matmul_precision=None)
    res_h = serving.process([prob, prob], **kw)
    res_d = serving.process([prob, prob], decode_on_device=True, **kw)
    for rh, rd in zip(res_h, res_d):
        assert rd.soft is None
        assert np.array_equal(np.asarray(rd.ok), np.asarray(rh.ok))
        assert np.array_equal(rd.info, rh.info)
        assert np.array_equal(rd.info, u) and bool(np.asarray(rd.ok).all())


@pytest.mark.parametrize("tx_bits", [None, 2400])
def test_decoded_on_device_nr_rate_match(tx_bits):
    """Device-resident decode through the full TS 38.212 §5.4.2 rate-matched
    path (punctured 2Z head -> erasures, filler pinning; tx_bits=2400 > the
    1600-bit circular buffer adds REPEATS, whose device-side soft combine
    must re-saturate to the int8 range exactly like extract_streams'
    int16-accumulate-then-clip — code review r05): must match the host path
    bit-for-bit."""
    from srsran_ce.ops import nr_ldpc as nr

    code = nr.nr_base_graph(2, 32)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("qpsk")
    rnti, seed = 0x3344, 4242
    c_init = sequences.pusch_scrambling_c_init(rnti, seed % 1024)
    coding = transport.TransportCoding(
        code=code, rate_match="nr", n_filler=16, crc="crc11", n_iters=20,
        scramble_c_init=c_init, early_iters=None, tx_bits=tx_bits,
    )
    geo = synthetic.make_case(seed=seed, snr_db=22.0, n_prbs=24, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    if tx_bits is not None:
        assert lay.has_repeats  # E beyond one circular-buffer pass
    rng = np.random.default_rng(seed)
    k_pay = transport.payload_bits(coding, plan.k)
    u = rng.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    words = transport.crc_attach(u, "crc11")
    words_full = np.concatenate(
        [words, np.zeros((lay.c_words, coding.n_filler), np.uint8)], axis=1
    )
    bits = transport.place_codewords(
        lay, ldpc.encode(code, words_full), 1, nbits, fill_rng=rng
    )
    case = synthetic.make_mimo_case(
        seed=seed, n_rx=2, modulation="qpsk", scramble=True, rnti=rnti,
        bits=bits, n_prbs=24, n_layers=1, snr_db=22.0,
    )
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    kw = dict(batch_size=4, out="decoded", modulation="qpsk", coding=coding,
              matmul_precision=None)
    rh = serving.process([prob], **kw)[0]
    rd = serving.process([prob], decode_on_device=True, **kw)[0]
    assert rd.soft is None
    assert np.array_equal(rd.info, rh.info) and np.array_equal(
        np.asarray(rd.ok), np.asarray(rh.ok)
    )
    assert np.array_equal(rd.info, u) and bool(np.asarray(rd.ok).all())


def test_decoded_on_device_carries_measurement_scalars():
    """The device-resident result keeps the receiver's measurement scalars
    (a few floats; the host path exposes them via soft.*)."""
    code = ldpc.array_code(4, 8, 23)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("qpsk")
    coding = transport.TransportCoding(code=code, n_iters=12, interleave_seed=3,
                                       early_iters=None)
    geo = synthetic.make_case(seed=51, snr_db=25.0, n_prbs=12, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
    bits = transport.place_codewords(lay, ldpc.encode(code, u), 1, nbits, fill_rng=rng)
    case = synthetic.make_mimo_case(seed=51, snr_db=25.0, bits=bits, n_rx=1,
                                    modulation="qpsk", scramble=False, n_prbs=12,
                                    n_layers=1)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    kw = dict(batch_size=2, out="decoded", modulation="qpsk", coding=coding,
              matmul_precision=None)
    rd = serving.process([prob], decode_on_device=True, **kw)[0]
    rh = serving.process([prob], **kw)[0]
    assert np.array_equal(rd.info, rh.info) and np.array_equal(rd.info, u)
    for name in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        got = getattr(rd, name)
        want = getattr(rh.soft, name)
        assert got is not None and np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
