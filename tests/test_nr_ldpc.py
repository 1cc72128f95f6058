"""TS 38.212 NR LDPC chain: lifting/segmentation tables, NR-structured base
graphs (full-rank, structured O(edges*z) encoder), and §5.4.2 rate matching
(bit selection per rv, filler skip, Qm bit interleaver), plus the transport
integration (rate_match="nr" layouts, repeat combining, filler priors).

Spec-exactness split documented in ops/nr_ldpc.py: tables/selection/rate
matching follow TS 38.212; the base-graph SHIFT VALUES are structured
stand-ins (official Tables 5.3.2-2/-3 drop in via nr_base_graph(shifts=...)).
"""
import numpy as np
import pytest

from srsran_ce.ops import ldpc, nr_ldpc as nr


def _syndrome_ok(code, cw):
    """Block-roll parity identity — validates encode without expanding H."""
    z = code.z
    c = cw.reshape(cw.shape[0], code.n_var_blocks, z)
    for row in code.base:
        acc = np.zeros((cw.shape[0], z), np.uint8)
        for j, s in enumerate(row):
            if s >= 0:
                acc ^= np.roll(c[:, j], -s, axis=-1)
        if acc.any():
            return False
    return True


def test_lifting_table():
    zs = nr.lifting_sizes()
    assert len(zs) == 51 and zs[0] == 2 and zs[-1] == 384
    # Table 5.3.2-1: every Z is a * 2^j with a in the 8 set leads
    for i, s in enumerate(nr.LIFTING_SETS):
        a = s[0]
        assert all(z == a * (2**j) for j, z in enumerate(s))
        for z in s:
            assert nr.lifting_set_index(z) == i
    with pytest.raises(ValueError):
        nr.lifting_set_index(17)


def test_base_graph_selection():
    # §7.2.2 thresholds
    assert nr.select_base_graph(292, 0.9) == 2
    assert nr.select_base_graph(293, 0.9) == 1
    assert nr.select_base_graph(3824, 0.67) == 2
    assert nr.select_base_graph(3825, 0.67) == 1
    assert nr.select_base_graph(10000, 0.25) == 2
    assert nr.select_base_graph(10000, 0.26) == 1


def test_lifting_selection_and_segmentation():
    assert nr.select_lifting_size(1, 8448) == 384  # largest BG1 block exactly
    assert nr.select_lifting_size(2, 10 * 384) == 384
    # kb steps for BG2 (§5.2.2): K' <= 192 -> kb = 6
    assert nr.select_lifting_size(2, 96) == 16
    assert nr.select_lifting_size(2, 100) == 18
    assert nr.select_lifting_size(1, 100) == 5  # 22 * 5 >= 100
    c, kp = nr.segment_payload(8448, 1)
    assert (c, kp) == (1, 8448)
    c, kp = nr.segment_payload(8449, 1)
    assert c == 2 and kp == -(-8449 // 2) + 24
    c, kp = nr.segment_payload(3840, 2)
    assert (c, kp) == (1, 3840)


@pytest.mark.parametrize("bg,z", [(1, 384), (2, 208), (1, 52), (2, 16)])
def test_structured_encode_full_rank(bg, z):
    code = nr.nr_base_graph(bg, z)
    plan = ldpc.make_ldpc_plan(code)
    mb, nbv, kb = nr.base_graph_params(bg)
    assert plan.nr_structure is not None, "NR structure must be detected"
    assert plan.k == (nbv - mb) * z
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, (4, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    assert _syndrome_ok(code, cw)
    assert np.array_equal(cw[:, : plan.k], u)  # systematic prefix


def test_structured_encode_matches_dense_path():
    """The structured encoder and the generic GF(2)-elimination encoder define
    the same code: dense H of the small graph annihilates structured words."""
    code = nr.nr_base_graph(2, 10)
    plan = ldpc.make_ldpc_plan(code)
    h = ldpc._expand_h(code)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, (16, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    assert not ((h @ cw.T) % 2).any()


@pytest.mark.parametrize("bg,z,qm", [(1, 26, 4), (2, 52, 2)])
def test_rate_match_round_trip(bg, z, qm):
    """Encode -> §5.4.2 bit selection + interleave -> AWGN -> de-rate-match
    -> decode recovers the payload exactly; fillers/puncture honored."""
    code = nr.nr_base_graph(bg, z)
    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(3)
    n_filler = z // 2
    u = rng.integers(0, 2, (8, plan.k), dtype=np.uint8)
    u[:, plan.k - n_filler :] = 0
    cw = ldpc.encode(code, u)
    e = ((code.n - 2 * z - n_filler) // qm) * qm
    dec = ldpc.build_decoder(code, n_iters=25)
    for rv in (0, 2):
        rm = nr.make_rate_match(bg, z, code.n_var_blocks, e, qm=qm, rv=rv, n_filler=n_filler)
        assert not np.isin(rm.filler_pos, rm.tx_sel).any()  # fillers never sent
        assert rm.tx_sel.min() >= 2 * z  # 2Z puncture
        tx = cw[np.arange(8)[:, None], rm.tx_sel[None, :]].astype(np.float64)
        llr = 7.0 * (1 - 2 * tx) + rng.normal(0, 0.8, tx.shape)
        full = np.zeros((8, code.n), np.float32)
        np.add.at(full, (np.arange(8)[:, None], rm.tx_sel[None, :]), llr)
        full[:, rm.filler_pos] = 100.0
        r = dec(full)
        assert np.array_equal(np.asarray(r.info), u)


def test_rate_match_k0_and_interleaver():
    # rv starting points are distinct, ordered, and multiples of Z (§5.4.2.1)
    z = 96
    starts = [nr.make_rate_match(1, z, 68, 8 * z, qm=2, rv=rv).tx_sel[0] for rv in range(4)]
    assert len(set(starts)) == 4 and starts == sorted(starts)
    assert all((s - 2 * z) % z == 0 for s in starts)
    # §5.4.2.2 interleaver: f_{i+j*Qm} = e_{i*(E/Qm)+j}
    rm = nr.make_rate_match(1, 16, 68, 128, qm=8, rv=0)
    e_seq = rm.tx_sel  # = sel[il]
    rm_qm1 = nr.make_rate_match(1, 16, 68, 128, qm=1, rv=0)
    sel = rm_qm1.tx_sel  # qm=1 => identity interleave
    rows = 128 // 8
    for k in range(128):
        assert e_seq[k] == sel[(k % 8) * rows + k // 8]


def test_rate_match_repetition():
    """E beyond one buffer pass wraps (repetition); duplicates are real."""
    code = nr.nr_base_graph(2, 16)
    z = 16
    e = ((code.n - 2 * z) // 2) * 2 * 2  # two full passes
    rm = nr.make_rate_match(2, z, 52, e, qm=2, rv=0)
    u_pos, counts = np.unique(rm.tx_sel, return_counts=True)
    assert counts.max() >= 2


def test_transport_nr_mode_end_to_end():
    """rate_match="nr" through the transport layout: place -> extract restores
    per-codeword LLR streams with filler priors pinned and puncture erased."""
    from srsran_ce import transport
    from srsran_ce.utils import synthetic

    code = nr.nr_base_graph(2, 32)
    plan = ldpc.make_ldpc_plan(code)
    z = 32
    n_filler = 16
    case = synthetic.make_mimo_case(seed=11, n_rx=1, modulation="qpsk", n_prbs=24)
    n_sc, n_sym = case.data_mask.shape
    coding = transport.TransportCoding(
        code=code, rate_match="nr", n_filler=n_filler, crc="crc11"
    )
    nbits = 2
    lay = transport.layout(coding, case.hop1, case.hop2, n_sc, n_sym, 1, nbits)
    assert lay.filler_pos is not None and lay.tx_bits % nbits == 0
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (lay.c_words, transport.payload_bits(coding, plan.k)), np.uint8)
    words = transport.crc_attach(u, "crc11")
    words_full = np.concatenate(
        [words, np.zeros((lay.c_words, n_filler), np.uint8)], axis=1
    )
    cw = ldpc.encode(code, words_full)
    bits = transport.place_codewords(lay, cw, 1, nbits, fill_rng=rng)
    # ideal LLRs from the placed bits
    llr = ((1 - 2.0 * bits) * 20.0).astype(np.float32)
    streams = transport.extract_streams(lay, llr)
    assert (streams[:, lay.filler_pos] > 0).all()  # filler prior positive
    assert (streams[:, : 2 * z] == 0).all()  # punctured head erased
    dec = ldpc.build_decoder(code, n_iters=20)
    r = dec(streams)
    info = np.asarray(r.info)
    k_eff = plan.k - n_filler
    assert transport.crc_check(info[:, :k_eff], "crc11").all()
    assert np.array_equal(info[:, : u.shape[1]], u)


def test_payload_bits_accounts_fillers():
    from srsran_ce import transport

    code = nr.nr_base_graph(2, 16)
    plan = ldpc.make_ldpc_plan(code)
    c = transport.TransportCoding(code=code, rate_match="nr", n_filler=10, crc="crc16")
    assert transport.payload_bits(c, plan.k) == plan.k - 10 - 16
    bad = transport.TransportCoding(code=code, rate_match="nr", n_filler=plan.k, crc=None)
    with pytest.raises(ValueError):
        transport.payload_bits(bad, plan.k)


def test_nr_layout_rejects_bad_tx_bits():
    """User-supplied tx_bits in rate_match='nr' must be validated in layout()
    (a bare assert downstream vanishes under python -O; tx_bits<=0 would hit a
    ZeroDivisionError)."""
    from srsran_ce import transport
    from srsran_ce.utils import synthetic

    code = nr.nr_base_graph(2, 16)
    case = synthetic.make_mimo_case(seed=3, n_rx=1, modulation="qpsk", n_prbs=12)
    n_sc, n_sym = case.data_mask.shape
    for bad in (0, -4, 33):  # 33 is not a multiple of Qm=2
        coding = transport.TransportCoding(code=code, rate_match="nr", tx_bits=bad)
        with pytest.raises(ValueError):
            transport.layout(coding, case.hop1, case.hop2, n_sc, n_sym, 1, 2)


def test_official_table_loader_roundtrip(tmp_path):
    """The official-table data-drop hook: export a base-graph family in the
    printed Table 5.3.2-2/-3 layout (one entry per edge, V per lifting set),
    reload at several Z, and encode/decode through the loaded code. Running
    the same loader over the real 3GPP JSON is bit-exact conformance with zero
    code changes."""
    import json

    import numpy as np

    path = tmp_path / "bg2_table.json"
    path.write_text(json.dumps(nr.export_base_graph_entries(2)))
    for z in (16, 48, 208):
        got = nr.load_official_base_graph(path, z, strict=False)
        want = nr.nr_base_graph(2, z)
        assert got == want, z
    code = nr.load_official_base_graph(path, 32, strict=False)
    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(9)
    u = rng.integers(0, 2, (4, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    llr = 8.0 * (1.0 - 2.0 * cw) + rng.normal(0, 0.5, cw.shape)
    res = ldpc.build_decoder(code, n_iters=12)(llr)
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(np.asarray(res.info), u)


def test_official_table_validation_gate(tmp_path):
    """Strict mode must reject tables whose edge counts differ from the
    published 316/197 (the stand-in's do — by design it is NOT passed off as
    official data), and structural corruption must fail loudly."""
    import json

    path = tmp_path / "bg1_table.json"
    path.write_text(json.dumps(nr.export_base_graph_entries(1)))
    with pytest.raises(ValueError, match="official tables have 316"):
        nr.load_official_base_graph(path, 384, strict=True)
    # structural corruption: break the double-diagonal staircase
    raw = json.loads(path.read_text())
    kb = 22
    raw["entries"] = [
        e for e in raw["entries"] if not (e[0] == 1 and e[1] == kb + 1)
    ]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="encoding structure"):
        nr.load_official_base_graph(bad, 384, strict=False)
    # wrong dimensions
    with pytest.raises(ValueError, match="blocks"):
        nr.validate_nr_base_graph(nr.nr_base_graph(2, 16), 1, strict=False)


def test_official_table_cross_format(tmp_path):
    """The two accepted drop formats — the printed `entries` layout (one row
    per edge with the 8-vector of per-lifting-set shifts) and a dense `shifts`
    (m_b, n_b) single-set table — must produce IDENTICAL codes and identical
    encodes for the same graph, so whoever transcribes the official tables can
    use either and cross-check one against the other."""
    import json

    import numpy as np

    raw = nr.export_base_graph_entries(2)
    p_entries = tmp_path / "entries.json"
    p_entries.write_text(json.dumps(raw))
    for z in (16, 104, 208):
        ils = nr.lifting_set_index(z)
        mb, nbv, _ = nr.base_graph_params(2)
        dense = np.full((mb, nbv), -1, np.int64)
        for i, j, vs in raw["entries"]:
            dense[i, j] = vs[ils]
        p_dense = tmp_path / f"dense_{z}.json"
        p_dense.write_text(json.dumps({"bg": 2, "shifts": dense.tolist()}))
        c_e = nr.load_official_base_graph(p_entries, z, strict=False)
        c_d = nr.load_official_base_graph(p_dense, z, strict=False)
        assert c_e == c_d, z
        plan = ldpc.make_ldpc_plan(c_e)
        rng = np.random.default_rng(z)
        u = rng.integers(0, 2, (2, plan.k), dtype=np.uint8)
        assert np.array_equal(ldpc.encode(c_e, u), ldpc.encode(c_d, u)), z


def test_official_table_corrupted_indices(tmp_path):
    """Corrupted (i, j) indices or malformed shift vectors must fail loudly
    BEFORE table assembly — negative indices would otherwise wrap via numpy
    into a different (valid-looking) edge."""
    import json

    base = nr.export_base_graph_entries(2)
    for mutate, match in (
        (lambda e: e[5].__setitem__(0, -3), "outside"),
        (lambda e: e[5].__setitem__(1, 99), "outside"),
        (lambda e: e[5].__setitem__(2, e[5][2][:5]), "shift values"),
        (lambda e: e.append(list(e[5])), "duplicate"),
    ):
        raw = json.loads(json.dumps(base))
        mutate(raw["entries"])
        p = tmp_path / "bad.json"
        p.write_text(json.dumps(raw))
        with pytest.raises(ValueError, match=match):
            nr.load_official_base_graph(p, 52, strict=False)
