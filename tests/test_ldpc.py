"""QC-LDPC encoder/decoder tests: GF(2) validity, exactness vs the float64
numpy reference schedule, AWGN error correction + coding gain, irregular
(padded-slot) base matrices, int8 receiver-LLR input, batching."""
import numpy as np
import pytest

from srsran_ce.ops import ldpc


def _awgn_llrs(rng, code, n_words, snr_db):
    plan = ldpc.make_ldpc_plan(code)
    u = rng.integers(0, 2, (n_words, plan.k), dtype=np.uint8)
    c = ldpc.encode(code, u)
    snr = 10.0 ** (snr_db / 10.0)
    y = (1.0 - 2.0 * c) + rng.normal(0.0, np.sqrt(0.5 / snr), c.shape)
    return u, c, 4.0 * snr * y


def test_encoder_produces_valid_systematic_codewords():
    code = ldpc.array_code(3, 9, 17)
    plan = ldpc.make_ldpc_plan(code)
    h = ldpc._expand_h(code)
    assert plan.k == code.n - plan.rank
    assert plan.info_cols.size == plan.k
    assert plan.parity_cols.size == plan.rank
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, (16, plan.k), dtype=np.uint8)
    c = ldpc.encode(code, u)
    assert not np.any((c @ h.T) % 2), "encoded words must satisfy every check"
    assert np.array_equal(c[:, plan.info_cols], u), "systematic positions carry u"


def test_decoder_matches_numpy_reference_schedule():
    # Random (non-codeword) LLRs exercise every message path, including
    # unsatisfied checks; bits/ok must agree exactly with the float64 mirror.
    code = ldpc.array_code(4, 11, 13)
    rng = np.random.default_rng(2)
    llr = rng.normal(0.0, 3.0, (6, code.n))
    dec = ldpc.build_decoder(code, n_iters=8)
    res = dec(llr)
    rb, rok, rpost = ldpc.decode_reference(code, llr, n_iters=8)
    assert np.array_equal(np.asarray(res.bits), rb)
    assert np.array_equal(np.asarray(res.ok), rok)
    np.testing.assert_allclose(np.asarray(res.posterior), rpost, rtol=0, atol=1e-6)


def test_irregular_base_matrix_padded_slots():
    # -1 entries give rows of unequal degree -> padded check slots; the padded
    # path must emit zeros and still match the reference exactly.
    base = (
        (0, 2, -1, 1, -1, 0),
        (-1, 1, 0, -1, 3, 0),
        (2, -1, 1, 0, -1, -1),
    )
    code = ldpc.QCLdpcCode(base=base, z=5)
    plan = ldpc.make_ldpc_plan(code)
    assert plan.max_degree == 4 and not plan.slot_valid.all()
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, (4, plan.k), dtype=np.uint8)
    c = ldpc.encode(code, u)
    assert not np.any((c @ ldpc._expand_h(code).T) % 2)
    llr = rng.normal(0.0, 2.0, (4, code.n))
    res = ldpc.build_decoder(code, n_iters=6)(llr)
    rb, rok, _ = ldpc.decode_reference(code, llr, n_iters=6)
    assert np.array_equal(np.asarray(res.bits), rb)
    assert np.array_equal(np.asarray(res.ok), rok)


def test_awgn_correction_and_coding_gain():
    code = ldpc.array_code(3, 8, 53)  # n=424, k~271, rate ~0.64
    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(4)
    u, c, llr = _awgn_llrs(rng, code, 24, snr_db=4.0)
    hard_errs = int(np.sum((llr < 0) != c))
    assert hard_errs > 0, "SNR chosen so the uncoded channel makes errors"
    res = ldpc.build_decoder(code, n_iters=30)(llr)
    assert bool(np.asarray(res.ok).all()), "all words must converge at 4 dB"
    assert np.array_equal(np.asarray(res.info), u), "decoded payload must be exact"
    assert np.array_equal(np.asarray(res.bits), c)


def test_ok_flag_false_on_garbage():
    code = ldpc.array_code(3, 8, 13)
    rng = np.random.default_rng(5)
    llr = rng.normal(0.0, 1.0, (8, code.n))  # pure noise, not codewords
    res = ldpc.build_decoder(code, n_iters=4)(llr)
    rb, rok, _ = ldpc.decode_reference(code, llr, n_iters=4)
    assert np.array_equal(np.asarray(res.ok), rok)
    assert not np.asarray(res.ok).all(), "noise should not all pass parity in 4 iters"


def test_int8_llrs_from_receiver_decode():
    # The fused receiver emits int8 soft bits (round(llr*scale) clip +-127);
    # min-sum is scale-invariant so they feed the decoder directly.
    code = ldpc.array_code(3, 8, 53)
    rng = np.random.default_rng(6)
    u, c, llr = _awgn_llrs(rng, code, 8, snr_db=5.0)
    q = np.clip(np.round(llr * 4.0), -127, 127).astype(np.int8)
    res = ldpc.build_decoder(code, n_iters=30)(q)
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(np.asarray(res.info), u)


def test_leading_batch_axes_and_cache():
    code = ldpc.array_code(2, 6, 11)
    plan = ldpc.make_ldpc_plan(code)
    assert ldpc.make_ldpc_plan(code) is plan, "plan must be cached per code"
    dec = ldpc.build_decoder(code, n_iters=3)
    rng = np.random.default_rng(7)
    llr = rng.normal(0.0, 2.0, (2, 3, code.n))
    res = dec(llr)
    assert res.bits.shape == (2, 3, code.n)
    assert res.info.shape == (2, 3, plan.k)
    assert res.ok.shape == (2, 3)
    flat = dec(llr.reshape(6, code.n))
    assert np.array_equal(np.asarray(res.bits).reshape(6, -1), np.asarray(flat.bits))


def test_array_code_validation():
    with pytest.raises(AssertionError):
        ldpc.array_code(3, 8, 12)  # z not prime
    with pytest.raises(AssertionError):
        ldpc.array_code(9, 8, 13)  # more check than var blocks


def test_coded_link_end_to_end():
    """Full coded uplink chain (validation/quality.coded_ber_sweep): LDPC
    codewords -> interleave -> scramble -> 16QAM -> 2x2 MIMO channel + CFO +
    AWGN -> estimate -> joint MMSE -> fused int8 demap -> descramble ->
    min-sum decode. At 20 dB the raw channel still makes errors; the decoder
    must deliver an error-free payload with every parity check passing."""
    from srsran_ce.validation import quality

    t = quality.coded_ber_sweep(snrs_db=(20.0,), n_cases=2, n_prbs=12)[20.0]
    assert t["uncoded_ber"] > 5e-3, t  # the code has real work to do
    assert t["coded_ber"] == 0.0, t
    assert t["coded_bler"] == 0.0, t
    assert t["parity_ok_frac"] == 1.0, t


def test_dp_sharded_decode_matches_unsharded():
    """parallel.build_dp_decoder: codewords dp-shard with zero collectives;
    the sharded decode must equal the single-device decode bitwise."""
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.data_parallel import build_dp_decoder

    mesh = mesh_lib.make_mesh((8,), ("dp",))
    code = ldpc.array_code(3, 8, 53)
    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(12)
    u = rng.integers(0, 2, (16, plan.k), dtype=np.uint8)
    c = ldpc.encode(code, u)
    snr = 10.0**0.4
    llr = (4 * snr * ((1 - 2.0 * c) + rng.normal(0, np.sqrt(0.5 / snr), c.shape))).astype(
        np.float32
    )
    res = build_dp_decoder(code, mesh, n_iters=25)(llr)
    ref = ldpc.build_decoder(code, n_iters=25)(llr)
    assert np.array_equal(np.asarray(res.bits), np.asarray(ref.bits))
    assert np.array_equal(np.asarray(res.ok), np.asarray(ref.ok))
    assert len(res.bits.sharding.device_set) == 8
    assert np.array_equal(np.asarray(res.info), u)


def test_load_base_graph_json(tmp_path):
    import json

    base = [[0, 2, -1, 1, -1, 0], [-1, 1, 0, -1, 3, 0], [2, -1, 1, 0, -1, -1]]
    p = tmp_path / "bg.json"
    p.write_text(json.dumps({"base": base}))
    code = ldpc.load_base_graph(p, z=5)
    assert code == ldpc.QCLdpcCode(base=tuple(tuple(r) for r in base), z=5)
    # shifts reduce mod z (the TS 38.212 lifting rule)
    p.write_text(json.dumps([[7, 12], [-1, 6]]))
    code = ldpc.load_base_graph(p, z=5)
    assert code.base == ((2, 2), (-1, 1))


def test_early_termination_serving_equivalence():
    """Two-phase serving decode (early_iters) must deliver the same payloads
    as the single full pass on a decodable link, and still rerun failures."""
    from srsran_ce import serving, transport
    from srsran_ce.ops import demap
    from srsran_ce.utils import synthetic

    code = ldpc.array_code(8, 16, 61)
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol("16qam")
    mk = dict(n_rx=2, modulation="16qam", scramble=False, n_prbs=12, n_layers=2)
    probe = synthetic.make_mimo_case(seed=5100, snr_db=20.0, **mk)
    n_sc, n_sym = probe.data_mask.shape
    base = dict(code=code, n_iters=30, interleave_seed=3)
    lay = transport.layout(
        transport.TransportCoding(**base), probe.hop1, probe.hop2, n_sc, n_sym, 2, nbits
    )
    rng = np.random.default_rng(5100)
    u = rng.integers(0, 2, (lay.c_words, plan.k), dtype=np.uint8)
    bits = transport.place_codewords(lay, ldpc.encode(code, u), 2, nbits, fill_rng=rng)
    case = synthetic.make_mimo_case(seed=5100, snr_db=20.0, bits=bits, **mk)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    kw = dict(batch_size=4, out="decoded", modulation="16qam", matmul_precision=None)
    r_two = serving.process(
        [prob], coding=transport.TransportCoding(**base, early_iters=4), **kw
    )[0]
    r_one = serving.process(
        [prob], coding=transport.TransportCoding(**base, early_iters=None), **kw
    )[0]
    assert bool(np.asarray(r_two.ok).all()) and bool(np.asarray(r_one.ok).all())
    assert np.array_equal(r_two.info, u) and np.array_equal(r_one.info, u)


def test_layered_schedule_matches_reference_and_converges_faster():
    """schedule='layered' (plain-XLA row walk): vs its float64 numpy mirror,
    and strictly-no-worse convergence than flooding at equal sweep counts
    (the classic layered property: later rows see fresher beliefs, ~2x fewer
    sweeps for the same BER)."""
    code = ldpc.array_code(3, 8, 13)
    rng = np.random.default_rng(21)
    llr = rng.normal(0, 2.5, (6, code.n)).astype(np.float32)
    p = ldpc.build_decoder(code, n_iters=5, schedule="layered")(llr)
    rb, rok, rpost = ldpc.decode_reference(code, llr, n_iters=5, schedule="layered")
    assert np.array_equal(np.asarray(p.bits), rb)
    assert np.array_equal(np.asarray(p.ok), rok)
    np.testing.assert_allclose(np.asarray(p.posterior), rpost, rtol=0, atol=1e-5)

    code2 = ldpc.array_code(3, 8, 53)
    plan2 = ldpc.make_ldpc_plan(code2)
    u = rng.integers(0, 2, (64, plan2.k), dtype=np.uint8)
    c = ldpc.encode(code2, u)
    snr = 10.0 ** 0.2  # 2 dB: near threshold, few sweeps don't finish everything
    llr2 = (4 * snr * ((1 - 2.0 * c) + rng.normal(0, np.sqrt(0.5 / snr), c.shape))).astype(np.float32)
    ok_f = int(np.asarray(ldpc.build_decoder(code2, n_iters=3)(llr2).ok).sum())
    ok_l = int(np.asarray(
        ldpc.build_decoder(code2, n_iters=3, schedule="layered")(llr2).ok
    ).sum())
    assert ok_l >= ok_f, (ok_l, ok_f)
    assert ok_l > 48, ok_l  # layered at 3 sweeps already converges most words


def test_flooding_irregular_code_matches_reference():
    """The gather/scatter-add flooding decoder on an irregular code (padded
    slots exercised): posterior to float tolerance (scatter-add
    association), bits/ok exactly, and a clean decode roundtrip."""
    base = (
        (0, 2, -1, 1, -1, 0),
        (-1, 1, 0, -1, 3, 0),
        (2, -1, 1, 0, -1, -1),
    )
    code = ldpc.QCLdpcCode(base=base, z=7)
    rng = np.random.default_rng(5)
    llr = rng.normal(0.0, 2.5, (6, code.n))
    res = ldpc.build_decoder(code, n_iters=7)(llr)
    rb, rok, rpost = ldpc.decode_reference(code, llr, n_iters=7)
    np.testing.assert_allclose(np.asarray(res.posterior), rpost, rtol=1e-5, atol=1e-5)
    assert np.array_equal(np.asarray(res.bits), rb)
    assert np.array_equal(np.asarray(res.ok), rok)
    plan = ldpc.make_ldpc_plan(code)
    u = rng.integers(0, 2, (4, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    llr2 = 8.0 * (1.0 - 2.0 * cw) + rng.normal(0, 0.6, cw.shape)
    res = ldpc.build_decoder(code, n_iters=10, kernels="auto")(llr2)
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(np.asarray(res.info), u)


def test_auto_tier_selects_gather_for_huge_codes():
    """NR BG1 at Z=384 under kernels='auto' (flooding: the O(1)-program
    gather formulation) must actually decode: a few sweeps on a codeword
    prove it compiles and runs end to end on the CPU."""
    from srsran_ce.ops import nr_ldpc

    code = nr_ldpc.nr_base_graph(1, 384)
    assert ldpc.select_tier("auto", "flooding", "cpu") == "xla"
    rng = np.random.default_rng(11)
    plan = ldpc.make_ldpc_plan(code)
    u = rng.integers(0, 2, (2, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    llr = 9.0 * (1.0 - 2.0 * cw) + rng.normal(0, 0.4, cw.shape)
    dec = ldpc.build_decoder(code, n_iters=3, kernels="auto")
    res = dec(llr.astype(np.float32))
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(np.asarray(res.info), u)




# ---------------------------------------------------------------------------
# Layered decoding: the plain-XLA row walk and the Triton kernel (interpreted)
# ---------------------------------------------------------------------------

_IRREGULAR = ((0, 2, -1, 1, -1, 0), (-1, 1, 0, -1, 3, 0), (2, -1, 1, 0, -1, -1))


def _layered_code(name):
    from srsran_ce.ops import nr_ldpc

    return {
        "array": lambda: ldpc.array_code(3, 8, 13),
        "irregular": lambda: ldpc.QCLdpcCode(base=_IRREGULAR, z=5),
        "nr_bg2": lambda: nr_ldpc.nr_base_graph(2, 16),
    }[name]()


def _noisy_codewords(code, n_words, seed, snr_db=3.5):
    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (n_words, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    snr = 10.0 ** (snr_db / 10)
    llr = 4 * snr * ((1 - 2.0 * cw) + rng.normal(0, np.sqrt(0.5 / snr), cw.shape))
    return u, llr.astype(np.float32)


def _batch_last(code, llr):
    import jax.numpy as jnp

    b = llr.shape[0]
    return jnp.transpose(jnp.asarray(llr).reshape(b, code.n_var_blocks, code.z), (1, 2, 0))


@pytest.mark.parametrize("c2v", [None, "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("name", ["array", "irregular", "nr_bg2"])
def test_layered_xla_matches_reference(name, group, c2v):
    """The plain-XLA layered walk follows decode_reference(schedule='layered')
    for every row grouping (3 does not divide every row count: padded rows)
    and message dtype: identical hard decisions and parity, posterior to
    float32 rounding (bf16 messages are rounded identically on both sides)."""
    code = _layered_code(name)
    if name == "nr_bg2":  # near-codeword input: random LLRs leave posteriors
        _, llr = _noisy_codewords(code, 6, seed=7)  # at 0 where f32/f64 split
    else:  # random LLRs exercise unsatisfied checks on the small codes
        llr = np.random.default_rng(7).normal(0.0, 2.5, (6, code.n)).astype(np.float32)
    res = ldpc.build_decoder(
        code, n_iters=5, schedule="layered", layered_group=group, stream_c2v_dtype=c2v
    )(llr)
    rb, rok, rpost = ldpc.decode_reference(
        code, llr, n_iters=5, schedule="layered", layered_group=group, c2v_dtype=c2v
    )
    assert np.array_equal(np.asarray(res.bits), rb)
    assert np.array_equal(np.asarray(res.ok), rok)
    scale = np.abs(rpost).max()
    assert np.abs(np.asarray(res.posterior, np.float64) - rpost).max() / scale < 1e-5


@pytest.mark.parametrize("c2v", [None, "bfloat16"])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("name", ["irregular", "nr_bg2"])
def test_triton_kernel_interpreted_matches_xla_walk(name, group, c2v):
    """The Triton layered kernel, run by the Pallas interpreter, gives the
    plain-XLA walk's posterior bit for bit (same row order, tie rule,
    message rounding and update association)."""
    from srsran_ce.ops import ldpc_triton

    code = _layered_code(name)
    plan = ldpc.make_ldpc_plan(code)
    _, llr = _noisy_codewords(code, 5, seed=13)
    walk = ldpc.build_decoder(
        code, n_iters=4, schedule="layered", layered_group=group, stream_c2v_dtype=c2v
    )(llr)
    post = ldpc_triton.layered_posterior(
        _batch_last(code, llr), plan.slot_var, plan.slot_shift, plan.slot_valid, 4, 0.75,
        group=group, c2v_dtype=c2v, interpret=True,
    )
    got = np.transpose(np.asarray(post), (2, 0, 1)).reshape(llr.shape)
    np.testing.assert_array_equal(got, np.asarray(walk.posterior))


def test_triton_kernel_pads_batch_to_whole_tiles(monkeypatch):
    """A batch that is not a multiple of the codeword tile pads internally and
    slices back: same posterior as the walk for every real codeword."""
    from srsran_ce.ops import ldpc_triton

    monkeypatch.setattr(ldpc_triton, "TARGET_PROGRAMS", 2)  # 9 words -> BT=4, 3 tiles
    code = _layered_code("irregular")
    plan = ldpc.make_ldpc_plan(code)
    assert ldpc_triton.tiling(9, code.z, plan.max_degree)[0] == 4
    _, llr = _noisy_codewords(code, 9, seed=17)
    walk = ldpc.build_decoder(code, n_iters=3, schedule="layered")(llr)
    post = ldpc_triton.layered_posterior(
        _batch_last(code, llr), plan.slot_var, plan.slot_shift, plan.slot_valid, 3, 0.75,
        interpret=True,
    )
    assert post.shape == (code.n_var_blocks, code.z, 9)
    got = np.transpose(np.asarray(post), (2, 0, 1)).reshape(llr.shape)
    np.testing.assert_array_equal(got, np.asarray(walk.posterior))


@pytest.mark.parametrize(
    "batch,z,d,want",
    [
        (32, 384, 19, (1, 64, 32)),  # few words: one per program, 64-lane chunks
        (512, 61, 16, (4, 32, 16)),  # many words: 4 per program -> 128 programs
        (128, 208, 10, (1, 128, 16)),
        (4096, 5, 4, (16, 8, 4)),  # tile capped at MAX_BT; chunk capped at pow2(z)
    ],
)
def test_triton_kernel_tiling(batch, z, d, want):
    from srsran_ce.ops import ldpc_triton

    bt, zb, dp = ldpc_triton.tiling(batch, z, d)
    assert (bt, zb, dp) == want
    assert dp >= d and zb * bt * dp <= ldpc_triton.BLOCK_ELEMS


def test_triton_kernel_tables():
    """Wiring tables: rows pad to whole groups, slots to the power-of-two DP;
    pads are invalid and point at the dummy edge; real edges are numbered
    row-major, matching the plan's edge list."""
    from srsran_ce.ops import ldpc_triton

    code = _layered_code("irregular")  # 3 rows of degree 4,4,4 (d = 4)
    plan = ldpc.make_ldpc_plan(code)
    tbl = ldpc_triton.kernel_tables(
        plan.slot_var, plan.slot_shift, plan.slot_valid, code.z, group=2, dp=8
    )
    var_off, shift, eid, valid = tbl
    assert tbl.shape == (4, 4, 8) and tbl.dtype == np.int32
    n_edges = len(plan.edges)
    assert not valid[3].any() and not valid[:, 4:].any()
    assert (eid[valid == 0] == n_edges).all()
    for e, (i, t, j, s) in enumerate(plan.edges):
        assert valid[i, t] and eid[i, t] == e
        assert var_off[i, t] == j * code.z and shift[i, t] == s % code.z


def test_triton_kernel_refuses_cpu_without_interpret():
    import jax

    from srsran_ce.ops import ldpc_triton

    assert jax.default_backend() == "cpu"
    code = _layered_code("irregular")
    plan = ldpc.make_ldpc_plan(code)
    _, llr = _noisy_codewords(code, 2, seed=1)
    with pytest.raises(ValueError, match="only for a GPU"):
        ldpc_triton.layered_posterior(
            _batch_last(code, llr), plan.slot_var, plan.slot_shift, plan.slot_valid, 2, 0.75
        )
    with pytest.raises(ValueError, match="only for a GPU"):
        ldpc.build_decoder(code, n_iters=2, kernels="triton", schedule="layered")(llr)


def test_triton_tier_is_layered_only():
    with pytest.raises(ValueError, match="layered"):
        ldpc.build_decoder(_layered_code("array"), n_iters=2, kernels="triton")


@pytest.mark.parametrize(
    "backend,layered,flooding",
    [("cpu", "xla", "xla"), ("gpu", "triton", "xla"), ("rocm", None, None)],
)
def test_auto_choice_per_backend(monkeypatch, backend, layered, flooding):
    """kernels='auto' picks by backend: the plain walk on the CPU, the
    measured winner on a GPU, and refuses any other backend."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    code = _layered_code("array")
    if layered is None:
        with pytest.raises(ValueError, match="no LDPC decoder tier"):
            ldpc.layered_tier(backend)
        with pytest.raises(ValueError, match="no LDPC decoder tier"):
            ldpc.build_decoder.__wrapped__(code, kernels="auto")
        return
    assert ldpc.layered_tier(backend) == layered
    assert ldpc.select_tier("auto", "layered", backend) == layered
    assert ldpc.select_tier("auto", "flooding", backend) == flooding


def test_layered_huge_code_end_to_end():
    """BG1 Z=384 (n=26112, the largest NR code block) through the plain-XLA
    layered walk — payload-exact at moderate SNR with bf16 messages, the
    configuration the decoded serving chain runs."""
    from srsran_ce.ops import nr_ldpc

    code = nr_ldpc.nr_base_graph(1, 384)
    u, llr = _noisy_codewords(code, 4, seed=4)
    res = ldpc.build_decoder(
        code, n_iters=8, schedule="layered", stream_c2v_dtype="bfloat16"
    )(llr)
    assert bool(np.asarray(res.ok).all())
    assert np.array_equal(np.asarray(res.info), u)


@pytest.mark.parametrize("kernels", ["xla", "triton"])
def test_explicit_tier_passes_through(kernels):
    """An explicitly named tier is used as named, on any backend."""
    for backend in ("cpu", "gpu"):
        for schedule in ("flooding", "layered"):
            assert ldpc.select_tier(kernels, schedule, backend) == kernels
