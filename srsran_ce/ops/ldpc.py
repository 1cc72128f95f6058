"""Batched QC-LDPC soft decoder (normalized min-sum) + GF(2) systematic encoder.

Completes the coded uplink chain past the reference's endpoint: the reference
stops at the channel estimate (ce_rule_baseline.py:761-768); this framework
already adds MMSE equalization (ops/equalize) and exact max-log LLRs
(ops/demap), and here those soft bits are actually *decoded*. The decoder is
the standard flooding normalized-min-sum over a quasi-cyclic parity-check
matrix — the code family used by 5G NR PUSCH (TS 38.212 §5.3.2) — with a
row-layered schedule beside it:

- **Plan-time staticization** (same principle as models/plan.py): the entire
  Tanner-graph wiring — edge tables, cyclic shifts, check-node slot padding,
  the GF(2)-eliminated systematic encoder — is computed once in numpy from
  the (base matrix, lifting size) pair; one code = one compiled program.
- **Batch-last check-frame layout** `(n_checks_base, max_degree, Z, batch)`:
  the BATCH of codewords is the contiguous axis; the whole check frame is
  read through one precomputed-index gather (every quasi-cyclic shift folded
  into the index table) and written back by one scatter-add. Messages never
  exist "per edge scalar" — every op is an elementwise or a small-axis
  reduction over the whole batch; there is no per-node work, no sparse
  matrices, no data-dependent control flow.
- **Static iteration count** via `lax.scan` (the XLA-friendly schedule; a
  data-dependent early-exit would force `while_loop` and kill cross-iteration
  fusion). The returned `ok` flag reports the final parity check, so callers
  get the early-termination *signal* without the dynamic control flow.

The code is described by its base matrix (entries: -1 = no edge, s >= 0 =
identity cyclically shifted by s) and lifting size Z, exactly the TS 38.212
representation — NR base graphs drop in as literal shift tables. Since those
spec tables are not bundled, `array_code` provides the
classic Fossorier array-LDPC construction (shift[i][j] = i*j mod Z, Z prime,
girth >= 6) as a strong built-in family for tests and link-level evaluation.

Conventions match ops/demap: LLR > 0 means bit 0 likelier (3GPP soft-bit
sign), so hard decisions are `posterior < 0`. int8 LLRs from the fused
receiver demap feed straight in (cast to float; min-sum is scale-invariant so
the int8 quantization scale does not even need to be undone).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "QCLdpcCode",
    "array_code",
    "LdpcPlan",
    "make_ldpc_plan",
    "encode",
    "build_decoder",
    "decode_reference",
    "layered_tier",
    "select_tier",
    "DecodeResult",
]

_BIG = 1e30  # mask value for padded check-node slots (never wins a min)


@dataclass(frozen=True)
class QCLdpcCode:
    """A quasi-cyclic LDPC code: `base[i][j]` is -1 (no block) or a cyclic
    shift in [0, z); the parity-check matrix is the base matrix with every
    entry s expanded to the ZxZ identity rolled so row a has its one at
    column (a + s) mod z. Frozen + hashable -> plan/jit cache key (the same
    pattern as config.EstimatorConfig)."""

    base: Tuple[Tuple[int, ...], ...]
    z: int

    @property
    def n_check_blocks(self) -> int:
        return len(self.base)

    @property
    def n_var_blocks(self) -> int:
        return len(self.base[0])

    @property
    def n(self) -> int:
        """Codeword length in bits."""
        return self.n_var_blocks * self.z

    @property
    def k(self) -> int:
        """Information length in bits (n - rank(H); QC expansions can be
        rank-deficient, e.g. array codes lose mb-1 dependent rows)."""
        return make_ldpc_plan(self).k


def array_code(n_check_blocks: int, n_var_blocks: int, z: int) -> QCLdpcCode:
    """Fossorier array-LDPC construction: shift(i, j) = (i * j) mod z with z
    prime and n_var_blocks <= z gives a (n_check_blocks, n_var_blocks)-regular
    QC code of girth >= 6. A solid classical family; NR base graphs (TS 38.212
    tables 5.3.2-2/-3) plug into QCLdpcCode directly when available."""
    assert 2 <= n_check_blocks <= n_var_blocks <= z, (n_check_blocks, n_var_blocks, z)
    assert all(z % p for p in range(2, int(z**0.5) + 1)), f"z={z} must be prime"
    base = tuple(
        tuple((i * j) % z for j in range(n_var_blocks)) for i in range(n_check_blocks)
    )
    return QCLdpcCode(base=base, z=z)


def load_base_graph(path, z: int) -> QCLdpcCode:
    """Load a QC base graph from JSON and lift at Z = `z`.

    Format: {"base": [[...], ...]} (or a bare 2-D list), entries -1 for "no
    block" or a shift value; shifts are reduced mod z, the TS 38.212 §5.3.2
    lifting rule (the spec tables give V_{i,j} for the max Z of a set; the
    applied shift is V mod Z). This is the drop-in point for the NR BG1/BG2
    tables (not bundled): export them to JSON and every decoder tier, the
    encoder and the transport layer work unchanged."""
    import json
    import pathlib

    raw = json.loads(pathlib.Path(path).read_text())
    base = raw["base"] if isinstance(raw, dict) else raw
    rows = tuple(
        tuple(-1 if int(s) < 0 else int(s) % int(z) for s in row) for row in base
    )
    assert len({len(r) for r in rows}) == 1, "ragged base matrix"
    return QCLdpcCode(base=rows, z=int(z))


def _expand_h(code: QCLdpcCode) -> np.ndarray:
    """Dense (m, n) uint8 parity-check matrix (plan-time only)."""
    mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
    h = np.zeros((mb * z, nb * z), np.uint8)
    rows = np.arange(z)
    for i in range(mb):
        for j, s in enumerate(code.base[i]):
            if s >= 0:
                h[i * z + rows, j * z + (rows + s) % z] = 1
    return h


def _detect_nr_structure(code: QCLdpcCode):
    """Detect the NR base-graph encoding structure (TS 38.212 §5.3.2 shape):
    kb = nb - mb systematic block-columns, 4 core parity columns kb..kb+3 where
    col kb has 3 entries in the first 4 rows (two shifts equal, one unique) and
    cols kb+1..kb+3 form the shift-0 double-diagonal staircase, then an identity
    parity extension (row i >= 4 owns col kb+i at shift 0 and touches only
    columns < kb+4 otherwise). Returns the unique col-kb shift, or None.

    This is what makes encoding O(edges * z) instead of a dense GF(2)
    elimination of the expanded H — for BG1 at Z=384 (n=26112) the dense path
    is minutes of plan build and a 17664x8448 dense generator; the structured
    path is a handful of np.rolls. Official 3GPP tables and ops/nr_ldpc's
    structured stand-ins both satisfy it.
    """
    mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
    kb = nb - mb
    if kb < 1 or mb < 5:
        return None
    base = [list(r) for r in code.base]
    # only the CORE rows 0..3 constrain the staircase/col-kb patterns —
    # extension rows may (and in the official tables do) also touch the core
    # parity columns; they are handled after p0..p3 are known.
    col4 = lambda j: [(i, base[i][j]) for i in range(4) if base[i][j] >= 0]
    stair = ({(0, 0), (1, 0)}, {(1, 0), (2, 0)}, {(2, 0), (3, 0)})
    for j, want in zip(range(kb + 1, kb + 4), stair):
        if set(col4(j)) != want:
            return None
    # col kb: 3 entries in the core rows, two equal shifts + one unique
    ckb = col4(kb)
    if len(ckb) != 3:
        return None
    shifts = sorted(s for _, s in ckb)
    if shifts[0] == shifts[1] and shifts[1] != shifts[2]:
        s_unique = shifts[2]
    elif shifts[1] == shifts[2] and shifts[0] != shifts[1]:
        s_unique = shifts[0]
    else:
        return None
    # core rows confined to cols < kb+4; extension rows = identity + cols < kb+4
    for i in range(4):
        if any(base[i][j] >= 0 for j in range(kb + 4, nb)):
            return None
    for i in range(4, mb):
        if base[i][kb + i] != 0:
            return None
        if any(base[i][j] >= 0 for j in range(kb + 4, nb) if j != kb + i):
            return None
    return s_unique


def _roll_last(x: np.ndarray, s: int) -> np.ndarray:
    return np.roll(x, s, axis=-1)


def _encode_structured(code: QCLdpcCode, s_unique: int, u: np.ndarray) -> np.ndarray:
    """NR-structured systematic encode (see _detect_nr_structure): core parity
    p0 by XORing the 4 core rows (staircase cancels pairwise, the two equal
    col-kb shifts cancel, leaving P^{s_unique} p0 = sum of core syndromes),
    then p1..p3 by the staircase recurrence, then the identity extension."""
    mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
    kb = nb - mb
    base = code.base
    u = np.asarray(u, np.uint8)
    lead = u.shape[:-1]
    s_blk = u.reshape(lead + (kb, z))

    def syndrome(i, blocks):
        """XOR_j roll(x_j, -shift_ij) over the given {col: bits} dict."""
        acc = np.zeros(lead + (z,), np.uint8)
        for j, x in blocks.items():
            sh = base[i][j]
            if sh >= 0:
                acc ^= _roll_last(x, -sh)
        return acc

    sys_blocks = {j: s_blk[..., j, :] for j in range(kb)}
    lam = [syndrome(i, sys_blocks) for i in range(4)]
    p0 = _roll_last(lam[0] ^ lam[1] ^ lam[2] ^ lam[3], s_unique)
    t = []
    for i in range(3):
        ti = lam[i]
        if base[i][kb] >= 0:
            ti = ti ^ _roll_last(p0, -base[i][kb])
        t.append(ti)
    p1 = t[0]
    p2 = t[1] ^ p1
    p3 = t[2] ^ p2
    par = {kb: p0, kb + 1: p1, kb + 2: p2, kb + 3: p3}
    out = np.zeros(lead + (nb, z), np.uint8)
    out[..., :kb, :] = s_blk
    for j, x in par.items():
        out[..., j, :] = x
    for i in range(4, mb):
        out[..., kb + i, :] = syndrome(i, {**sys_blocks, **par})
    return out.reshape(lead + (nb * z,))


class LdpcPlan:
    """Static decode/encode tables for one code (all numpy, built once).

    Decoder wiring (check frame, D = max check degree in blocks):
      slot_var   (mb, D)    int32  variable-block index per slot (0 for pads)
      slot_shift (mb, D)    int32  cyclic shift per slot
      slot_valid (mb, D)    bool   real edge?
      edges                 list of (check_block, slot, var_block, shift) for
                            every real edge, row-major — the edge order
                            shared by the decoders and the numpy
                            reference (same order => same float association)
    Check lane a of block row i reads variable (var, (a + shift) mod z); in
    the batch-last layout that is roll(var_block, -shift) on the z axis, and
    the transpose direction (variable p accumulating check messages) is
    roll(+shift).
    Encoder (GF(2) reduced row echelon of the expanded H):
      info_cols   (k,)      non-pivot columns = systematic info positions
      parity_cols (rank,)   pivot columns
      parity_gen  (rank, k) uint8: codeword[parity_cols] = parity_gen @ u mod 2
    """

    def __init__(self, code: QCLdpcCode):
        mb, nb, z = code.n_check_blocks, code.n_var_blocks, code.z
        self.code = code
        degs = [sum(s >= 0 for s in row) for row in code.base]
        assert min(degs) >= 2, "degree-1 check rows are not a valid LDPC"
        d = max(degs)
        self.max_degree = d
        self.slot_var = np.zeros((mb, d), np.int32)
        self.slot_shift = np.zeros((mb, d), np.int32)
        self.slot_valid = np.zeros((mb, d), bool)
        for i, row in enumerate(code.base):
            t = 0
            for j, s in enumerate(row):
                if s >= 0:
                    self.slot_var[i, t] = j
                    self.slot_shift[i, t] = s
                    self.slot_valid[i, t] = True
                    t += 1
        self.edges = [
            (i, t, int(self.slot_var[i, t]), int(self.slot_shift[i, t]))
            for i in range(mb)
            for t in range(d)
            if self.slot_valid[i, t]
        ]

        # --- systematic encoder ---
        self.nr_structure = _detect_nr_structure(code)
        if self.nr_structure is not None:
            # NR shape: full-rank by construction (double diagonal + identity
            # extension are triangular in the parity part); encode() goes
            # through the O(edges * z) structured path, no dense elimination.
            self.rank = mb * z
            self.k = (nb - mb) * z
            self.info_cols = np.arange(self.k, dtype=np.int64)
            self.parity_cols = np.arange(self.k, nb * z, dtype=np.int64)
            self.parity_gen = None
            return

        # generic QC codes: GF(2) reduced row echelon of the expanded H
        h = _expand_h(code)
        m, n = h.shape
        r = 0
        pivots = []
        for c in range(n):
            hit = np.nonzero(h[r:, c])[0]
            if hit.size == 0:
                continue
            p = r + hit[0]
            if p != r:
                h[[r, p]] = h[[p, r]]
            elim = np.nonzero(h[:, c])[0]
            elim = elim[elim != r]
            h[elim] ^= h[r]
            pivots.append(c)
            r += 1
            if r == m:
                break
        self.rank = r
        self.parity_cols = np.asarray(pivots, np.int64)
        mask = np.ones(n, bool)
        mask[self.parity_cols] = False
        self.info_cols = np.nonzero(mask)[0]
        self.k = n - r
        # row i of the RREF: c[pivot_i] + sum_j R[i, info_j] c[info_j] = 0
        self.parity_gen = h[: self.rank][:, self.info_cols].copy()


@functools.lru_cache(maxsize=None)
def make_ldpc_plan(code: QCLdpcCode) -> LdpcPlan:
    return LdpcPlan(code)


def encode(code: QCLdpcCode, u: np.ndarray) -> np.ndarray:
    """Systematic encode: info bits u (..., k) in {0,1} -> codewords (..., n)
    in the natural (decoder) bit order; `plan.info_cols` positions carry u
    verbatim. Host-side numpy (transmitters live on the host in this
    framework, like demap.modulate)."""
    plan = make_ldpc_plan(code)
    u = np.asarray(u, np.uint8)
    assert u.shape[-1] == plan.k, (u.shape, plan.k)
    if plan.nr_structure is not None:
        return _encode_structured(code, plan.nr_structure, u)
    c = np.zeros(u.shape[:-1] + (code.n,), np.uint8)
    c[..., plan.info_cols] = u
    c[..., plan.parity_cols] = (u @ plan.parity_gen.T) % 2
    return c


@jax.tree_util.register_dataclass
@dataclass
class DecodeResult:
    """bits: hard decisions (..., n) uint8; info: (..., k) uint8 systematic
    payload; ok: (...) bool — parity check satisfied (all syndromes zero);
    posterior: (..., n) float soft outputs (same sign convention as input)."""

    bits: jnp.ndarray
    info: jnp.ndarray
    ok: jnp.ndarray
    posterior: jnp.ndarray


def layered_tier(backend: str) -> str:
    """The layered decoder `kernels="auto"` runs on `backend`: the plain-XLA
    row walk on the CPU; on a GPU the faster of the walk and the Triton
    kernel as measured at the benchmark's codes (PERF.md)."""
    if backend == "cpu":
        return "xla"
    if backend == "gpu":
        return "triton"
    raise ValueError(f"no LDPC decoder tier for backend {backend!r}")


def select_tier(kernels: str, schedule: str, backend: str) -> str:
    """The tier `build_decoder` runs: `kernels` itself unless it is "auto",
    which picks "xla" for flooding and `layered_tier(backend)` for layered."""
    if kernels != "auto":
        return kernels
    tier = layered_tier(backend)  # also refuses unknown backends
    return tier if schedule == "layered" else "xla"


@functools.lru_cache(maxsize=64)
def _check_tables(code: QCLdpcCode, group: int = 1):
    """Check-frame index tables, rows padded to a multiple of `group` (pads
    are all-invalid rows): gidx (mb_pad, d, z) int32 flat variable index of
    every check lane — slot (i, t) lane a reads variable bit
    (j, (a + s) mod z); invalid slots point at bits 0..z-1 and only ever add
    0 — and valid (mb_pad, d) bool."""
    plan = make_ldpc_plan(code)
    mb, d, z = code.n_check_blocks, plan.max_degree, code.z
    mb_pad = -(-mb // group) * group
    gidx = np.tile(np.arange(z, dtype=np.int32), (mb_pad, d, 1))
    a_z = np.arange(z)
    for i, t, j, s in plan.edges:
        gidx[i, t] = j * z + (a_z + s) % z
    valid = np.zeros((mb_pad, d), bool)
    valid[:mb] = plan.slot_valid
    return gidx, valid


@functools.lru_cache(maxsize=64)
def build_decoder(
    code: QCLdpcCode,
    n_iters: int = 20,
    norm: float = 0.75,
    kernels: str = "xla",
    schedule: str = "flooding",
    layered_group: int = 1,
    stream_c2v_dtype: Optional[str] = None,
):
    """Build the jitted normalized-min-sum decoder for `code` (lru-cached:
    repeated builds — e.g. one per serving.process call — reuse the same
    jitted closure and hence XLA's compilation cache).

    Returns decode(llr) where llr is (..., n) channel LLRs (float or the
    receiver's int8 soft bits; positive = bit 0). Any leading axes batch.
    `norm` is the min-sum normalization factor (0.75 is the standard choice;
    1.0 = pure min-sum). The schedule is static: `n_iters` sweeps, parity
    reported in `ok`. Every tier reads the check frame through ONE
    precomputed-index gather and writes back through one scatter-add (same
    indices): program size O(1) in edges.

    schedule="flooding" (every check updates from one posterior per sweep):
      kernels="xla", a lax.scan of whole-frame sweeps.

    schedule="layered" (rows update in order, each from the freshest
    posterior: ~2x the convergence per sweep). `layered_group` rows share
    one posterior snapshot; `stream_c2v_dtype="bfloat16"` stores the
    check-to-variable messages in bf16 (min-sum is scale-invariant; the
    posterior stays f32 and consistent with the rounded messages). Both are
    mirrored by `decode_reference`.
      kernels="xla" walks the rows as a lax.scan inside the sweep scan —
      plain JAX, every backend.
      kernels="triton" runs the whole decode as one Pallas kernel on a GPU
      (ops/ldpc_triton.py).

    kernels="auto" picks by backend (`select_tier`): "xla" for flooding,
    `layered_tier` for layered (the plain walk on the CPU, the measured
    winner on a GPU). A backend other than the CPU or a GPU is an error.
    """
    assert kernels in ("xla", "triton", "auto"), kernels
    assert schedule in ("flooding", "layered"), schedule
    assert stream_c2v_dtype in (None, "bfloat16"), stream_c2v_dtype
    kernels = select_tier(kernels, schedule, jax.default_backend())
    if kernels == "triton" and schedule != "layered":
        raise ValueError("kernels='triton' implements the layered schedule only")
    plan = make_ldpc_plan(code)
    mb, nb, d, z = code.n_check_blocks, code.n_var_blocks, plan.max_degree, code.z
    valid = jnp.asarray(plan.slot_valid[:, :, None, None])  # (mb, d, 1, 1)
    info_cols = jnp.asarray(plan.info_cols)
    group = max(1, min(int(layered_group), mb))
    cdt = jnp.dtype(stream_c2v_dtype or "float32")
    # scatter-add association for duplicate variable indices is XLA's order,
    # so posteriors match decode_reference to float tolerance (tests pin
    # allclose + identical hard decisions)
    gidx_flat = jnp.asarray(_check_tables(code)[0].reshape(-1))

    def _min_sum(v2c, vld, axis):
        """Extrinsic normalized min-sum over the slot `axis` of a check frame:
        sign = product of the other signs, magnitude = min of the other
        magnitudes (min2 at the first-minimum slot, min1 elsewhere). Slots
        where `vld` is False emit 0."""
        mag = jnp.where(vld, jnp.abs(v2c), _BIG)
        neg = vld & (v2c < 0)
        # total sign as parity of the negative count (additive reduction;
        # identical to the product for +-1 factors); extrinsic = total * own
        par = jnp.sum(neg.astype(jnp.int32), axis=axis, keepdims=True) % 2
        ext_sign = (1.0 - 2.0 * par.astype(v2c.dtype)) * (1.0 - 2.0 * neg.astype(v2c.dtype))
        i_min = jnp.argmin(mag, axis=axis)
        slots = jax.lax.broadcasted_iota(jnp.int32, mag.shape, axis)
        onehot = slots == jnp.expand_dims(i_min, axis)
        min1 = jnp.min(mag, axis=axis, keepdims=True)
        min2 = jnp.min(jnp.where(onehot, _BIG, mag), axis=axis, keepdims=True)
        ext_mag = jnp.where(onehot, min2, min1)
        # pin the dtype: weak-typed literals above would promote f32 carries
        # to f64 under x64 and break the scan carry contract
        return jnp.where(vld, norm * ext_sign * ext_mag, 0.0).astype(v2c.dtype)

    def _layered_xla(ch):
        """Plain-JAX layered walk: (nb, z, b) channel LLRs -> posterior."""
        b = ch.shape[-1]
        dt = ch.dtype
        gidx_np, valid_np = _check_tables(code, group)
        n_groups = gidx_np.shape[0] // group
        g_idx = jnp.asarray(gidx_np.reshape(n_groups, group, d * z))
        g_vld = jnp.asarray(valid_np.reshape(n_groups, group, d, 1, 1))

        def row_group(L, xs):
            idx, vld, cv = xs  # (G, d*z), (G, d, 1, 1), (G, d, z, b) cdt
            lg = jnp.take(L, idx.reshape(-1), axis=0).reshape(group, d, z, b)
            cvf = cv.astype(dt)
            upd = _min_sum(lg - cvf, vld, axis=1).astype(cdt)
            delta = jnp.where(vld, upd.astype(dt) - cvf, 0.0).astype(dt)
            for gi in range(group):  # rows of a group apply in order
                L = L.at[idx[gi]].add(delta[gi].reshape(d * z, b))
            return L, upd

        def sweep(carry, _):
            L, C = carry
            L, C = jax.lax.scan(row_group, L, (g_idx, g_vld, C))
            return (L, C), None

        # zero init derived from ch so its varying-axes type matches the body
        # under shard_map (parallel.build_dp_decoder)
        c0 = jnp.zeros((n_groups, group, d, z, 1), cdt) + (0.0 * ch[0, 0]).astype(cdt)
        (L, _), _ = jax.lax.scan(sweep, (ch.reshape(nb * z, b), c0), None, length=n_iters)
        return L.reshape(nb, z, b)

    @jax.jit
    def decode(llr) -> DecodeResult:
        llr = jnp.asarray(llr)
        llr = llr.astype(jnp.promote_types(llr.dtype, jnp.float32))
        lead = llr.shape[:-1]
        b = max(int(np.prod(lead)), 1)
        # batch-LAST internally: (nb, z, b) variable / (mb, d, z, b) check frame
        ch = jnp.transpose(llr.reshape((b, nb, z)), (1, 2, 0))

        def accum(c2v):  # (mb, d, z, b) -> posterior (nb, z, b)
            acc = ch.reshape(nb * z, b).at[gidx_flat].add(c2v.reshape(mb * d * z, b))
            return acc.reshape(nb, z, b)

        def gather(post):  # (nb, z, b) -> check frame (mb, d, z, b)
            fr = jnp.take(post.reshape(nb * z, b), gidx_flat, axis=0)
            return fr.reshape(mb, d, z, b)

        if kernels == "triton":
            from . import ldpc_triton

            posterior = ldpc_triton.layered_posterior(
                ch, plan.slot_var, plan.slot_shift, plan.slot_valid, n_iters, norm,
                group=group, c2v_dtype=stream_c2v_dtype,
            ).astype(ch.dtype)
        elif schedule == "layered":
            posterior = _layered_xla(ch)
        else:
            def body(c2v, _):
                post = accum(c2v)
                v2c = gather(post) - c2v
                return _min_sum(v2c, valid, axis=1), None

            c2v0 = jnp.zeros((mb, d, z, 1), ch.dtype) + 0.0 * ch[0, 0][None, None, None, :]
            c2v, _ = jax.lax.scan(body, c2v0, None, length=n_iters)
            posterior = accum(c2v)
        bits = (posterior < 0).astype(jnp.uint8)
        par = jnp.sum(gather(bits.astype(jnp.int32)) * valid, axis=1) % 2
        ok = jnp.logical_not(jnp.any(par, axis=(0, 1)))  # (b,)
        bits_bn = jnp.transpose(bits, (2, 0, 1)).reshape((b, code.n))
        post_bn = jnp.transpose(posterior, (2, 0, 1)).reshape((b, code.n))
        return DecodeResult(
            bits=bits_bn.reshape(lead + (code.n,)),
            info=jnp.take(bits_bn, info_cols, axis=-1).reshape(lead + (plan.k,)),
            ok=ok.reshape(lead),
            posterior=post_bn.reshape(lead + (code.n,)),
        )

    return decode


def decode_reference(
    code: QCLdpcCode,
    llr: np.ndarray,
    n_iters: int = 20,
    norm: float = 0.75,
    schedule: str = "flooding",
    layered_group: int = 1,
    c2v_dtype: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Float64 numpy normalized-min-sum with the identical schedule (same edge
    order, same per-variable summation association as `build_decoder`) — the
    correctness anchor for every decoder tier (same role utils/oracle.py
    plays for the estimator). schedule="layered" honours `layered_group` and
    `c2v_dtype` (stored messages rounded to that dtype, e.g. "bfloat16").
    Returns (bits (..., n) uint8, ok (...) bool, posterior (..., n) float64)."""
    plan = make_ldpc_plan(code)
    mb, nb, d, z = code.n_check_blocks, code.n_var_blocks, plan.max_degree, code.z
    edges = plan.edges
    valid = plan.slot_valid[None, :, :, None]
    lead = np.asarray(llr).shape[:-1]
    ch = np.asarray(llr, np.float64).reshape(-1, nb, z)
    b = ch.shape[0]

    def accum(c2v):  # (b, mb, d, z) -> (b, nb, z)
        acc = ch.copy()
        for i, t, j, s in edges:
            acc[:, j] += np.roll(c2v[:, i, t], s, axis=-1)
        return acc

    def gather(post):  # (b, nb, z) -> (b, mb, d, z)
        out = np.zeros((b, mb, d, z), post.dtype)
        for i, t, j, s in edges:
            out[:, i, t] = np.roll(post[:, j], -s, axis=-1)
        return out

    c2v = np.zeros((b, mb, d, z))
    if schedule == "layered":
        # row-serial layered sweep: identical row order, identical two-min/tie
        # semantics (np.argmin = first minimum), messages stored at c2v_dtype
        L = ch.copy()
        cv = {e: np.zeros((b, z)) for e in range(len(edges))}
        row_eids = [[e for e, (i2, _, _, _) in enumerate(edges) if i2 == i] for i in range(mb)]
        for _ in range(n_iters):
            for g0 in range(0, mb, layered_group):
                chunk = range(g0, min(g0 + layered_group, mb))
                upds = {}
                for i in chunk:
                    eids = row_eids[i]
                    v2c = np.stack(
                        [np.roll(L[:, edges[e][2]], -edges[e][3], axis=-1) - cv[e] for e in eids],
                        axis=1,
                    )  # (b, deg, z)
                    mag = np.abs(v2c)
                    neg = v2c < 0
                    i_min = np.argmin(mag, axis=1)
                    onehot = np.arange(len(eids))[:, None] == i_min[:, None, :]
                    min1 = np.min(mag, axis=1, keepdims=True)
                    min2 = np.min(np.where(onehot, _BIG, mag), axis=1, keepdims=True)
                    ext = np.where(onehot, min2, min1)
                    par = np.logical_xor.reduce(neg, axis=1, keepdims=True)
                    sgn = 1.0 - 2.0 * np.logical_xor(par, neg)
                    upd = norm * sgn * ext
                    if c2v_dtype is not None:
                        upd = upd.astype(jnp.dtype(c2v_dtype)).astype(np.float64)
                    upds[i] = upd
                for i in chunk:
                    for t_, e in enumerate(row_eids[i]):
                        j, s = edges[e][2], edges[e][3]
                        L[:, j] += np.roll(upds[i][:, t_] - cv[e], s, axis=-1)
                        cv[e] = upds[i][:, t_]
        posterior = L.reshape(b, code.n)
        bits = (posterior < 0).astype(np.uint8)
        par2 = np.sum(gather(bits.reshape(b, nb, z).astype(np.int64)) * valid, axis=-2) % 2
        ok = ~np.any(par2, axis=(-2, -1))
        return (
            bits.reshape(lead + (code.n,)),
            ok.reshape(lead),
            posterior.reshape(lead + (code.n,)),
        )
    for _ in range(n_iters):
        post = accum(c2v)
        v2c = gather(post) - c2v
        mag = np.where(valid, np.abs(v2c), _BIG)
        sgn = np.where(valid & (v2c < 0), -1.0, 1.0)
        ext_sign = np.prod(sgn, axis=-2, keepdims=True) * sgn
        i_min = np.argmin(mag, axis=-2)
        onehot = np.arange(d)[:, None] == i_min[..., None, :]
        min1 = np.min(mag, axis=-2, keepdims=True)
        min2 = np.min(np.where(onehot, _BIG, mag), axis=-2, keepdims=True)
        ext = np.where(onehot, min2, min1)
        c2v = np.where(valid, norm * ext_sign * ext, 0.0)
    posterior = accum(c2v).reshape(b, code.n)
    bits = (posterior < 0).astype(np.uint8)
    par = np.sum(gather(bits.reshape(b, nb, z).astype(np.int64)) * valid, axis=-2) % 2
    ok = ~np.any(par, axis=(-2, -1))
    return (
        bits.reshape(lead + (code.n,)),
        ok.reshape(lead),
        posterior.reshape(lead + (code.n,)),
    )
