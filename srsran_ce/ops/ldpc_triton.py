"""Layered normalized min-sum LDPC decoding as one Pallas kernel for NVIDIA GPUs.

The layered schedule is a serial chain: every check row of every sweep reads
the posterior that the previous row wrote (46 rows per sweep for NR BG1).
Under plain XLA (`ops/ldpc.py`, the layered walk) each row is a few small
kernels, so launch and loop overhead set the pace. Here the whole decode runs
in ONE launch, written through Pallas's Triton route:

- one program per tile of `BT` codewords; the sweep and row loops run inside
  the program, so nothing crosses between programs and no grid-wide
  synchronisation is needed (the rows of one tile are serial, tiles are not);
- each program reads its own wiring tables (variable-block offset, cyclic
  shift, edge id, valid flag per slot) from device memory;
- the messages stay in device memory (one codeword of NR BG1 Z=384 carries
  316 x 384 float32 check-to-variable messages, ~485 KB, more than a block's
  shared memory), in a tile-major frame (tile, row, BT): the codewords of a
  tile sit on the contiguous axis, and a run of consecutive check lanes of one
  slot is one contiguous span, so the quasi-cyclic rotation (a + s) mod Z is
  two contiguous pieces of it;
- a row is processed in chunks of ZB check lanes; all DP (>= max check degree,
  a power of two) slots of a chunk are one (DP, ZB, BT) block, so the two-min
  and sign reductions run over the block's leading axis.

Within one row all check lanes touch distinct variables (a row holds each
variable block at most once), so the chunks of a row are independent; rows
are separated by a block barrier. With row groups (`group` > 1) all rows of a
group update from one posterior snapshot: phase A writes every row's deltas
to a staging buffer, phase B applies them row by row.

The arithmetic mirrors `ldpc.decode_reference(schedule="layered")`: the same
row order, first-minimum tie rule, message rounding (`c2v_dtype`) and update
association, so hard decisions agree with the float64 reference and
posteriors agree to float32 rounding.

The kernel compiles only for a GPU. `interpret=True` runs it through the
Pallas interpreter (on any backend); the tests use that.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BIG = 1e30  # two-min sentinel for masked slots (never wins a min)

#: Elements per (DP, ZB, BT) block; the chunk length ZB follows from it.
BLOCK_ELEMS = 2048
#: Codewords per program at most, and the program count aimed for.
MAX_BT = 16
TARGET_PROGRAMS = 128
NUM_WARPS = 4


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def tiling(batch: int, z: int, d: int):
    """(BT, ZB, DP): codewords per program, check lanes per chunk and padded
    slot count for a batch of `batch` codewords of lifting size `z` and max
    check degree `d`. BT grows only once there are TARGET_PROGRAMS programs."""
    dp = _pow2_ceil(d)
    bt = int(min(MAX_BT, _pow2_floor(max(batch // TARGET_PROGRAMS, 1))))
    zb = int(min(_pow2_ceil(z), max(1, _pow2_floor(BLOCK_ELEMS // (dp * bt)))))
    return bt, zb, dp


def kernel_tables(slot_var, slot_shift, slot_valid, z: int, group: int, dp: int):
    """Wiring tables (4, mb_pad, dp) int32: [variable offset j*z | shift |
    edge id | valid]. Rows pad to a multiple of `group`, slots to `dp`; pads
    are invalid and point at the dummy edge row n_edges."""
    mb, d = slot_var.shape
    mb_pad = -(-mb // group) * group
    n_edges = int(np.sum(slot_valid))
    valid = np.zeros((mb_pad, dp), bool)
    valid[:mb, :d] = slot_valid
    var_off = np.zeros((mb_pad, dp), np.int32)
    var_off[:mb, :d] = np.where(slot_valid, slot_var * z, 0)
    shift = np.zeros((mb_pad, dp), np.int32)
    shift[:mb, :d] = np.where(slot_valid, np.asarray(slot_shift) % z, 0)
    eid = np.full((mb_pad, dp), n_edges, np.int32)
    eid[valid] = np.arange(n_edges, dtype=np.int32)
    return np.stack([var_off, shift, eid, valid.astype(np.int32)])


def _kernel(tbl_ref, ch_ref, l_ref, c_ref, *rest, n_rows_l, n_rows_c, z, zb, dp,
            bt, n_groups, group, n_iters, norm, interpret):
    """One program = one tile of BT codewords, the whole decode. l_ref and
    c_ref (and d_ref, the group staging buffer) each end in one spare row
    that masked lanes index, so no masked lane aliases a live element."""
    d_ref = rest[0] if rest else None
    t = pl.program_id(0)
    lanes = jnp.arange(zb, dtype=jnp.int32)
    cols = jnp.arange(bt, dtype=jnp.int32)
    cols3 = cols[None, None, :]
    n_zb = -(-z // zb)
    dt = jnp.float32
    cdt = c_ref.dtype
    spare_l = n_rows_l
    spare_c = n_rows_c - z  # first row of the dummy edge
    spare_d = group * dp * z

    def barrier():
        if not interpret:  # the interpreter runs a program's threads in order
            plgpu.debug_barrier()

    # --- init: L = channel LLRs, messages = 0, in chunks of rc rows x BT
    rc = 64

    def copy_chunk(k, carry):
        r = k * rc + jnp.arange(rc, dtype=jnp.int32)
        ok = (r < n_rows_l)[:, None]
        m = jnp.broadcast_to(ok, (rc, bt))
        src = jnp.where(ok, r[:, None], 0)
        v = plgpu.load(ch_ref.at[t, src, cols[None, :]], mask=m, other=0.0)
        plgpu.store(l_ref.at[t, jnp.where(ok, r[:, None], spare_l), cols[None, :]], v, mask=m)
        return carry

    def zero_chunk(k, carry):
        r = k * rc + jnp.arange(rc, dtype=jnp.int32)
        ok = (r < n_rows_c)[:, None]
        m = jnp.broadcast_to(ok, (rc, bt))
        dst = jnp.where(ok, r[:, None], spare_c)
        plgpu.store(c_ref.at[t, dst, cols[None, :]], jnp.zeros((rc, bt), cdt), mask=m)
        return carry

    # loop carries are traced values: the Triton lowering cannot yield a
    # Python constant from a loop body
    zero = t * 0
    jax.lax.fori_loop(0, -(-n_rows_l // rc), copy_chunk, zero)
    jax.lax.fori_loop(0, -(-n_rows_c // rc), zero_chunk, zero)
    barrier()

    def chunk_index(i, c):
        """Chunk c of row i: L rows at the rotated lanes, message rows, and
        the (DP, ZB, BT) mask; masked lanes point at the spare rows."""
        var_off = tbl_ref[0, i, :]
        shift = tbl_ref[1, i, :]
        eid = tbl_ref[2, i, :]
        valid = tbl_ref[3, i, :] > 0
        a = c * zb + lanes  # check lanes of this chunk
        m2 = valid[:, None] & (a < z)[None, :]
        rot = a[None, :] + shift[:, None]
        rot = jnp.where(rot >= z, rot - z, rot)  # (a + s) mod z: two runs
        lidx = jnp.where(m2, var_off[:, None] + rot, spare_l)
        cidx = jnp.where(m2, eid[:, None] * z + a[None, :], spare_c)
        m = jnp.broadcast_to(m2[:, :, None], (dp, zb, bt))
        return lidx[:, :, None], cidx[:, :, None], m, m2

    def stage_index(gi, c, m2):
        slot = jax.lax.broadcasted_iota(jnp.int32, (dp, zb), 0)
        didx = (gi * dp + slot) * z + (c * zb + lanes)[None, :]
        return jnp.where(m2, didx, spare_d)[:, :, None]

    def row_update(lg, cv, m):
        """Extrinsic normalized min-sum over the slot axis; returns the stored
        message (cdt) and the posterior delta (f32, exact vs the rounded
        message), both zero on masked lanes."""
        v = lg - cv
        mag = jnp.where(m, jnp.abs(v), _BIG)
        neg = m & (v < 0)
        par = jnp.sum(neg.astype(jnp.int32), axis=0) % 2  # (ZB, BT)
        m1 = jnp.min(mag, axis=0)
        slot = jax.lax.broadcasted_iota(jnp.int32, (dp, zb, bt), 0)
        i1 = jnp.min(jnp.where(mag == m1[None], slot, dp), axis=0)  # first min
        first = slot == i1[None]
        m2 = jnp.min(jnp.where(first, _BIG, mag), axis=0)
        ext = jnp.where(first, m2[None], m1[None])
        neg_ext = (par[None] == 1) != (v < 0)
        sgn = 1.0 - 2.0 * neg_ext.astype(dt)
        upd = jnp.where(m, norm * sgn * ext, 0.0).astype(cdt)
        delta = jnp.where(m, upd.astype(dt) - cv, 0.0)
        return upd, delta

    def load_row(i, c):
        lidx, cidx, m, m2 = chunk_index(i, c)
        lg = plgpu.load(l_ref.at[t, lidx, cols3], mask=m, other=0.0)
        cv = plgpu.load(c_ref.at[t, cidx, cols3], mask=m, other=0.0).astype(dt)
        upd, delta = row_update(lg, cv, m)
        plgpu.store(c_ref.at[t, cidx, cols3], upd, mask=m)
        return lidx, m, m2, lg, delta

    def fused_row(i):
        """group == 1: compute and apply row i chunk by chunk."""

        def chunk(c, carry):
            lidx, m, _, lg, delta = load_row(i, c)
            plgpu.store(l_ref.at[t, lidx, cols3], lg + delta, mask=m)
            return carry

        jax.lax.fori_loop(0, n_zb, chunk, zero)
        barrier()

    def grouped_rows(g):
        """group > 1: phase A stages every row's delta from one snapshot of
        L; phase B applies them in row order."""
        for gi in range(group):

            def stage(c, carry, gi=gi):
                _, m, m2, _, delta = load_row(g * group + gi, c)
                plgpu.store(d_ref.at[t, stage_index(gi, c, m2), cols3], delta, mask=m)
                return carry

            jax.lax.fori_loop(0, n_zb, stage, zero)
        barrier()
        for gi in range(group):

            def apply(c, carry, gi=gi):
                lidx, _, m, m2 = chunk_index(g * group + gi, c)
                delta = plgpu.load(d_ref.at[t, stage_index(gi, c, m2), cols3], mask=m, other=0.0)
                lg = plgpu.load(l_ref.at[t, lidx, cols3], mask=m, other=0.0)
                plgpu.store(l_ref.at[t, lidx, cols3], lg + delta, mask=m)
                return carry

            jax.lax.fori_loop(0, n_zb, apply, zero)
            barrier()

    def sweep(_, carry):
        def group_body(g, c):
            if group == 1:
                fused_row(g)
            else:
                grouped_rows(g)
            return c

        return jax.lax.fori_loop(0, n_groups, group_body, carry)

    jax.lax.fori_loop(0, n_iters, sweep, zero)


def layered_posterior(
    ch: jnp.ndarray,
    slot_var: np.ndarray,
    slot_shift: np.ndarray,
    slot_valid: np.ndarray,
    n_iters: int,
    norm: float,
    group: int = 1,
    c2v_dtype: Optional[str] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Layered min-sum posterior of channel LLRs `ch` ((nb, z, B) float32,
    the decoder's batch-last frame), same frame out. `slot_*` are the
    LdpcPlan check-frame tables. Pads the batch to whole tiles internally.

    Runs only where it compiles, on a GPU, unless `interpret=True`."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton LDPC kernel compiles only for a GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to interpret it"
        )
    nb, z, B = ch.shape
    mb, d = slot_var.shape
    group = max(1, min(int(group), mb))
    bt, zb, dp = tiling(B, z, d)
    tbl = kernel_tables(np.asarray(slot_var), np.asarray(slot_shift),
                        np.asarray(slot_valid), z, group, dp)
    mb_pad = tbl.shape[1]
    n_edges = int(np.sum(slot_valid))
    n_tiles = -(-B // bt)
    pad = n_tiles * bt - B
    chp = jnp.pad(ch, ((0, 0), (0, 0), (0, pad))) if pad else ch
    # tile-major frame (tile, row, BT): a tile's codewords are contiguous
    tiled = jnp.transpose(chp.reshape(nb * z, n_tiles, bt), (1, 0, 2)).astype(jnp.float32)
    cdt = jnp.float32 if c2v_dtype is None else jnp.dtype(c2v_dtype)
    out_shape = [  # each buffer ends in a spare row (see _kernel)
        jax.ShapeDtypeStruct((n_tiles, nb * z + 1, bt), jnp.float32),
        jax.ShapeDtypeStruct((n_tiles, (n_edges + 1) * z, bt), cdt),
    ]
    if group > 1:
        out_shape.append(jax.ShapeDtypeStruct((n_tiles, group * dp * z + 1, bt), jnp.float32))
    kernel = functools.partial(
        _kernel, n_rows_l=nb * z, n_rows_c=(n_edges + 1) * z, z=z, zb=zb, dp=dp,
        bt=bt, n_groups=mb_pad // group, group=group, n_iters=int(n_iters),
        norm=float(norm), interpret=interpret,
    )
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_tiles,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="ldpc_layered",
    )(jnp.asarray(tbl), tiled)
    post = jnp.transpose(outs[0][:, : nb * z], (1, 0, 2)).reshape(nb, z, n_tiles * bt)
    return post[..., :B] if pad else post
