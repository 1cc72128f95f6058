"""Coded-transport layout: the TX/RX agreement behind `serving.process(out="decoded")`.

The reference framework stops at the channel estimate; this framework's chain
continues through equalization, soft demapping (int8 LLRs) and QC-LDPC
decoding (ops/ldpc). What remains between "a grid of per-RE soft bits" and "a
decoded payload" is pure bookkeeping that the transmitter and receiver must
agree on, collected here so the synthetic transmitter (utils/synthetic), the
link-level evaluations (validation/quality) and the serving path (serving.py)
share ONE implementation:

  * which REs carry scored payload (`data_mask`: each hop's PRB band over its
    allocated symbols, minus that hop's DM-RS symbols entirely — the
    convention the end-to-end tests established);
  * the bit order (mask positions in (sc, sym) C-order, then (layer, bit));
  * the channel interleaver (a seeded pseudorandom permutation of codeword
    bits over the payload positions — frequency fades are hundred-bit bursts
    in natural order and defeat the code outright without it; this plays the
    role of NR's rate-matching interleaver, TS 38.212 §5.4.2);
  * the scrambling planes (per-layer TS 38.211 Gold streams applied to grid
    planes — see `scramble_planes` for the deliberate deviation from the
    §6.3.1.1 pre-layer-mapping bit-stream order).

Everything here is host-side numpy; the device work stays in models/receiver
(fused estimate+equalize+demap) and ops/ldpc (batched min-sum decode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .config import NRE, HopConfig
from .ops.ldpc import QCLdpcCode, make_ldpc_plan


@dataclass(frozen=True)
class TransportCoding:
    """Coding/scrambling agreement for one transport stream. Frozen+hashable:
    used as a bucketing key by the serving path.

    scramble_c_init: TS 38.211 §6.3.1.1 initializer
    (ops/sequences.pusch_scrambling_c_init); None = unscrambled payload.
    kernels: ops/ldpc.build_decoder tier ("auto" = chosen by code size and
    backend).
    crc: optional TS 38.212 §5.1 CRC attached to each codeword's systematic
    payload ("crc24a"/"crc24b"/"crc16"/"crc11"/"crc6") — the transmitter
    encodes crc_attach(payload), the decoded serving path checks it and
    strips it (ok = LDPC parity AND CRC; info = payload without the CRC)."""

    code: QCLdpcCode
    n_iters: int = 25
    norm: float = 0.75
    interleave_seed: int = 0
    scramble_c_init: Optional[int] = None
    kernels: str = "auto"
    crc: Optional[str] = None
    # min-sum schedule: "flooding" or "layered" (~2x fewer sweeps for the
    # same BER, so set n_iters accordingly). layered_group: rows updated per
    # posterior snapshot (see ops/ldpc.build_decoder).
    schedule: str = "flooding"
    layered_group: int = 1
    # Layered-schedule message dtype: "bfloat16" halves the stored
    # check-to-variable messages (min-sum is scale-invariant). None = f32.
    # Mirrored by ops/ldpc.decode_reference(c2v_dtype=...).
    stream_c2v_dtype: Optional[str] = None
    # Two-phase early termination in the serving decode: every word first
    # runs `early_iters` sweeps (converged words — the vast majority at
    # operating SNR — are done); only parity failures rerun at the full
    # n_iters. The lax.scan schedule is static per executable, so this is
    # batch-level early exit: two executables instead of a dynamic loop.
    # None disables (single full-n_iters pass).
    early_iters: Optional[int] = 8
    # Incremental-redundancy HARQ (TS 38.212 §5.4.2 circular buffer, simplified):
    # tx_bits < n transmits only a contiguous (mod n) window of each codeword,
    # starting at rv * tx_bits — effective rate k/tx_bits per transmission.
    # Untransmitted positions extract as LLR 0 (erasures, which min-sum handles
    # natively); retransmissions with different `rv` fill different windows, so
    # combine_llrs of the extracted streams IS incremental-redundancy combining.
    # None = transmit the full codeword (chase combining across identical TXs).
    tx_bits: Optional[int] = None
    rv: int = 0
    # Rate-matching mode: "circular" = the simplified contiguous window above;
    # "nr" = full TS 38.212 §5.4.2 (2Z-puncture circular buffer, per-rv k0,
    # filler skip, Qm bit interleaver — ops/nr_ldpc.make_rate_match; requires an
    # NR base-graph code, e.g. nr_ldpc.nr_base_graph). The PRP channel
    # interleaver (interleave_seed) still maps the transmitted stream onto REs
    # in both modes — it plays the role of NR's frequency-distributed resource
    # mapping, not of the §5.4.2.2 bit interleaver.
    rate_match: str = "circular"
    # Known-zero filler bits at the tail of the systematic part (§5.2.2 when
    # K' < K_b*Z): never transmitted ("nr" mode), pinned to +max LLR at the
    # receiver, excluded from payload_bits.
    n_filler: int = 0


@dataclass(frozen=True)
class TransportLayout:
    """Static per-geometry layout: where each codeword bit of each word lives.

    mask: (n_sc, n_sym) bool payload REs; perm: (c_words * tx_bits,)
    positions into the flattened scored bit stream (mask C-order, then
    (layer, bit)); total: scored bits; k/n: code dimensions; tx_bits = n
    unless IR-punctured (TransportCoding.tx_bits)."""

    mask: np.ndarray
    perm: np.ndarray
    c_words: int
    total: int
    k: int
    n: int
    tx_bits: int  # coded bits transmitted per word (n unless IR-punctured)
    cw_sel: np.ndarray  # (tx_bits,) codeword positions this RV transmits
    # "nr" rate matching only: known-zero filler codeword positions (pinned to
    # +max LLR on extraction) and whether cw_sel repeats positions (E beyond
    # one circular-buffer pass -> extraction soft-combines duplicates).
    filler_pos: Optional[np.ndarray] = None
    has_repeats: bool = False


def data_mask(
    hop1: HopConfig, hop2: Optional[HopConfig], n_sc: int, n_sym: int
) -> np.ndarray:
    """Scored-payload RE mask: union over hops of (PRB band x allocated
    symbols), minus each hop's DM-RS symbols entirely (at DM-RS symbols the
    non-pilot REs still carry signal; they are just not scored — matching
    utils/synthetic.make_mimo_case)."""
    mask = np.zeros((n_sc, n_sym), dtype=bool)
    for hop in [hop1] + ([hop2] if hop2 is not None and not hop2.is_empty else []):
        band = np.kron(hop.prb_mask_np, np.ones(NRE, dtype=bool))
        if band.size < n_sc:
            band = np.concatenate([band, np.zeros(n_sc - band.size, bool)])
        alloc = np.zeros(n_sym, dtype=bool)
        alloc[hop.start_symbol : hop.start_symbol + hop.n_allocated_symbols] = True
        alloc[np.nonzero(hop.dmrs_symbol_mask_np[:n_sym])[0]] = False
        mask |= band[:n_sc, None] & alloc[None, :]
    return mask


def layout(
    coding: TransportCoding,
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    n_sc: int,
    n_sym: int,
    n_layers: int,
    nbits: int,
) -> TransportLayout:
    """Compute the full static layout for one (coding, geometry) pair."""
    mask = data_mask(hop1, hop2, n_sc, n_sym)
    total = int(mask.sum()) * n_layers * nbits
    n = coding.code.n
    filler_pos = None
    has_repeats = False
    if coding.rate_match == "nr":
        from .ops import nr_ldpc as _nr

        nbv = coding.code.n_var_blocks
        bg = {68: 1, 52: 2}.get(nbv)
        if bg is None:
            raise ValueError(
                f"rate_match='nr' needs a full NR base graph (68/52 block cols), got {nbv}"
            )
        z = coding.code.z
        if coding.tx_bits is not None:
            tx_bits = coding.tx_bits
            # validate here (not just in make_rate_match's assert, which
            # vanishes under python -O): tx_bits <= 0 would reach the
            # `total // tx_bits` division below, and a non-Qm-multiple E is
            # not a valid §5.4.2 rate-match output length
            if tx_bits < 1:
                raise ValueError(f"tx_bits must be >= 1: {tx_bits}")
            if tx_bits % nbits != 0:
                raise ValueError(
                    f"rate_match='nr' needs tx_bits to be a multiple of Qm={nbits}: {tx_bits}"
                )
        else:
            # default E: one full circular-buffer pass, rounded down to Qm
            tx_bits = ((n - 2 * z - coding.n_filler) // nbits) * nbits
        rm = _nr.make_rate_match(
            bg, z, nbv, tx_bits, qm=nbits, rv=coding.rv, n_filler=coding.n_filler
        )
        cw_sel = rm.tx_sel
        filler_pos = rm.filler_pos
        has_repeats = bool(np.unique(cw_sel).size < cw_sel.size)
    else:
        tx_bits = coding.tx_bits if coding.tx_bits is not None else n
        if not (1 <= tx_bits <= n):
            raise ValueError(f"tx_bits must be in [1, n={n}]: {tx_bits}")
        # circular-buffer window for this redundancy version (same RE positions
        # for every RV — only WHICH code bits ride them changes)
        cw_sel = (coding.rv * tx_bits + np.arange(tx_bits)) % n
    c_words = total // tx_bits
    if c_words < 1:
        raise ValueError(
            f"allocation carries {total} scored bits < one {tx_bits}-bit transmission"
        )
    rng = np.random.default_rng(coding.interleave_seed)
    perm = rng.permutation(total)[: c_words * tx_bits]
    plan = make_ldpc_plan(coding.code)
    return TransportLayout(
        mask=mask, perm=perm, c_words=c_words, total=total, k=plan.k, n=n,
        tx_bits=tx_bits, cw_sel=cw_sel, filler_pos=filler_pos,
        has_repeats=has_repeats,
    )


def scramble_planes(
    c_init: int, n_sc: int, n_sym: int, n_layers: int, nbits: int
) -> np.ndarray:
    """Scrambling bits aligned with a (n_sc, n_sym, n_layers, nbits)
    payload-bit grid: layer l consumes the l-th length-L window of one
    TS 38.211 Gold stream (gold_sequence(c_init, n_layers*L)[l*L:(l+1)*L]) —
    independent per-layer streams, the convention
    utils/synthetic.make_mimo_case transmits with.

    Deliberate deviation from TS 38.211 §6.3.1.1 (which scrambles the
    per-codeword BIT STREAM before layer mapping, not per-(sc, sym, layer)
    grid planes): this framework scrambles after placement so the planes are
    static per geometry and the device-side descramble is a sign flip on the
    LLR grid. TX and RX share this one implementation so the chain is
    self-consistent; bit-exact §6.3.1.1 conformance against external NR
    vectors would need the pre-layer-mapping order (same Gold generator)."""
    from .ops import sequences

    n = n_sc * n_sym * nbits
    c = sequences.gold_sequence(int(c_init), n_layers * n)
    planes = [c[l * n : (l + 1) * n].reshape(n_sc, n_sym, nbits) for l in range(n_layers)]
    return np.stack(planes, axis=2)  # (n_sc, n_sym, n_layers, nbits)


def place_codewords(
    lay: TransportLayout,
    codewords: np.ndarray,
    n_layers: int,
    nbits: int,
    fill_rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Transmitter side: scatter encoded words into a PRE-scrambling payload
    bit grid (n_sc, n_sym, n_layers, nbits). Positions the codewords don't
    fill get random bits from `fill_rng` (zeros if None)."""
    codewords = np.asarray(codewords, np.uint8).reshape(lay.c_words, lay.n)
    stream = (
        fill_rng.integers(0, 2, lay.total, dtype=np.uint8)
        if fill_rng is not None
        else np.zeros(lay.total, np.uint8)
    )
    stream[lay.perm] = codewords[:, lay.cw_sel].reshape(-1)
    n_sc, n_sym = lay.mask.shape
    bits = np.zeros((n_sc, n_sym, n_layers, nbits), np.uint8)
    bits[lay.mask] = stream.reshape(-1, n_layers, nbits)
    return bits


def extract_streams(lay: TransportLayout, llr_grid: np.ndarray) -> np.ndarray:
    """Receiver side: pull the (c_words, n) codeword LLRs out of a
    (n_sc, n_sym, n_layers, nbits) LLR grid (int8 or float; already
    descrambled). Exact inverse of `place_codewords`' position mapping;
    codeword positions this RV did not transmit come back as LLR 0
    (erasures — IR-HARQ retransmissions fill them via `combine_llrs`).

    "nr" rate matching extras: repeated positions (E beyond one circular-buffer
    pass) soft-combine (int8 combines in int16 headroom and re-saturates), and
    known-zero filler positions are pinned to the maximum positive LLR."""
    flat = np.asarray(llr_grid)[lay.mask].reshape(-1)
    sub = flat[lay.perm].reshape(lay.c_words, lay.tx_bits)
    is_int8 = sub.dtype == np.int8
    if lay.has_repeats:
        acc_dt = np.int16 if is_int8 else sub.dtype
        out = np.zeros((lay.c_words, lay.n), acc_dt)
        np.add.at(out, (np.arange(lay.c_words)[:, None], lay.cw_sel[None, :]), sub)
        if is_int8:
            out = np.clip(out, -127, 127).astype(np.int8)
    else:
        out = np.zeros((lay.c_words, lay.n), sub.dtype)
        out[:, lay.cw_sel] = sub
    if lay.filler_pos is not None and lay.filler_pos.size:
        big = 127 if is_int8 else max(1.0, float(np.abs(sub).max())) * 16.0
        out[:, lay.filler_pos] = big
    return out


def device_extract_tables(
    lay: TransportLayout, nbits: int, n_layers: int, n_sym: int, n_sc: int
) -> dict:
    """Static gather tables for the ON-DEVICE mirror of `extract_streams`
    (serving.process(decode_on_device=True)): the receiver's per-bit LLR
    planes are laid out (nL, n_sym, n_sc) on device, and stacking int8 planes
    in-graph is the measured-slow path (ARCHITECTURE.md int8 trap) — so the
    deinterleave is expressed as one full-stream gather PER BIT PLANE plus a
    bit-select, and the rate recovery as r_max gathers (repeat positions
    soft-combine by addition), never a scatter (the slowest primitive on
    this backend).

      src    (n_stream,) int32 — per stream position, the flat index into a
             (nL, n_sym, n_sc) plane
      bit    (n_stream,) int8  — which bit plane that position reads
      inv    (r_max, n)  int32 — per codeword position, its stream columns
             (index into [0, tx_bits]; tx_bits = a zero pad column, so
             erasures and sub-r_max repeat counts contribute 0)
      filler (n,) bool         — known-zero filler positions (pinned to a
             large positive LLR after recovery, mirroring extract_streams)
    """
    sc_i, sym_i = np.nonzero(lay.mask)  # C-order over (sc, sym): the exact
    # iteration order of llr_grid[lay.mask] in extract_streams
    f = np.asarray(lay.perm, np.int64)  # stream j reads flat position f[j]
    m = f // (n_layers * nbits)
    rem = f % (n_layers * nbits)
    l = rem // nbits
    b = rem % nbits
    src = ((l * n_sym + sym_i[m]) * n_sc + sc_i[m]).astype(np.int32)
    cw = np.asarray(lay.cw_sel, np.int64)  # (tx_bits,) codeword position per col
    order = np.argsort(cw, kind="stable")
    counts = np.bincount(cw, minlength=lay.n)
    r_max = int(counts.max()) if counts.size else 1
    inv = np.full((max(r_max, 1), lay.n), lay.tx_bits, np.int32)  # pad column
    seen: dict = {}
    for k in order:
        i = cw[k]
        r = seen.get(i, 0)
        inv[r, i] = k
        seen[i] = r + 1
    filler = np.zeros(lay.n, bool)
    if lay.filler_pos is not None and lay.filler_pos.size:
        filler[lay.filler_pos] = True
    return {"src": src, "bit": b.astype(np.int8), "inv": inv, "filler": filler}


# --- CRC attachment (TS 38.212 §5.1) -------------------------------------

_CRC_POLYS = {
    # name: (degree, generator polynomial WITHOUT the leading x^deg term)
    "crc24a": (24, 0x864CFB),
    "crc24b": (24, 0x800063),
    "crc16": (16, 0x1021),
    "crc11": (11, 0x621),
    "crc6": (6, 0x61),
}


def crc_bits(bits: np.ndarray, kind: str) -> np.ndarray:
    """CRC parity bits for message `bits` (..., m) in {0,1}, MSB-first
    (TS 38.212 §5.1 conventions: a0 is the highest-order coefficient and the
    parity bits follow the message). Vectorized over leading axes."""
    deg, poly = _CRC_POLYS[kind]
    b = np.asarray(bits, np.uint8)
    lead = b.shape[:-1]
    b = b.reshape(-1, b.shape[-1])
    reg = np.zeros(b.shape[0], np.uint64)
    gen = np.uint64(poly)
    top = np.uint64(1) << np.uint64(deg - 1)
    mask = (np.uint64(1) << np.uint64(deg)) - np.uint64(1)
    for j in range(b.shape[1]):
        fb = ((reg & top) != 0).astype(np.uint64) ^ b[:, j].astype(np.uint64)
        reg = ((reg << np.uint64(1)) & mask) ^ (fb * gen)
    out = np.empty(b.shape[:1] + (deg,), np.uint8)
    for i in range(deg):
        out[:, i] = ((reg >> np.uint64(deg - 1 - i)) & np.uint64(1)).astype(np.uint8)
    return out.reshape(lead + (deg,))


def crc_attach(bits: np.ndarray, kind: str) -> np.ndarray:
    """Append the CRC parity to message bits: (..., m) -> (..., m + deg)."""
    return np.concatenate([np.asarray(bits, np.uint8), crc_bits(bits, kind)], axis=-1)


def crc_check(bits: np.ndarray, kind: str) -> np.ndarray:
    """True where the trailing CRC of (..., m + deg) words verifies."""
    deg, _ = _CRC_POLYS[kind]
    b = np.asarray(bits, np.uint8)
    return np.all(crc_bits(b[..., :-deg], kind) == b[..., -deg:], axis=-1)


def payload_bits(coding: TransportCoding, k: int) -> int:
    """Usable payload bits per codeword: code dimension k minus fillers and CRC.

    Raises when fillers + CRC leave no room for payload — the decoded-serving
    path would otherwise slice with a non-positive bound and silently return
    empty payloads."""
    deg = _CRC_POLYS[coding.crc][0] if coding.crc is not None else 0
    p = k - coding.n_filler - deg
    if p <= 0:
        raise ValueError(
            f"code dimension k={k} leaves no payload after {coding.n_filler} "
            f"fillers and {coding.crc or 'no'} CRC ({deg} parity bits)"
        )
    return p


def combine_llrs(llr_list) -> np.ndarray:
    """HARQ chase combining: sum soft bits across retransmissions of the SAME
    codeword placement (TS 38.214-style HARQ with identical redundancy — each
    retransmission's LLR grid is extracted with the same TransportLayout, then
    added; min-sum consumes the combined beliefs, worth ~10*log10(n_tx) dB of
    effective SNR).

    llr_list: sequence of int8 or float LLR arrays (same shape, already
    descrambled per-transmission). int8 inputs combine in int16 headroom and
    re-saturate to the int8 range [-127, 127]; float inputs sum exactly."""
    arrs = [np.asarray(a) for a in llr_list]
    assert len(arrs) >= 1 and all(a.shape == arrs[0].shape for a in arrs)
    if all(a.dtype == np.int8 for a in arrs):
        acc = np.zeros(arrs[0].shape, np.int16)
        for a in arrs:
            acc += a.astype(np.int16)
        return np.clip(acc, -127, 127).astype(np.int8)
    acc = np.zeros(arrs[0].shape, np.float64)
    for a in arrs:
        acc += a.astype(np.float64)
    return acc
