"""Serving front-end: plan-bucketed batching over heterogeneous problem streams.

The reference processes one (grid, pilots, config) problem per Python call. A
production estimator serves *streams* of problems from many cells/UEs/slots whose
configurations differ — but compiled executables are per-configuration (static shapes).
This module is the piece in between:

  1. group incoming problems by plan signature (hop1, hop2, config, n_layers) —
     identical signatures share one compiled executable (models/plan.make_plan
     lru cache + estimator._build_ri_cached);
  2. pack each group into fixed-size batches (padding the tail batch by repetition
     so no shape ever compiles twice);
  3. run the batched ri-layout executable per bucket and scatter results back into
     submission order.

This is the SURVEY.md §2.3 "batched front-end over (cell, UE, port, slot) problem
tuples" component and the BASELINE.json "4096 concurrent estimations" use case as
an API. Pure host-side orchestration — the compute path is exactly
estimator.build_ri.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .config import EstimatorConfig, HopConfig
from .models import estimator

try:  # native multithreaded batch packer (C++, srsran_ce/native)
    from .native import loader as _native
except Exception:  # pragma: no cover - no compiler available
    _native = None


def _assemble(arrays) -> np.ndarray:
    """B scattered complex problems -> one contiguous (B, 2, ...) f32 ri batch."""
    if _native is not None:
        try:
            return _native.assemble_batch_ri(arrays)
        except Exception:
            pass
    return np.stack([estimator.split_ri(np.asarray(a).astype(np.complex64)) for a in arrays])


@dataclass
class Problem:
    """One estimation request (mirrors the reference call signature,
    ce_rule_baseline.py:761-768).

    received_rg is (n_sc, n_sym) complex — one RX antenna port, the reference
    contract — or (n_rx, n_sc, n_sym) for a multi-port request (meaningful with
    `process(out="equalized")`, which jointly MMSE-equalizes across ports; the
    estimation paths process port 0 ... port n-1 as independent problems would).
    """

    received_rg: np.ndarray  # (n_sc, n_sym) or (n_rx, n_sc, n_sym) complex
    pilots: np.ndarray  # (n_re, n_dsym, n_layers) complex
    beta: float
    hop1: HopConfig
    hop2: Optional[HopConfig]
    config: EstimatorConfig

    @property
    def n_rx(self) -> int:
        return 1 if self.received_rg.ndim == 2 else int(self.received_rg.shape[0])

    def signature(self) -> Tuple:
        hop2 = None if (self.hop2 is not None and self.hop2.is_empty) else self.hop2
        return (self.hop1, hop2, self.config, int(self.pilots.shape[-1]), self.n_rx)


@dataclass
class ServeResult:
    """Host-side per-problem result (complex channel grid, reference layout)."""

    channel_est_rg: np.ndarray  # (n_sc, n_sym, n_layers) complex64
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float


@dataclass
class FactoredServeResult:
    """Per-problem result in rank-1 factored form (`process(out="factored")`).

    The dense grid equals `profiles[h, l, sc] * sym_rot[sym]` over hop h's
    allocated symbols and zero elsewhere (estimator.FactoredResult) — ~n_sym x
    (14x) less device->host transfer than the dense grid, which dominates
    serving cost on transfer-bound links. Call `.dense()` only where a full grid
    is genuinely needed; an equalizer can instead apply `sym_rot` as its own
    per-symbol scalar pass.
    """

    profiles: np.ndarray  # (n_hops, n_layers, n_sc) complex64 — zero outside band
    sym_rot: np.ndarray  # (n_sym,) complex64
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float
    hop1: HopConfig = None  # hop extents, needed by .dense()
    hop2: Optional[HopConfig] = None

    def dense(self) -> np.ndarray:
        """(n_sc, n_sym, n_layers) complex grid, reference layout."""
        return estimator.reconstruct_factored(
            self.profiles,
            self.sym_rot,
            self.hop1,
            self.hop2,
            n_sym=int(self.sym_rot.shape[0]),
        )


@dataclass
class EqualizedServeResult:
    """Per-problem output of `process(out="equalized")`: the joint multi-RX
    receiver's equalized data symbols instead of the channel grid (the grid
    stays on device — n_rx x less device->host transfer at n_rx >= nL)."""

    x: np.ndarray  # (n_sc, n_sym, n_layers) complex64 — noise-normalized symbols
    sinr: np.ndarray  # (n_sc, n_sym, n_layers) float32 — post-MMSE SINR (linear)
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float


@dataclass
class LlrServeResult:
    """Per-problem output of `process(out="llrs", modulation=...)`: int8 soft
    bits straight off the device — the receiver chain's final product (what a
    PHY hands to LDPC rate recovery). Neither the channel grid nor the
    equalized symbols cross the host boundary: nbits bytes/RE vs 8 for
    complex64 symbols (4x less at QPSK) and zero host-side demap work."""

    llr: np.ndarray  # (n_sc, n_sym, n_layers, nbits) int8 — round(llr*scale), +-127 clip
    sinr: np.ndarray  # (n_sc, n_sym, n_layers) float32 — post-MMSE SINR (linear)
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float
    llr_scale: float = 8.0

    def llrs_float(self) -> np.ndarray:
        """Dequantized LLRs (float32) — saturated at +-127/llr_scale."""
        return self.llr.astype(np.float32) / self.llr_scale


@dataclass
class DecodedServeResult:
    """Per-problem output of `process(out="decoded", modulation=...,
    coding=...)`: the chain's true endpoint — DECODED payload bits. The
    receiver's int8 LLR grid is descrambled (sign flips, when the coding
    carries a scramble_c_init), deinterleaved into codeword streams
    (transport.extract_streams) and min-sum decoded (ops/ldpc, words batched
    across all problems sharing a code)."""

    info: np.ndarray  # (c_words, k) uint8 — decoded systematic payloads
    ok: np.ndarray  # (c_words,) bool — parity check per codeword
    # the underlying soft-bit result (LLR grid + measurements); None when the
    # chain ran fully on device (decode_on_device=True — the LLR grid never
    # crosses the host link, only the decoded bits do)
    soft: Optional[LlrServeResult]
    # the receiver's measurement scalars, populated on the device-resident
    # path (where soft is None; scalars are a few floats — the host path
    # exposes the same values through soft.*)
    noise_est: Optional[float] = None
    rsrp: Optional[float] = None
    epre: Optional[float] = None
    time_alignment: Optional[float] = None
    cfo_hz: Optional[float] = None


def _hop1_pilot_estimates(problem: Problem):
    """Raw LS pilot estimates on CDM group 0 of hop 1, shared by the host-side
    measurement probes: (m, n_dsym) complex128 (pair-averaged onto the decimated
    lattice when the group carries two OCC'd layers), the pilot-lattice spacing
    df (Hz), and the hop plan."""
    from .models.plan import make_plan

    n_layers = int(problem.pilots.shape[-1])
    plan = make_plan(problem.hop1, problem.hop2, problem.config, n_layers)
    hp = plan.hop1
    rg = np.asarray(problem.received_rg)
    if rg.ndim == 3:
        rg = rg[0]  # measurement probes sample RX port 0 (same physical link)
    pil = np.asarray(problem.pilots).astype(np.complex128)
    h = rg[hp.re_idx[0][:, None], hp.dmrs_sym_idx[None, :]] * np.conj(pil[:, : hp.n_dsym, 0])
    h = h / max(abs(float(problem.beta)), 1e-30)
    sc = hp.re_idx[0].astype(np.int64)
    comb = int(np.median(np.diff(sc))) if sc.size > 1 else 1
    df = comb * plan.scs_hz
    l0, l1 = hp.layer_slices[0]
    if l1 - l0 == 2 and h.shape[0] % 2 == 0:
        # OCC'd partner layer cancels under adjacent-pair averaging; the
        # decimated lattice doubles the spacing.
        h = 0.5 * (h[0::2] + h[1::2])
        df *= 2.0
    return h, df, hp


def estimate_delay_spread(problem: Problem) -> float:
    """RMS delay spread (seconds) of one problem, from its raw pilot estimates.

    Host-side numpy (runs before bucketing, no device round-trip): raw LS
    de-spread on CDM group 0 of hop 1, time-averaged over its DM-RS symbols
    (pair-averaged when the group carries two OCC'd layers), then the second
    moment of the delay-domain power profile — IFFT over the pilot lattice,
    noise floor from the median bin (noise bins are exponential: median =
    sigma^2 ln 2), bins kept above max(6x floor, 2% of peak) within a +-m/8
    window of the peak, circular first moment for the centroid. Returns 0.0
    for channels flat below the lattice's delay resolution.

    Accuracy (synthetic TDL, 52 PRB comb-2): median within +-35% of the
    realization's true rms delay spread for tau in [50 ns, 1 us] at 0-10 dB
    SNR; exact 0 for single-tap channels. Used by `process`'s
    wiener_auto_delay mode to serve each problem with a matched MMSE prior —
    a mismatched `wiener_delay_spread_s` costs up to 5-8 dB channel NMSE.
    """
    ht, df, _ = _hop1_pilot_estimates(problem)
    h = np.mean(ht, axis=1)  # time-average over the hop's DM-RS symbols
    m = h.size
    if m < 8:
        return 0.0

    z = np.fft.ifft(h)
    p = np.abs(z) ** 2
    floor = float(np.median(p)) / np.log(2.0)
    pk = int(np.argmax(p))
    if p[pk] < 8.0 * floor:
        return 0.0  # no channel power resolvable above the noise floor
    thr = max(6.0 * floor, 0.02 * p[pk])
    dist_pk = (np.arange(m) - pk + m // 2) % m - m // 2
    ps = np.where((p > thr) & (np.abs(dist_pk) <= m // 8), p - floor, 0.0)
    w = ps / ps.sum()
    ang = float(np.angle(np.sum(w * np.exp(2j * np.pi * np.arange(m) / m))))
    b0 = ang / (2.0 * np.pi) * m
    dist = (np.arange(m) - b0 + m / 2.0) % m - m / 2.0
    return float(np.sqrt(np.sum(w * dist**2)) / (m * df))


def estimate_doppler(problem: Problem) -> float:
    """Doppler spread (Hz, uniform-spread model half-width F) of one problem.

    Host-side numpy companion to `estimate_delay_spread`, for the time axis:
    per-DM-RS-symbol LS estimates (CDM group 0, pair-averaged) give the
    time-correlation magnitudes |r(Δt)| across all symbol pairs; under a
    uniform per-tap Doppler model (f ~ U[-F, F], ρ(Δt) = sinc(2FΔt)) the
    small-angle expansion log|r| = log p - (2πF)²Δt²/6 is a line in Δt², so a
    least-squares fit over the pairs separates the power intercept from the
    decay slope — no noise-variance estimate needed when the hop has ≥ 3 DM-RS
    symbols (2-symbol hops fall back to a noise-corrected single-ratio).
    Magnitudes are CFO-invariant (CFO rotates whole symbols). Jakes max
    Doppler ≈ 1.22 F. Returns 0.0 for single-DM-RS-symbol hops.

    Accuracy (synthetic, 10 dB SNR, 52 PRB): medians 0/72/234/519 Hz for true
    F = 0/100/300/600 — a reliable ordering signal for `process`'s
    auto_time_interp_hz mode-selection threshold.
    """
    h, _, hp = _hop1_pilot_estimates(problem)
    if hp.n_dsym < 2:
        return 0.0

    cfg = problem.config
    cpds = cfg.cp_durations_np * cfg.scs_hz / 1000.0  # symbol-duration units
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    t = np.cumsum(vec)[hp.dmrs_sym_idx] / cfg.scs_hz  # seconds

    n = hp.n_dsym
    xs, ys = [], []
    for j in range(n):
        for k in range(j + 1, n):
            r = np.abs(np.mean(h[:, k] * np.conj(h[:, j])))
            xs.append((t[k] - t[j]) ** 2)
            ys.append(np.log(max(r, 1e-30)))
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    if np.unique(np.round(xs, 16)).size >= 2:
        b = np.polyfit(xs, ys, 1)[0]
        return float(np.sqrt(max(-b, 0.0) * 6.0) / (2.0 * np.pi))
    # single pair gap: noise-correct the power from frequency-adjacent diffs
    sig2 = float(np.mean(np.abs(np.diff(h[:, 0])) ** 2)) / 2.0
    p = max(float(np.mean(np.abs(h) ** 2)) - sig2, 1e-30)
    ratio = min(float(np.exp(ys[0])) / p, 1.0 - 1e-9)
    return float(np.sqrt(max(-np.log(ratio), 0.0) * 6.0) / (2.0 * np.pi * np.sqrt(xs[0])))


def _snap_wiener_delay(problems: List[Problem], grid) -> List[Problem]:
    """Replace each wiener problem's delay-spread prior with the nearest grid
    value (log-spaced snap) to its measured delay spread. The grid bounds the
    number of distinct plan signatures (compiled executables)."""
    import dataclasses as _dc

    taus = np.asarray(sorted(float(t) for t in grid), np.float64)
    assert taus.size > 0 and np.all(taus > 0), "wiener_auto_delay needs positive taus"
    out = []
    for p in problems:
        if p.config.smoothing == "wiener":
            t_hat = max(estimate_delay_spread(p), float(taus[0]))
            best = float(taus[np.argmin(np.abs(np.log(taus) - np.log(t_hat)))])
            p = _dc.replace(p, config=_dc.replace(p.config, wiener_delay_spread_s=best))
        out.append(p)
    return out


def _merge_batch(ch_ri: np.ndarray) -> np.ndarray:
    """(B, 2, ...) ri batch -> (B, ...) complex: the native threaded interleave
    when available (~4x the numpy view-assignment pass, which itself is ~2.5x a
    per-problem merge loop); numpy fallback otherwise and for float64."""
    if _native is not None and ch_ri.dtype == np.float32:
        try:
            return _native.ri_to_complex(np.ascontiguousarray(ch_ri))
        except Exception:
            pass
    cdt = np.complex128 if ch_ri.dtype == np.float64 else np.complex64
    out = np.empty(ch_ri.shape[:1] + ch_ri.shape[2:], cdt)
    out.real = ch_ri[:, 0]
    out.imag = ch_ri[:, 1]
    return out


def _scatter_out_factored(out, chunk, results, sig) -> None:
    """Fetch one factored batch and scatter per-problem FactoredServeResults."""
    hop1, hop2 = sig
    prof = _merge_batch(np.asarray(out.profiles))  # (B, n_hops, nL, n_sc) complex
    rot = _merge_batch(np.asarray(out.sym_rot))  # (B, n_sym) complex
    noise = np.asarray(out.noise_est)
    rsrp = np.asarray(out.rsrp)
    epre = np.asarray(out.epre)
    ta = np.asarray(out.time_alignment)
    cfo = np.asarray(out.cfo_hz)
    for k, i in enumerate(chunk):
        results[i] = FactoredServeResult(
            profiles=prof[k],
            sym_rot=rot[k],
            noise_est=float(noise[k]),
            rsrp=float(rsrp[k]),
            epre=float(epre[k]),
            time_alignment=float(ta[k]),
            cfo_hz=float(cfo[k]),
            hop1=hop1,
            hop2=hop2,
        )


def _scatter_out_equalized(out, chunk, results, sig, factored) -> None:
    """Fetch one receiver batch and scatter per-problem EqualizedServeResults.

    The factored receiver reports SINR per (hop, layer, sc) — time-invariant
    within a hop — which is expanded host-side onto the (sc, sym, layer) grid
    (a broadcast, not a recompute) so both receiver modes present one layout."""
    hop1, hop2 = sig
    x = _merge_batch(np.asarray(out.x))  # (B, nL, n_sym, n_sc) complex
    sinr = np.asarray(out.sinr)
    noise = np.asarray(out.noise_est)
    rsrp = np.asarray(out.rsrp)
    epre = np.asarray(out.epre)
    ta = np.asarray(out.time_alignment)
    cfo = np.asarray(out.cfo_hz)
    nL, n_sym, n_sc = x.shape[1], x.shape[2], x.shape[3]
    hop_cfgs = [hop1] + ([hop2] if hop2 is not None else [])
    for k, i in enumerate(chunk):
        xg = np.moveaxis(x[k], (0, 1, 2), (2, 1, 0))  # (n_sc, n_sym, nL)
        results[i] = EqualizedServeResult(
            x=xg,
            sinr=_expand_sinr_grid(sinr[k], n_sc, n_sym, nL, hop_cfgs, factored),
            noise_est=float(noise[k]),
            rsrp=float(rsrp[k]),
            epre=float(epre[k]),
            time_alignment=float(ta[k]),
            cfo_hz=float(cfo[k]),
        )


def _expand_sinr_grid(sinr_k, n_sc, n_sym, n_layers, hop_cfgs, factored):
    """One problem's receiver SINR -> (n_sc, n_sym, nL) float32 grid (the
    factored form is time-invariant per hop; expansion is a host broadcast)."""
    if factored:
        sg = np.zeros((n_sc, n_sym, n_layers), np.float32)
        for h, hc in enumerate(hop_cfgs):
            s0, s1 = hc.start_symbol, hc.start_symbol + hc.n_allocated_symbols
            sg[:, s0:s1, :] = sinr_k[h].T[:, None, :]
        return sg
    return np.moveaxis(sinr_k, (0, 1, 2), (2, 1, 0)).astype(np.float32)


def _scatter_out_llrs(out, chunk, results, sig, factored, llr_scale) -> None:
    """Fetch one LLR-receiver batch and scatter per-problem LlrServeResults."""
    hop1, hop2 = sig
    # out.llr is a tuple of per-bit (B, nL, n_sym, n_sc) int8 planes (separate
    # device outputs — see models/receiver.LlrResult); stacking is host-side
    llr = np.stack([np.asarray(p) for p in out.llr], axis=1)  # (B, nbits, nL, sym, sc)
    sinr = np.asarray(out.sinr)
    noise = np.asarray(out.noise_est)
    rsrp = np.asarray(out.rsrp)
    epre = np.asarray(out.epre)
    ta = np.asarray(out.time_alignment)
    cfo = np.asarray(out.cfo_hz)
    n_sym, n_sc = llr.shape[3], llr.shape[4]
    hop_cfgs = [hop1] + ([hop2] if hop2 is not None else [])
    for k, i in enumerate(chunk):
        results[i] = LlrServeResult(
            llr=np.moveaxis(llr[k], (0, 1, 2, 3), (3, 2, 1, 0)),  # (sc, sym, nL, bits)
            sinr=_expand_sinr_grid(sinr[k], n_sc, n_sym, llr.shape[2], hop_cfgs, factored),
            noise_est=float(noise[k]),
            rsrp=float(rsrp[k]),
            epre=float(epre[k]),
            time_alignment=float(ta[k]),
            cfo_hz=float(cfo[k]),
            llr_scale=llr_scale,
        )


def _scatter_out(out, chunk, results) -> None:
    """Fetch one dispatched batch from the device and scatter per-problem results."""
    ch = _merge_batch(np.asarray(out.channel_est_rg))  # (B, nL, n_sym, n_sc) complex
    noise = np.asarray(out.noise_est)
    rsrp = np.asarray(out.rsrp)
    epre = np.asarray(out.epre)
    ta = np.asarray(out.time_alignment)
    cfo = np.asarray(out.cfo_hz)
    for k, i in enumerate(chunk):
        grid = ch[k]  # (nL, n_sym, n_sc) complex view
        results[i] = ServeResult(
            channel_est_rg=np.moveaxis(grid, (0, 1, 2), (2, 1, 0)),
            noise_est=float(noise[k]),
            rsrp=float(rsrp[k]),
            epre=float(epre[k]),
            time_alignment=float(ta[k]),
            cfo_hz=float(cfo[k]),
        )


_DEVICE_DECODE_CACHE: Dict[Tuple, object] = {}


def _device_decode_builder(coding, lay, nbits: int, n_layers: int, n_sym: int, n_sc: int):
    """Jitted ON-DEVICE descramble -> deinterleave -> rate-recover -> decode
    for one (geometry, coding) bucket: fn(llr_planes) -> (info, ok).

    The host-side _decode_soft fetches the full int8 LLR grid (the largest
    transfer of the decoded chain), deinterleaves in numpy and
    re-uploads (c_words, n) float words to the decoder; this mirror keeps
    everything device-resident — per-bit sign flips for scrambling, one
    full-stream gather per bit plane (int8 plane stacking is the measured
    2.3 ms trap; gathers run in f32), r_max rate-recovery gathers (repeats
    soft-combine; erasures and filler mirror transport.extract_streams), and
    the min-sum decode in the SAME program. Only (B, c_words, k) info bits
    and the parity flags cross the host link.
    """
    import jax

    from . import transport as _tr
    from .ops import ldpc as _ldpc

    tabs = _tr.device_extract_tables(lay, nbits, n_layers, n_sym, n_sc)
    sgn = None
    if coding.scramble_c_init is not None:
        pl = _tr.scramble_planes(
            coding.scramble_c_init, n_sc, n_sym, n_layers, nbits
        )  # (n_sc, n_sym, nL, nbits) 0/1
        # per-bit (nL, n_sym, n_sc) sign planes
        sgn = [
            jnp.asarray(
                (1.0 - 2.0 * pl[..., b].astype(np.float32)).transpose(2, 1, 0)
            )
            for b in range(nbits)
        ]
    dec = _ldpc.build_decoder(
        coding.code, n_iters=coding.n_iters, norm=coding.norm,
        kernels=coding.kernels, schedule=getattr(coding, "schedule", "flooding"),
        layered_group=getattr(coding, "layered_group", 1),
        stream_c2v_dtype=getattr(coding, "stream_c2v_dtype", None),
    )
    inv = jnp.asarray(tabs["inv"])  # (r_max, n) into [0, tx_bits]
    filler = jnp.asarray(tabs["filler"])  # (n,) bool
    c_words, tx_bits, n_code = lay.c_words, lay.tx_bits, lay.n

    # fold the bit-plane choice into ONE flat index over the concatenated
    # planes, and gather along the MAJOR axis of a batch-LAST frame — the
    # same layout rule the LDPC gather tier measured 2-5x faster than
    # batch-leading index gathers on this backend
    plane_len = n_layers * n_sym * n_sc
    src_all = jnp.asarray(
        np.asarray(tabs["bit"], np.int64) * plane_len + np.asarray(tabs["src"], np.int64)
    )

    @jax.jit
    def run(planes):
        B = planes[0].shape[0]
        ps = [p.astype(jnp.float32) for p in planes]
        if sgn is not None:
            ps = [p * s for p, s in zip(ps, sgn)]
        # (nbits*plane_len, B) batch-last flat frame
        flat = jnp.concatenate([p.reshape(B, -1) for p in ps], axis=1).T
        stream = jnp.take(flat, src_all, axis=0)  # (c_words*tx_bits, B)
        subp = jnp.concatenate(
            [
                stream.reshape(c_words, tx_bits, B),
                jnp.zeros((c_words, 1, B), jnp.float32),
            ],
            axis=1,
        )
        post = jnp.take(subp, inv[0], axis=1)  # (c_words, n, B)
        for r in range(1, inv.shape[0]):
            post = post + jnp.take(subp, inv[r], axis=1)
        if inv.shape[0] > 1:
            # repeats soft-combined: re-saturate to the int8 range, exactly
            # like extract_streams' int16-accumulate-then-clip (the planes
            # are int8-quantized, so unclipped f32 sums would give repeats
            # more weight than the host path and diverge on marginal words)
            post = jnp.clip(post, -127.0, 127.0)
        # known-zero fillers: pinned, not combined, at the int8 maximum
        # (mirrors extract_streams' int8 branch bit for bit)
        post = jnp.where(
            filler[None, :, None], jnp.asarray(127.0, jnp.float32), post
        )
        # decoder contract is batch-leading (B*c_words, n); it transposes to
        # its own batch-last frame internally
        res = dec(jnp.transpose(post, (2, 0, 1)).reshape(B * c_words, n_code))
        # Bit-PACK the payload for the host link (8x smaller than one uint8
        # per bit — the info fetch is the device path's largest transfer) and
        # piggyback the parity flag as a trailing byte per word, so decoded
        # results cost ONE uint8 fetch (+ the stacked scalar row) per chunk.
        # Big-endian bit order matches np.unpackbits' default.
        info = res.info.reshape(B, c_words, -1)
        k = info.shape[-1]
        k8 = -(-k // 8) * 8
        if k8 != k:
            info = jnp.pad(info, ((0, 0), (0, 0), (0, k8 - k)))
        w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
        packed = (
            (info.reshape(B, c_words, k8 // 8, 8).astype(jnp.int32) * w)
            .sum(-1)
            .astype(jnp.uint8)
        )
        ok_byte = res.ok.reshape(B, c_words, 1).astype(jnp.uint8)
        return (jnp.concatenate([packed, ok_byte], axis=-1),)

    return run


def _process_decoded_device(problems, coding, batch_size, matmul_precision,
                            data_beta, modulation, llr_scale, inflight,
                            params=None, wiener_auto_delay=None,
                            auto_time_interp_hz=None):
    """process(out='decoded', decode_on_device=True): the complete uplink
    chain per chunk in device residence; host fetches decoded bits + parity
    flags only (soft=None on the results). early_iters is ignored (the
    two-phase retry is host-driven and would require keeping words around);
    per-problem coding lists are not supported in this mode. The serving
    pre-passes (wiener_auto_delay snapping, auto_time_interp_hz promotion)
    and learned-smoothing params apply exactly as on the host decoded path."""
    import dataclasses as _dc
    from collections import deque

    from . import transport as _tr
    from .models import receiver as _receiver
    from .ops import demap as _demap

    if isinstance(coding, (list, tuple)):
        raise ValueError("decode_on_device supports a single shared coding")
    if wiener_auto_delay is not None:
        problems = _snap_wiener_delay(problems, wiener_auto_delay)
    if auto_time_interp_hz is not None:
        thr = float(auto_time_interp_hz)
        problems = [
            _dc.replace(p, config=_dc.replace(p.config, time_interp="linear"))
            if (
                p.config.time_interp == "none"
                and p.config.smoothing != "learned2d"
                and estimate_doppler(p) > thr
            )
            else p
            for p in problems
        ]
    nbits = _demap.bits_per_symbol(modulation)
    k_pay = _tr.payload_bits(coding, _tr.make_ldpc_plan(coding.code).k)
    k_full = _tr.make_ldpc_plan(coding.code).k
    k_eff = k_full - coding.n_filler

    buckets: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(problems):
        buckets.setdefault(p.signature(), []).append(i)
    results: List[Optional[DecodedServeResult]] = [None] * len(problems)
    pending: deque = deque()

    scal_names = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")

    def fetch(run_out, chunk):
        blob_b, scal = run_out
        blob = np.asarray(blob_b)  # (B, c_words, k8/8 + 1) uint8 — one transfer
        ok_h = blob[..., -1].astype(bool)
        info_h = np.unpackbits(blob[..., :-1], axis=-1)[..., :k_full]
        scal_a = np.asarray(scal)  # (5, B) in one transfer
        scal_h = {k2: scal_a[j] for j, k2 in enumerate(scal_names)}
        if coding.crc is not None:
            # ONE batched CRC pass per chunk: crc_check's bit-serial loop runs
            # over k_eff bits regardless of word count, so per-problem calls
            # would multiply its cost by B (measured ~25 ms x 8 per chunk)
            B = info_h.shape[0]
            ok_h = ok_h & _tr.crc_check(
                info_h[:, :, :k_eff].reshape(B * info_h.shape[1], k_eff),
                coding.crc,
            ).reshape(B, info_h.shape[1])
        for k, i in enumerate(chunk):
            info = info_h[k]
            if coding.crc is not None or coding.n_filler:
                info = info[:, :k_pay]
            results[i] = DecodedServeResult(
                info=info, ok=ok_h[k], soft=None,
                **{k2: float(v[k]) for k2, v in scal_h.items()},
            )

    for sig, idxs in buckets.items():
        hop1, hop2, config, n_layers, n_rx = sig
        if matmul_precision is not None:
            config = _dc.replace(config, matmul_precision=matmul_precision)
        learned = config.smoothing in ("learned", "learned2d")
        if learned:
            assert params is not None, f"smoothing={config.smoothing!r} needs params"
        fn = _receiver.build_receiver_ri(
            hop1, hop2, config, n_layers, n_rx, batched=True,
            data_beta=data_beta, modulation=modulation, llr_scale=llr_scale,
        )
        p0 = problems[idxs[0]]
        n_sc, n_sym = p0.received_rg.shape[-2], p0.received_rg.shape[-1]
        lay = _tr.layout(coding, hop1, hop2, n_sc, n_sym, n_layers, nbits)
        ck = (hop1, hop2, n_sc, n_sym, n_layers, nbits, coding)
        if ck not in _DEVICE_DECODE_CACHE:
            if len(_DEVICE_DECODE_CACHE) >= 64:
                # bounded like the other compile caches (lru_cache(64) on
                # build_decoder etc.): FIFO-evict so a long-running server
                # over many geometries cannot grow without bound
                _DEVICE_DECODE_CACHE.pop(next(iter(_DEVICE_DECODE_CACHE)))
            _DEVICE_DECODE_CACHE[ck] = _device_decode_builder(
                coding, lay, nbits, n_layers, n_sym, n_sc
            )
        run = _DEVICE_DECODE_CACHE[ck]

        def _rg(p: Problem):
            return (
                np.asarray(p.received_rg)[None]
                if p.received_rg.ndim == 2
                else p.received_rg
            )

        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            pad = batch_size - len(chunk) if len(idxs) > batch_size else 0
            take = chunk + [chunk[-1]] * pad
            rg_b = _assemble([_rg(problems[i]) for i in take])
            pil_b = _assemble([problems[i].pilots for i in take])
            beta = np.asarray([problems[i].beta for i in take], np.float32)
            if learned:
                res_b = fn(rg_b, pil_b, jnp.asarray(beta), params)
            else:
                res_b = fn(rg_b, pil_b, jnp.asarray(beta))
            # one (5, B) array -> ONE device->host fetch for all scalars
            # (separate per-scalar np.asarray calls would each pay a transfer)
            scal = jnp.stack(
                [
                    jnp.asarray(res_b.noise_est, jnp.float32),
                    jnp.asarray(res_b.rsrp, jnp.float32),
                    jnp.asarray(res_b.epre, jnp.float32),
                    jnp.asarray(res_b.time_alignment, jnp.float32),
                    jnp.asarray(res_b.cfo_hz, jnp.float32),
                ]
            )
            out = run(tuple(res_b.llr)) + (scal,)
            pending.append((out, chunk))
            if len(pending) >= max(1, inflight):
                o, c = pending.popleft()
                fetch(o, c)
    while pending:
        o, c = pending.popleft()
        fetch(o, c)
    return results


def _decode_soft(
    problems: List[Problem],
    soft: "List[LlrServeResult]",
    coding,
    word_batch: int = 512,
) -> "List[DecodedServeResult]":
    """Decode served LLR grids into payloads (the out="decoded" tail).

    Host side: per-problem descramble + deinterleave (transport module), then
    ONE batched min-sum decode per fixed-size word chunk — words from all
    problems share the decoder executable (padding the tail chunk by
    repetition, the same no-second-compile rule as the estimation batches)."""
    from . import transport as _tr
    from .ops import ldpc as _ldpc

    sched = getattr(coding, "schedule", "flooding")
    group = getattr(coding, "layered_group", 1)
    c2v_dt = getattr(coding, "stream_c2v_dtype", None)
    dec = _ldpc.build_decoder(
        coding.code, n_iters=coding.n_iters, norm=coding.norm,
        kernels=coding.kernels, schedule=sched, layered_group=group,
        stream_c2v_dtype=c2v_dt,
    )
    early = coding.early_iters
    if early is not None and early < coding.n_iters:
        dec_early = _ldpc.build_decoder(
            coding.code, n_iters=early, norm=coding.norm,
            kernels=coding.kernels, schedule=sched, layered_group=group,
            stream_c2v_dtype=c2v_dt,
        )
    else:
        dec_early = None
    layouts: Dict[Tuple, _tr.TransportLayout] = {}
    planes: Dict[Tuple, np.ndarray] = {}
    streams: List[np.ndarray] = []
    counts: List[int] = []
    for p, s in zip(problems, soft):
        llr = s.llr  # (n_sc, n_sym, nL, nbits) int8
        n_sc, n_sym, n_layers, nbits = llr.shape
        key = (p.hop1, p.hop2, n_sc, n_sym, n_layers, nbits)
        if key not in layouts:
            layouts[key] = _tr.layout(
                coding, p.hop1, p.hop2, n_sc, n_sym, n_layers, nbits
            )
            if coding.scramble_c_init is not None:
                planes[key] = _tr.scramble_planes(
                    coding.scramble_c_init, n_sc, n_sym, n_layers, nbits
                )
        lay = layouts[key]
        if coding.scramble_c_init is not None:
            from .ops import demap as _demap

            llr = _demap.descramble_llrs(llr, planes[key])
        streams.append(_tr.extract_streams(lay, llr))
        counts.append(lay.c_words)
    words = np.concatenate(streams, axis=0)

    def run_chunks(decoder, w):
        # Every chunk is padded (by repetition) to a power-of-two bucket in
        # [32, word_batch], so the executable set stays bounded regardless of
        # the DATA-DEPENDENT word counts this sees — the early-termination
        # retry set size varies with the noise realization, and an unpadded
        # call would compile a fresh program per distinct failure count.
        infos, oks = [], []
        for start in range(0, w.shape[0], word_batch):
            chunk = w[start : start + word_batch]
            n = chunk.shape[0]
            bucket = 32
            while bucket < n:
                bucket *= 2
            bucket = min(bucket, word_batch)
            if n < bucket:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bucket - n, axis=0)]
                )
            r = decoder(chunk)
            infos.append(np.asarray(r.info)[:n])
            oks.append(np.asarray(r.ok)[:n])
        return np.concatenate(infos, axis=0), np.concatenate(oks, axis=0)

    if dec_early is not None:
        # two-phase early termination: converged words keep their early
        # decision (standard first-parity-pass semantics); only failures pay
        # the full iteration budget
        info, ok = run_chunks(dec_early, words)
        retry = np.nonzero(~ok)[0]
        if retry.size:
            info2, ok2 = run_chunks(dec, words[retry])
            info[retry] = info2
            ok[retry] = ok2
    else:
        info, ok = run_chunks(dec, words)
    k_eff = info.shape[1] - coding.n_filler  # systematic bits minus known-zero fillers
    if coding.crc is not None:
        # TS 38.212-style CRC gate: ok = LDPC parity AND CRC (computed over the
        # payload+CRC span, excluding fillers)
        ok = ok & _tr.crc_check(info[:, :k_eff], coding.crc)
    if coding.crc is not None or coding.n_filler:
        info = info[:, : _tr.payload_bits(coding, info.shape[1])]  # strip CRC+fillers
    out: List[DecodedServeResult] = []
    pos = 0
    for s, c in zip(soft, counts):
        out.append(DecodedServeResult(info=info[pos : pos + c], ok=ok[pos : pos + c], soft=s))
        pos += c
    return out


def process(
    problems: List[Problem],
    batch_size: int = 128,
    matmul_precision: Optional[str] = "high",
    params=None,
    inflight: int = 3,
    wiener_auto_delay=None,
    auto_time_interp_hz: Optional[float] = None,
    out: str = "grid",
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
    coding=None,
    decode_on_device: bool = False,
) -> "List[ServeResult] | List[FactoredServeResult] | List[EqualizedServeResult] | List[LlrServeResult] | List[DecodedServeResult]":
    """Estimate a heterogeneous list of problems; results in submission order
    (ServeResults, or FactoredServeResults with out="factored").

    Problems are bucketed by plan signature; each bucket runs in fixed
    `batch_size` chunks (the tail chunk is padded by repeating its last problem,
    so each signature compiles exactly one executable). `matmul_precision`
    overrides every problem's config precision for serving (None keeps each
    config's own setting). `params` is the denoiser pytree, required for
    problems whose config uses a learned smoothing mode (one shared pytree —
    mixed 1-D/2-D learned problems need separate process calls).

    Dispatch is pipelined: jit calls return before the device finishes, so up to
    `inflight` dispatched batches stay un-fetched while the host packs the next
    one (the native assembler and the device then run concurrently; fetching a
    result is what blocks). `inflight=1` restores strict pack -> run -> fetch
    serialization; the default keeps the device fed without holding more than a
    few batches of output in HBM.

    `wiener_auto_delay`: optional sequence of candidate delay spreads (seconds,
    e.g. (5e-8, 1.25e-7, 2.5e-7, 5e-7, 1e-6)). Each smoothing="wiener" problem
    gets its delay spread measured (`estimate_delay_spread`) and snapped to the
    nearest grid value, so every problem is served with a matched MMSE prior —
    runtime adaptivity via plan bucketing instead of in-graph branching (a
    vmapped lax.switch would execute every branch for every problem).

    `auto_time_interp_hz`: optional Doppler threshold (Hz). Problems whose
    measured Doppler spread (`estimate_doppler`) exceeds it are served with
    time_interp="linear" (per-DM-RS-symbol smoothing + time interpolation,
    ~3-4x the serve cost); static channels keep the cheap reference-style
    broadcast path. Same bucketing mechanism as wiener_auto_delay.

    `out="factored"` returns FactoredServeResults (profile + per-symbol rotation
    instead of the dense grid): ~1.7x faster on-device at the 106-PRB 4-port
    geometry and ~14x less device->host transfer. Requires every problem to use
    time_interp="none" (and is thus incompatible with auto_time_interp_hz).

    `out="equalized"` runs the joint multi-RX receiver (models/receiver) per
    problem: EqualizedServeResults carry the MMSE-equalized data symbols and
    per-RE SINR instead of the channel grid, which never leaves the device.
    Problems may carry (n_rx, n_sc, n_sym) grids (ports bucket separately);
    `data_beta` scales the data REs (DM-RS boost `beta` applies to pilots only).
    Each bucket picks the factored per-subcarrier filter automatically when its
    config has time_interp="none" (exact — see mmse_equalize_factored_serve).

    `out="llrs"` goes one step further down the chain: the exact max-log soft
    demapper (ops/demap, `modulation` required) runs inside the receiver
    program, and LlrServeResults carry int8 LLRs (quantized by `llr_scale`) —
    the final soft bits a PHY feeds to LDPC, with neither grids nor symbols
    crossing the transfer-bound host link.

    `out="decoded"` (requires `coding=transport.TransportCoding(...)`) runs
    the chain to its true endpoint: descramble -> deinterleave -> rate
    recovery -> batched min-sum decode -> CRC, returning
    DecodedServeResults. By default the LLR grids are fetched and the
    deinterleave runs host-side; `decode_on_device=True` keeps the whole
    post-pass in-graph per chunk — only decoded bits and parity flags cross
    the host link (its speed against the host path: PERF.md), soft=None, one
    shared coding required, early_iters ignored.
    """
    import dataclasses as _dc
    from collections import deque

    if out not in ("grid", "factored", "equalized", "llrs", "decoded"):
        raise ValueError(
            f"out must be 'grid', 'factored', 'equalized', 'llrs' or 'decoded': {out!r}"
        )
    if out in ("llrs", "decoded") and modulation is None:
        raise ValueError(f"out={out!r} requires modulation=")
    if out == "decoded":
        # `out="decoded"` = the llrs path + a host/device decode post-pass:
        # descramble -> deinterleave (transport layout) -> batched min-sum
        # (ops/ldpc). The coded-transport agreement comes in via `coding`
        # (transport.TransportCoding). With decode_on_device=True the whole
        # post-pass runs IN-GRAPH per chunk (descramble sign flips, gather
        # deinterleave, rate recovery, decode) and only the decoded bits +
        # parity flags cross the host link (soft=None on the results;
        # early_iters is ignored; one shared coding required).
        if coding is None:
            raise ValueError("out='decoded' requires coding=transport.TransportCoding(...)")
        if decode_on_device:
            return _process_decoded_device(
                problems, coding, batch_size, matmul_precision, data_beta,
                modulation, llr_scale, inflight, params=params,
                wiener_auto_delay=wiener_auto_delay,
                auto_time_interp_hz=auto_time_interp_hz,
            )
        soft = process(
            problems,
            batch_size=batch_size,
            matmul_precision=matmul_precision,
            params=params,
            inflight=inflight,
            wiener_auto_delay=wiener_auto_delay,
            auto_time_interp_hz=auto_time_interp_hz,
            out="llrs",
            data_beta=data_beta,
            modulation=modulation,
            llr_scale=llr_scale,
        )
        if isinstance(coding, (list, tuple)):
            # per-problem codings (e.g. per-UE scramble_c_init / code / RV):
            # group by the frozen coding value, decode each group's words
            # together, scatter back in submission order
            if len(coding) != len(problems):
                raise ValueError(
                    f"coding list length {len(coding)} != {len(problems)} problems"
                )
            results_d: List[Optional[DecodedServeResult]] = [None] * len(problems)
            groups: Dict[object, List[int]] = {}
            for i, c in enumerate(coding):
                groups.setdefault(c, []).append(i)
            for c, idxs in groups.items():
                sub = _decode_soft([problems[i] for i in idxs], [soft[i] for i in idxs], c)
                for i, r in zip(idxs, sub):
                    results_d[i] = r
            return results_d  # type: ignore[return-value]
        return _decode_soft(problems, soft, coding)
    equalized = out in ("equalized", "llrs")
    factored = out == "factored"
    if not equalized:
        bad_rx = [i for i, p in enumerate(problems) if p.n_rx != 1]
        if bad_rx:
            raise ValueError(
                f"multi-RX problems need out='equalized'; problems {bad_rx[:5]}"
            )
    if factored:
        if auto_time_interp_hz is not None:
            raise ValueError("out='factored' is incompatible with auto_time_interp_hz")
        bad = [i for i, p in enumerate(problems) if p.config.time_interp != "none"]
        if bad:
            raise ValueError(
                f"out='factored' requires time_interp='none'; problems {bad[:5]} differ"
            )

    if wiener_auto_delay is not None:
        problems = _snap_wiener_delay(problems, wiener_auto_delay)
    if auto_time_interp_hz is not None:
        thr = float(auto_time_interp_hz)
        problems = [
            _dc.replace(p, config=_dc.replace(p.config, time_interp="linear"))
            if (
                p.config.time_interp == "none"
                and p.config.smoothing != "learned2d"
                and estimate_doppler(p) > thr
            )
            else p
            for p in problems
        ]

    buckets: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(problems):
        buckets.setdefault(p.signature(), []).append(i)

    results: List[Optional[ServeResult]] = [None] * len(problems)
    pending: deque = deque()  # (scatter_fn, result_batch, chunk) not yet fetched
    for sig, idxs in buckets.items():
        hop1, hop2, config, n_layers, n_rx = sig
        if matmul_precision is not None:
            config = _dc.replace(config, matmul_precision=matmul_precision)
        learned = config.smoothing in ("learned", "learned2d")
        if learned:
            assert params is not None, f"smoothing={config.smoothing!r} needs params"
        if equalized:
            from .models import receiver as _receiver

            fn = _receiver.build_receiver_ri(
                hop1,
                hop2,
                config,
                n_layers,
                n_rx,
                batched=True,
                data_beta=data_beta,
                modulation=modulation if out == "llrs" else None,
                llr_scale=llr_scale,
            )
            # bind the bucket's signature NOW — scatters are deferred in `pending`
            # across bucket iterations (late-binding closures would mix buckets up)
            if out == "llrs":
                scatter = functools.partial(
                    _scatter_out_llrs,
                    sig=(hop1, hop2),
                    factored=config.time_interp == "none",
                    llr_scale=llr_scale,
                )
            else:
                scatter = functools.partial(
                    _scatter_out_equalized,
                    sig=(hop1, hop2),
                    factored=config.time_interp == "none",
                )
        else:
            fn = estimator.build_ri(
                hop1,
                hop2,
                config,
                n_layers,
                batched=True,
                out_layout="factored" if factored else "serve",
            )
            if factored:
                scatter = functools.partial(_scatter_out_factored, sig=(hop1, hop2))
            else:
                scatter = _scatter_out
        def _rg(p: Problem):
            # the receiver's contract is (n_rx, n_sc, n_sym) even for one port
            if equalized and p.received_rg.ndim == 2:
                return np.asarray(p.received_rg)[None]
            return p.received_rg

        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            pad = batch_size - len(chunk) if len(idxs) > batch_size else 0
            take = chunk + [chunk[-1]] * pad  # repeat-pad the tail chunk
            rg_b = _assemble([_rg(problems[i]) for i in take])
            pil_b = _assemble([problems[i].pilots for i in take])
            beta = np.asarray([problems[i].beta for i in take], np.float32)
            if learned:
                res_b = fn(rg_b, pil_b, jnp.asarray(beta), params)
            else:
                res_b = fn(rg_b, pil_b, jnp.asarray(beta))
            pending.append((scatter, res_b, chunk))
            if len(pending) >= max(1, inflight):
                sc, o, c = pending.popleft()
                sc(o, c, results=results)
    while pending:
        sc, o, c = pending.popleft()
        sc(o, c, results=results)
    return results  # type: ignore[return-value]


class TrackedServer:
    """Stateful serving: multi-slot tracking (models/tracking.py) per stream.

    A "stream" is a recurring sounding of the same physical link (same plan
    signature, same cell/UE/port) identified by a caller-chosen `stream_id`.
    The server buckets requests by plan signature like `process`, runs the
    batched tracked executable, and threads each stream's (h, w) state across
    calls — unseen streams start at zero state (first sounding passes through).

    Host-side orchestration only; each signature compiles one executable per
    batch size used.

    Submit at most ONE sounding per stream per `process` call: two requests for
    the same stream in one call both read the same prior state (the second is
    not chained onto the first — last write wins). Batch across streams, loop
    across soundings.

    Tracking state is keyed per (signature, out-mode) because the grid mode
    (out="grid") and the receiver modes (out="equalized"/"llrs") carry
    different state shapes (single-port vs per-RX-port). Switching a live
    stream between the two mode families therefore cannot carry its profile
    over: the server detects the switch and RESETS that stream's state (the
    next sounding passes through, as for a brand-new stream) instead of
    silently keeping two independent states per stream_id.
    """

    def __init__(self, batch_size: int = 128, matmul_precision: Optional[str] = "high"):
        self.batch_size = batch_size
        self.matmul_precision = matmul_precision
        self._state: Dict[Tuple, tuple] = {}  # (sig, stream_id) -> (h tuple, w)
        self._mode: Dict = {}  # stream_id -> last out-mode family (True = receiver)

    def reset(self, stream_id=None) -> None:
        """Drop tracking state — for one stream, or all when stream_id is None."""
        if stream_id is None:
            self._state.clear()
            self._mode.clear()
        else:
            self._state = {k: v for k, v in self._state.items() if k[1] != stream_id}
            self._mode.pop(stream_id, None)

    def process(
        self,
        problems: List[Problem],
        stream_ids: List,
        out: str = "grid",
        modulation: Optional[str] = None,
        data_beta: float = 1.0,
        llr_scale: float = 8.0,
    ) -> "List[ServeResult] | List[EqualizedServeResult] | List[LlrServeResult]":
        """out="grid" (default): tracked channel-estimate grids (single-port
        problems). out="equalized"/"llrs": the TRACKED multi-RX receiver
        (models/receiver.build_tracked_receiver_ri) — each stream's per-port
        tracking states thread across soundings and the per-subcarrier MMSE
        filter is rebuilt each slot from the tracked profiles (`modulation`
        required for "llrs", as in `process`)."""
        import dataclasses as _dc

        from .models import tracking

        assert out in ("grid", "equalized", "llrs"), out
        if out == "llrs" and modulation is None:
            raise ValueError("out='llrs' requires modulation=")
        assert len(problems) == len(stream_ids)
        # mode-switch detection: a stream that flips between the grid and
        # receiver mode families cannot carry its state over (different
        # shapes) — reset it explicitly instead of silently forking state
        mode = out != "grid"
        for sid in stream_ids:
            if self._mode.get(sid, mode) != mode:
                self.reset(sid)
            self._mode[sid] = mode
        buckets: Dict[Tuple, List[int]] = {}
        for i, p in enumerate(problems):
            buckets.setdefault(p.signature(), []).append(i)

        results: List[Optional[ServeResult]] = [None] * len(problems)
        for sig, idxs in buckets.items():
            hop1, hop2, config, n_layers, n_rx = sig
            if out == "grid":
                assert n_rx == 1, "out='grid' tracks one RX port per problem"
            if self.matmul_precision is not None:
                config = _dc.replace(config, matmul_precision=self.matmul_precision)
            eff_sig = (hop1, hop2, config, n_layers, n_rx, out != "grid")
            if out == "grid":
                fn = tracking.build_tracked_ri(
                    hop1, hop2, config, n_layers, batched=True, out_layout="serve"
                )
                zero_h, zero_w = tracking.init_state(hop1, hop2, config, n_layers)
            else:
                from .models import receiver as _receiver

                fn = _receiver.build_tracked_receiver_ri(
                    hop1, hop2, config, n_layers, n_rx,
                    data_beta=data_beta,
                    modulation=modulation if out == "llrs" else None,
                    llr_scale=llr_scale,
                    batched=True,
                )
                zero_h, zero_w = tracking.init_state(
                    hop1, hop2, config, n_layers, batch=n_rx
                )
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start : start + self.batch_size]
                pad = self.batch_size - len(chunk) if len(idxs) > self.batch_size else 0
                take = chunk + [chunk[-1]] * pad
                rgs = [
                    problems[i].received_rg
                    if problems[i].received_rg.ndim == 3 or out == "grid"
                    else problems[i].received_rg[None]
                    for i in take
                ]
                rg_b = _assemble(rgs)
                pil_b = _assemble([problems[i].pilots for i in take])
                beta = np.asarray([problems[i].beta for i in take], np.float32)
                # gather per-stream states (zero for unseen streams)
                states = [
                    self._state.get((eff_sig, stream_ids[i]), (zero_h, zero_w))
                    for i in take
                ]
                h_b = tuple(
                    np.stack([np.asarray(s[0][j]) for s in states])
                    for j in range(len(zero_h))
                )
                w_b = np.asarray([s[1] for s in states], np.float32)
                out_b, h_new, w_new = fn(rg_b, pil_b, jnp.asarray(beta), h_b, w_b)
                if out == "llrs":
                    _scatter_out_llrs(
                        out_b, chunk, results, sig=(hop1, hop2), factored=True,
                        llr_scale=llr_scale,
                    )
                elif out == "equalized":
                    _scatter_out_equalized(
                        out_b, chunk, results, sig=(hop1, hop2), factored=True
                    )
                else:
                    ch = _merge_batch(np.asarray(out_b.channel_est_rg))
                    noise = np.asarray(out_b.noise_est)
                    rsrp = np.asarray(out_b.rsrp)
                    epre = np.asarray(out_b.epre)
                    ta = np.asarray(out_b.time_alignment)
                    cfo = np.asarray(out_b.cfo_hz)
                    for k, i in enumerate(chunk):
                        grid = ch[k]
                        results[i] = ServeResult(
                            channel_est_rg=np.moveaxis(grid, (0, 1, 2), (2, 1, 0)),
                            noise_est=float(noise[k]),
                            rsrp=float(rsrp[k]),
                            epre=float(epre[k]),
                            time_alignment=float(ta[k]),
                            cfo_hz=float(cfo[k]),
                        )
                h_new = tuple(np.asarray(h) for h in h_new)
                w_new = np.asarray(w_new)
                for k, i in enumerate(chunk):
                    self._state[(eff_sig, stream_ids[i])] = (
                        tuple(h[k] for h in h_new),
                        np.asarray(w_new[k]) if out != "grid" else float(w_new[k]),
                    )
        return results  # type: ignore[return-value]
