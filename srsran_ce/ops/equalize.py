"""MMSE equalization — the downstream consumer of the channel estimates.

The reference stops at the channel estimate (srs_channel_estimator returns the
grid + measurements, ce_rule_baseline.py:761-768); an actual receiver then
equalizes the data REs with it. This module closes that loop, and is the
showcase for the factored (rank-1) output layout:

  * `mmse_equalize` — dense-grid path: per-RE MMSE filter
      x̂ = (H^H H + σ²/β² I)^(-1) H^H y / β
    over (n_rx, n_layers) with batched small solves, vectorized over (sc, sym).
  * `mmse_equalize_factored` — factored path: when the channel is
    H[sc, sym] = P[sc] · r[sym] with |r| = 1 (exactly what
    `estimator.FactoredResult` returns for time_interp="none"), the Gram matrix
    P^H P is TIME-INVARIANT, so the MMSE filter is computed once per subcarrier
    instead of once per RE — an n_sym-fold (14x) cheaper filter construction —
    and the rotation is undone as a per-symbol scalar:
      x̂[sc, sym] = conj(r[sym]) · W[sc] y[sc, sym].

Both return the post-equalization noise-normalized symbol estimates and the
per-(sc[, sym], layer) post-equalization SINR (the standard MMSE
1/diag((G+σ̃²I)^(-1)σ̃²) - 1 form), jittable and batchable with vmap.

Shapes (single problem): y (n_rx, n_sc, n_sym); H (n_rx, n_sc, n_sym, nL) dense
or P (n_rx, nL, n_sc) factored + r (n_sym,). n_rx == 1 recovers the
single-port case the estimator serves per antenna port.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def mmse_equalize(
    received: jnp.ndarray,
    channel: jnp.ndarray,
    noise_var: jnp.ndarray,
    beta: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense-grid MMSE equalization, reference (sc, sym, layer) layout.

    received: (n_rx, n_sc, n_sym) complex; channel: (n_rx, n_sc, n_sym, nL)
    complex (e.g. per-port estimator outputs stacked on a leading rx axis);
    noise_var: scalar noise variance (estimator noise_est); beta: data-RE
    amplitude scale. Returns (x_hat (n_sc, n_sym, nL), sinr (n_sc, n_sym, nL)).

    Thin relayout wrapper over `mmse_equalize_serve` — ONE compute path, and
    that path uses no matmul (see `_gram_lead`). Prefer the serve-layout entry
    point on device; this layout exists for
    host-side/oracle use against reference-layout grids.
    """
    x, sinr = mmse_equalize_serve(
        jnp.moveaxis(received, -2, -1),  # (n_rx, n_sym, n_sc)
        jnp.transpose(channel, (0, 3, 2, 1)),  # (n_rx, nL, n_sym, n_sc)
        noise_var,
        beta=beta,
    )
    return jnp.transpose(x, (2, 1, 0)), jnp.transpose(sinr, (2, 1, 0))


def _inv2_blk(m):
    """Inverse of a 2x2 'matrix of arrays' [[a,b],[c,d]] (elementwise batched)."""
    (a, b), (c, d) = m
    det = a * d - b * c
    return [[d / det, -b / det], [-c / det, a / det]]


def _mul2_blk(x, y):
    """2x2 block/matrix product of 'matrices of arrays' (elementwise batched)."""
    return [
        [
            x[0][0] * y[0][0] + x[0][1] * y[1][0],
            x[0][0] * y[0][1] + x[0][1] * y[1][1],
        ],
        [
            x[1][0] * y[0][0] + x[1][1] * y[1][0],
            x[1][0] * y[0][1] + x[1][1] * y[1][1],
        ],
    ]


def _hermitian_inverse_lead(a: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a regularized Hermitian PD matrix with LEADING matrix axes:
    a (nL, nL, ...) -> inverse (nL, nL, ...).

    The serve-layout cores keep the long subcarrier axis minor (contiguous)
    and the tiny nL x nL system in leading axes, so everything here is
    elementwise work over long rows. Closed forms for every
    supported layer count: adjugate for nL in {2, 3}, a Schur complement on
    2x2 blocks for nL=4 (the Gram + sigma^2 I is PD, so the pivots never
    vanish). Not `jnp.linalg.inv` for these sizes: XLA has lowered batched LU
    to a per-matrix serialized loop (~1000x the whole estimator in an earlier
    measurement; not re-measured on the GPU)."""
    nL = a.shape[0]
    if nL == 1:
        return 1.0 / a
    if nL == 2:
        a00, a01, a11 = a[0, 0], a[0, 1], a[1, 1]
        det = a00 * a11 - a01 * jnp.conj(a01)
        row0 = jnp.stack([a11, -a01])
        row1 = jnp.stack([-jnp.conj(a01), a00])
        return jnp.stack([row0, row1]) / det
    if nL == 3:
        # generic 3x3 adjugate (a is Hermitian but the formula need not care)
        m = [[a[i, j] for j in range(3)] for i in range(3)]
        c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
        c01 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
        c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
        c10 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
        c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
        c12 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
        c20 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
        c21 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
        c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
        det = m[0][0] * c00 + m[0][1] * c10 + m[0][2] * c20
        rows = [
            jnp.stack([c00, c01, c02]),
            jnp.stack([c10, c11, c12]),
            jnp.stack([c20, c21, c22]),
        ]
        return jnp.stack(rows) / det
    if nL == 4:
        # Schur complement on 2x2 blocks: A = [[P, Q], [Q^H, S]] with P, S
        # Hermitian PD (regularized Gram) => P and T = S - Q^H P^-1 Q invertible.
        blk = lambda i, j: [[a[2 * i + r, 2 * j + c] for c in (0, 1)] for r in (0, 1)]
        P, Q, S = blk(0, 0), blk(0, 1), blk(1, 1)
        Qh = [[jnp.conj(Q[c][r]) for c in (0, 1)] for r in (0, 1)]
        Pi = _inv2_blk(P)
        PiQ = _mul2_blk(Pi, Q)
        QhPi = _mul2_blk(Qh, Pi)
        QhPiQ = _mul2_blk(Qh, PiQ)
        T = [[S[r][c] - QhPiQ[r][c] for c in (0, 1)] for r in (0, 1)]
        Ti = _inv2_blk(T)
        B01 = _mul2_blk(PiQ, Ti)  # P^-1 Q T^-1
        B10 = _mul2_blk(Ti, QhPi)  # T^-1 Q^H P^-1
        A00c = _mul2_blk(B01, QhPi)  # P^-1 Q T^-1 Q^H P^-1
        A00 = [[Pi[r][c] + A00c[r][c] for c in (0, 1)] for r in (0, 1)]
        rows = []
        for r in (0, 1):
            rows.append(jnp.stack([A00[r][0], A00[r][1], -B01[r][0], -B01[r][1]]))
        for r in (0, 1):
            rows.append(jnp.stack([-B10[r][0], -B10[r][1], Ti[r][0], Ti[r][1]]))
        return jnp.stack(rows)
    moved = jnp.moveaxis(a, (0, 1), (-2, -1))
    return jnp.moveaxis(jnp.linalg.inv(moved), (-2, -1), (0, 1))


def _sinr_from_inv_lead(inv: jnp.ndarray, noise_over_beta2: jnp.ndarray) -> jnp.ndarray:
    """`_sinr_from_inv` for leading matrix axes: inv (nL, nL, ...) -> (nL, ...).

    The optimization_barrier below guards against a duplicated-fusion
    miscompile seen on an earlier accelerator backend: when this chain fused
    into the full receiver program, XLA duplicated the d*s computation into
    the reciprocal's fusion and the duplicate evaluated max(d*s, 1e-30) to 0
    wherever d < ~1, turning finite SINRs into 1e30. The barrier forces one
    materialized (nL, ...) real array — negligible. Whether the GPU backend
    needs it is not established (ROADMAP C7); do not remove it without
    running quality.coded_ber_sweep on the card (poisoned SINRs produce
    max-confidence int8 LLRs on garbage bits)."""
    nL = inv.shape[0]
    d = jnp.real(jnp.stack([inv[i, i] for i in range(nL)]))
    s = noise_over_beta2.real
    ds = jax.lax.optimization_barrier(d * s)
    return jnp.maximum(1.0 / jnp.maximum(ds, 1e-30) - 1.0, 0.0)


def _gram_lead(h: jnp.ndarray, s) -> jnp.ndarray:
    """Regularized Gram H^H H + sI for leading tiny axes: h (n_rx, nL, ...) ->
    (nL, nL, ...). Unrolled over the nL x nL x n_rx (each <= 4) terms as
    elementwise multiply-adds in full f32 over the big trailing (sym, sc)
    dims. A dot_general over a size-<=4 contraction would run at the
    backend's default matmul precision (bf16 or TF32 on accelerators), which
    turns the near-singular determinant cancellation in
    `_hermitian_inverse_lead` into garbage (|x| 1e4 x too large in an
    earlier measurement), and wastes a matrix unit on 2-4 terms."""
    nL = h.shape[1]
    hc = jnp.conj(h)
    rows = []
    for i in range(nL):
        row = []
        for j in range(nL):
            g = jnp.sum(hc[:, i] * h[:, j], axis=0)
            row.append(g + s if i == j else g)
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def _matched_filter_lead(h: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """H^H y for leading tiny axes: h (n_rx, nL, ...), y (n_rx, ...) -> (nL, ...)."""
    hc = jnp.conj(h)
    return jnp.stack([jnp.sum(hc[:, i] * y, axis=0) for i in range(h.shape[1])])


def _apply_inv_lead(inv: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """inv (nL, nL, ...) @ v (nL, ...) -> (nL, ...), unrolled elementwise."""
    nL = inv.shape[0]
    return jnp.stack(
        [sum(inv[i, j] * v[j] for j in range(nL)) for i in range(nL)]
    )


def mmse_equalize_serve(
    received: jnp.ndarray,
    channel: jnp.ndarray,
    noise_var: jnp.ndarray,
    beta: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense MMSE equalization in the serve layout (subcarrier-last).

    received: (n_rx, n_sym, n_sc); channel: (n_rx, nL, n_sym, n_sc) — i.e. the
    estimator's out_layout="serve" grid stacked over RX ports, consumed with NO
    relayout: every contraction is over the tiny n_rx/nL leading axes while
    (n_sym, n_sc) stay trailing, as pure elementwise work (see `_gram_lead`
    for why NOT einsum). Same math as `mmse_equalize`
    (oracle-tested equal); returns x (nL, n_sym, n_sc), sinr (nL, n_sym, n_sc).
    """
    s = jnp.asarray(noise_var) / (beta * beta)
    inv = _hermitian_inverse_lead(_gram_lead(channel, s.astype(channel.dtype)))
    mf = _matched_filter_lead(channel, received)  # H^H y, (nL, n_sym, n_sc)
    x = _apply_inv_lead(inv, mf) / beta
    return x, _sinr_from_inv_lead(inv, s)


def mmse_equalize_factored_serve(
    received: jnp.ndarray,
    profiles: jnp.ndarray,
    sym_rot: jnp.ndarray,
    noise_var: jnp.ndarray,
    sym_start: int,
    n_alloc_syms: int,
    beta: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Factored MMSE equalization, serve layout, multi-RX, per-RX CFO rotations.

    received: (n_rx, n_sym, n_sc); profiles: (n_rx, nL, n_sc) — one hop row of
    each RX port's FactoredResult; sym_rot: (n_rx, n_sym) per-port rotations
    (each port's estimator measures its own CFO; they differ only by noise).

    The joint channel is H[r, sc, sym] = profiles[r, :, sc] * sym_rot[r, sym]
    with |sym_rot| = 1, so the per-port rotations CANCEL in the Gram matrix
    G = Σ_r P_r^H P_r — the regularized inverse is built once per subcarrier
    (exactly, not approximately) even though the ports carry different CFO
    phases. The rotations survive only in the matched filter, where they fold
    into the received symbols elementwise:  H^H y [sym] = Σ_r conj(rot_r[sym])
    P_r^H y_r[sym]. Returns x (nL, n_alloc, n_sc), sinr (nL, n_sc).
    """
    s = jnp.asarray(noise_var) / (beta * beta)
    inv = _hermitian_inverse_lead(_gram_lead(profiles, s.astype(profiles.dtype)))
    rot = jax.lax.slice_in_dim(sym_rot, sym_start, sym_start + n_alloc_syms, axis=1)
    y = jax.lax.slice_in_dim(received, sym_start, sym_start + n_alloc_syms, axis=1)
    y = y * jnp.conj(rot)[:, :, None]  # (n_rx, n_alloc, n_sc)
    nL, n_rx = profiles.shape[1], profiles.shape[0]
    pc = jnp.conj(profiles)
    # Fold the filter W = (G + sI)^-1 P^H down to per-subcarrier weights
    # w[i, r, c] (tiny: nL x n_rx x n_sc), then apply in ONE pass over the
    # symbol grid — the (nL, n_alloc, n_sc) matched-filter intermediate never
    # materializes (one x-grid-sized HBM round trip saved).
    x = jnp.stack(
        [
            sum(
                sum(inv[i, j] * pc[r, j] for j in range(nL))[None, :] * y[r]
                for r in range(n_rx)
            )
            for i in range(nL)
        ]
    ) / beta
    return x, _sinr_from_inv_lead(inv, s)


def mmse_equalize_factored(
    received: jnp.ndarray,
    profiles: jnp.ndarray,
    sym_rot: jnp.ndarray,
    noise_var: jnp.ndarray,
    sym_start: int,
    n_alloc_syms: int,
    beta: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Factored-channel MMSE equalization for ONE hop's symbol range.

    received: (n_rx, n_sc, n_sym) complex (full grid; only the hop's symbols
    [sym_start, sym_start + n_alloc_syms) are equalized);
    profiles: (n_rx, nL, n_sc) — one hop row of FactoredResult.profiles per RX
    port; sym_rot: (n_sym,) unit-modulus rotation (shared by all ports: the CFO
    is a property of the UE's transmission).

    The filter is built ONCE per subcarrier (the unit-modulus rotation cancels
    in H^H H), then applied to every symbol with the rotation undone as a
    scalar — the n_sym x cheaper construction the factored layout exists for.
    Returns (x_hat (n_sc, n_alloc, nL), sinr (n_sc, nL)) for the hop's symbols.

    Thin relayout wrapper over `mmse_equalize_factored_serve` (one compute
    path, matmul-free — see `_gram_lead`), which also takes per-port rotations.
    """
    x, sinr = mmse_equalize_factored_serve(
        jnp.moveaxis(received, -2, -1),  # (n_rx, n_sym, n_sc)
        profiles,
        sym_rot[None, :],  # shared rotation -> one broadcast port row
        noise_var,
        sym_start,
        n_alloc_syms,
        beta=beta,
    )
    return jnp.transpose(x, (2, 1, 0)), sinr.T
