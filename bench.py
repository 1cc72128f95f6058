"""Benchmark harness: channel-estimation throughput on one GPU.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric: channel-estimate grid REs/s on the BASELINE.json config[2]
geometry (MMSE smoothing + noise-variance, 4 antenna ports, 106 PRB), batched.
vs_baseline compares against the reference implementation (ce_rule_tensorized /
ce_dl_cnn, torch CPU eager) — see BASELINE_MEASURED.json.

Methodology (to be replaced by host-clock timing with a profiler-trace
reduction, ROADMAP A1): a strictly serial chain — a lax.scan whose next input
depends on the previous iteration's output — timed at several repetition
counts; the slope is the time per batch.
  * `lax.optimization_barrier` on each iteration's channel grid. Without it XLA
    fuses the chain's feedback reduction into the producer and never
    materializes the output, so the grid write would go unmeasured.
  * The serving path is benchmarked as served: out_layout="serve" (subcarrier-last
    (layer, sym, sc) grid) and matmul_precision="high" (three bf16 passes); the
    f32-exact conformance path is gated separately by the NMSE check below,
    which must pass for the numbers to be reported at all.
  * Min-of-K slopes, rows interleaved, with the spread reported beside each.

Per-config details (all five BASELINE.json configs) go to stderr and
BENCH_DETAILS.json.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from srsran_ce.models import estimator as _est  # noqa: E402
from srsran_ce.models.plan import make_plan  # noqa: E402
from srsran_ce.utils import profiling, synthetic  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


BENCH_CONFIGS = {
    # name -> (case kwargs, batch sizes to sweep)
    "c0_baseline_52prb": (dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3), (128, 256)),
    "c1_tensorized_52prb": (dict(n_prbs=52, n_layers=1, comb=2, scs_hz=30e3), (64, 256)),
    "c2_mmse_4port_106prb": (dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3), (128, 256)),
    "c3_cnn_273prb": (dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, interp="cnn"), (64, 128)),
    # BASELINE configs[4] says "4096 concurrent (cell, UE, port) estimations" — run
    # the hopped-SRS geometry at literally 4096 resident problems per dispatch.
    "c4_hopped_24prb": (dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, two_hops=True), (256, 4096)),
}

HEADLINE = "c2_mmse_4port_106prb"
REPS = (8, 40, 72)
REPS_LONGER = ((8, 144, 288), (8, 576, 1152), (8, 2304, 4608))  # fast-row escalation tiers
TRIALS = 3
K_SLOPES = 3
SPREAD_WARN = 0.10

# THE min-of-K aggregation policy — one implementation, shared with
# profiling.chained_slope_stats (see its docstring for the c0 episode that
# shaped the corroborated-min discard)
robust_slope_stats = profiling.robust_slope_stats


class SlopeRow:
    """One bench row: pre-compiled chained-scan executables at several rep
    counts, measured as one slope per pass. See the module docstring's
    min-of-K rule; `measure_once()` is called once per interleaved pass."""

    def __init__(self, name, make_fn, args):
        self.name = name
        self.make_fn = make_fn  # reps -> jitted fn(*args) -> scalar
        self.args = args
        self.fns = {}
        self.rep_points = REPS
        self.slopes = []
        self.archived_slopes = []  # pre-escalation estimates (audit trail)
        self.escalations = 0
        self.setup_s = 0.0
        self.last_times = {}

    def _fn(self, reps):
        if reps not in self.fns:
            fn = self.make_fn(reps)
            float(fn(*self.args))  # compile + warmup fetch (forces materialization)
            self.fns[reps] = fn
        return self.fns[reps]

    def measure_once(self) -> float:
        times = {}
        for reps in self.rep_points:
            fn = self._fn(reps)
            best = float("inf")
            for _ in range(TRIALS):
                t0 = time.time()
                r = fn(*self.args)
                jax.block_until_ready(r)
                best = min(best, time.time() - t0)
            times[reps] = best
        self.last_times = times
        xs = np.array(self.rep_points, float)
        ys = np.array([times[r] for r in self.rep_points])
        return max(float(np.polyfit(xs, ys, 1)[0]), 1e-9)

    def prepare(self) -> float:
        """Compile all rep points and take a pilot estimate (used for batch
        selection and the long-chain fallback; NOT counted toward the K
        interleaved estimates)."""
        t0 = time.time()
        s = self.measure_once()
        # Fast rows bury the slope in per-call latency noise (slope contributes
        # too little of the longest chain's wall time -> the fit is mostly
        # intercept jitter, occasionally NEGATIVE — r4 first run: a 0.09 ms
        # factored row "measured" 0.000 ms; threshold raised 0.15 -> 0.3 after
        # borderline rows like c4 still swung 60% run to run). Escalate the
        # chain length until the slope dominates, up to 16x.
        for longer in REPS_LONGER:
            hi = self.rep_points[-1]
            if s > 0.3 * self.last_times[hi] / hi:
                break
            self.rep_points = longer
            s = self.measure_once()
        self.setup_s = time.time() - t0
        return s

    def escalate(self) -> bool:
        """Post-hoc chain-length escalation: move to the
        next longer REPS tier so the slope dominates the fit; the caller takes
        K fresh estimates after. The noisy short-chain pool is archived (kept
        in BENCH_DETAILS for audit) and no longer votes. False = exhausted."""
        for tier in REPS_LONGER:
            if tier[-1] > self.rep_points[-1]:
                self.rep_points = tier
                self.archived_slopes += self.slopes
                self.slopes = []
                self.escalations += 1
                return True
        return False

    def stats(self) -> dict:
        # shared policy: see robust_slope_stats (corroborated-min discard)
        s_min, spread, n_disc, _ = robust_slope_stats(self.slopes)
        return {
            "s_per_batch": s_min,
            "slope_estimates_ms": [s * 1e3 for s in self.slopes],
            "archived_slope_estimates_ms": [s * 1e3 for s in self.archived_slopes],
            "escalations": self.escalations,
            "rep_points": list(self.rep_points),
            "n_slopes_discarded": n_disc,
            "slope_spread": spread,
            "spread_warn": spread > SPREAD_WARN,
        }


def _chained_runner(case, config, n_layers, reps, out_layout="serve"):
    """jitted fn running `reps` strictly-serial estimator batches through the
    PUBLIC batched builder (the exact serving executable); returns a scalar. A
    learned-smoothing config's denoiser pytree rides as a trailing *params
    argument."""
    fn = _est.build_ri(
        case.hop1, case.hop2, config, n_layers,
        batched=True, out_layout=out_layout,
    )

    @jax.jit
    def many(rg_ri, pil_ri, beta, *params):
        def body(rg_c, _):
            res = fn(rg_c, pil_ri, beta, *params)
            if out_layout == "factored":
                outs = (res.profiles, res.sym_rot)
            else:
                outs = (res.channel_est_rg,)
            # Force the outputs to actually materialize in HBM (see module
            # docstring), then chain the next iteration on a cheap strided sample:
            # strict serialization without an extra full read pass.
            outs = jax.lax.optimization_barrier(outs)
            s = outs[0][:, :, 0, 0, ::127].sum()
            if out_layout == "factored":
                s = s + outs[1].sum()
            return rg_c + 1e-12 * s, res.noise_est.sum()

        rg_f, nzs = jax.lax.scan(body, rg_ri, None, length=reps)
        return rg_f.sum() + nzs.sum()

    return many


def _chained_tracked_runner(case, config, n_layers, reps):
    """Chained runner for the TRACKED serving estimator (models/tracking): the
    per-slot state (pilot-lattice profile + gain weight) threads through the
    scan carry — successive iterations ARE successive soundings, so the
    measured slope is the real steady-state tracked-serving cost."""
    from srsran_ce.models import tracking

    fn = tracking.build_tracked_ri(
        case.hop1, case.hop2, config, n_layers, batched=True, out_layout="serve"
    )

    @jax.jit
    def many(rg_ri, pil_ri, beta, h0, w0):
        def body(carry, _):
            rg_c, h, w = carry
            res, h_new, w_new = fn(rg_c, pil_ri, beta, h, w)
            outs = jax.lax.optimization_barrier((res.channel_est_rg,) + tuple(h_new))
            s = outs[0][:, :, 0, 0, ::127].sum()
            return (rg_c + 1e-12 * s, outs[1:], w_new), res.noise_est.sum()

        (rg_f, _, _), nzs = jax.lax.scan(body, (rg_ri, tuple(h0), w0), None, length=reps)
        return rg_f.sum() + nzs.sum()

    return many


def _chained_receiver_runner(plan, reps, modulation=None):
    """Like `_chained_runner` but for the joint multi-RX receiver (factored
    estimate + cross-port MMSE equalization fused in one program): the barrier
    forces the equalized-symbol grid (2, nL, n_sym, n_sc) — or, with
    `modulation`, the fused demapper's int8 LLR grid — to materialize."""
    from srsran_ce.models import receiver as _rcv

    def single(r, p, b):
        res = _rcv.receiver_impl(plan, r, p, b, factored=True, modulation=modulation)
        outs = res.llr if modulation else (res.x,)  # llr = per-bit plane tuple
        return outs, res.noise_est

    @jax.jit
    def many(rg_ri, pil_ri, beta):
        def body(rg_c, _):
            outs, nz = jax.vmap(single)(rg_c, pil_ri, beta)
            outs = jax.lax.optimization_barrier(outs)
            s = sum(o[..., 0, 0, ::127].astype(jnp.float32).sum() for o in outs)
            return rg_c + 1e-12 * s, jnp.sum(nz)

        rg_f, nzs = jax.lax.scan(body, rg_ri, None, length=reps)
        return rg_f.sum() + nzs.sum()

    return many


def _nmse_vs_oracle(case, nL) -> float:
    """Correctness self-check: one f32 evaluation of the EXACT configuration being
    benchmarked (matmul_precision="high") against the float64 oracle — through the
    reference-layout CONFORMANCE path (exact fill; ~5e-15)."""
    from srsran_ce.models import estimator
    from srsran_ce.utils import oracle

    res = estimator.estimate(
        case.received_rg.astype(np.complex64),
        case.pilots.astype(np.complex64),
        np.float32(case.beta),
        case.hop1,
        case.hop2,
        _serving_config(case.config),
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch = np.asarray(res.channel_est_rg).astype(np.complex128)
    return float(
        np.sum(np.abs(ch - res_o.channel_est_rg) ** 2)
        / (np.sum(np.abs(res_o.channel_est_rg) ** 2) + 1e-30)
    )


def _nmse_vs_oracle_serve(case, nL) -> float:
    """Same check through the SERVE-layout executable actually being timed.
    Serving keeps the fill matmul at "high" (three bf16 passes on multi-layer
    geometries), a trade the conformance path does not make — see
    ARCHITECTURE.md."""
    import jax.numpy as jnp

    from srsran_ce.models import estimator
    from srsran_ce.utils import oracle

    fn = estimator.build_ri(
        case.hop1, case.hop2, _serving_config(case.config), nL, out_layout="serve",
    )
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    res = fn(rg, pil, jnp.asarray(np.float32(case.beta)))
    ch_ri = np.asarray(res.channel_est_rg, np.float64)  # (2, nL, n_sym, n_sc)
    ch = np.transpose(ch_ri[0] + 1j * ch_ri[1], (2, 1, 0))  # (n_sc, n_sym, nL)
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    return float(
        np.sum(np.abs(ch - res_o.channel_est_rg) ** 2)
        / (np.sum(np.abs(res_o.channel_est_rg) ** 2) + 1e-30)
    )


def _serving_config(config):
    return dataclasses.replace(config, matmul_precision="high")


def _load_params2d():
    """Shipped 2-D denoiser checkpoint (artifacts/denoiser2d_ckpt.npz) for the
    learned2d cost row; None (row skipped) if absent/unloadable."""
    try:
        from srsran_ce.models import training

        path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "srsran_ce", "artifacts", "denoiser2d_ckpt.npz",
        )
        if not os.path.isfile(path):
            return None
        return training.load_checkpoint_2d(path).params
    except Exception as e:
        log(f"learned2d checkpoint unavailable ({type(e).__name__}: {e}); row skipped")
        return None


def _gate_oracle_both(case, nL, params=None):
    """NMSE gates for modes the float64 oracle covers (wiener, time_interp):
    both the conformance layout and the serve executable being timed."""
    r = {"nmse_vs_oracle": _nmse_vs_oracle(case, nL)}
    assert r["nmse_vs_oracle"] < 1e-6, f"quality-row conformance gate: {r}"
    r["nmse_vs_oracle_serve"] = _nmse_vs_oracle_serve(case, nL)
    assert r["nmse_vs_oracle_serve"] < 1e-6, f"quality-row serve gate: {r}"
    return r


def _gate_learned2d(case, nL, params):
    """learned2d has no oracle mirror (trainable weights): gate the timed
    "high"-precision batched executable against the HIGHEST-precision
    unbatched serve executable with the same params (catches precision/layout
    regressions in the quality path); quality-vs-truth lives in
    QUALITY_REPORT."""
    from srsran_ce.models import estimator

    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    beta = jnp.asarray(np.float32(case.beta))
    a = np.asarray(
        estimator.build_ri(
            case.hop1, case.hop2, case.config, nL, out_layout="serve"
        )(rg, pil, beta, params).channel_est_rg,
        np.float64,
    )
    b = np.asarray(
        estimator.build_ri(
            case.hop1, case.hop2, _serving_config(case.config), nL, out_layout="serve"
        )(rg, pil, beta, params).channel_est_rg,
        np.float64,
    )
    nmse = float(np.sum((a - b) ** 2) / (np.sum(a**2) + 1e-30))
    assert np.isfinite(b).all() and nmse < 1e-6, f"learned2d precision gate: {nmse}"
    return {"nmse_high_vs_highest": nmse}


def _gate_tracked(case, nL, params=None):
    """Slot-0 tracked output must equal the plain serve estimate exactly in
    principle (w=0 -> gain 1; the tracker passes the first observation
    through) — gate at a tight float tolerance."""
    from srsran_ce.models import estimator, tracking

    cfg = _serving_config(case.config)
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    beta = jnp.asarray(np.float32(case.beta))
    fn_t = tracking.build_tracked_ri(
        case.hop1, case.hop2, cfg, nL, batched=False, out_layout="serve"
    )
    h0, w0 = tracking.init_state(case.hop1, case.hop2, cfg, nL)
    res_t, _, _ = fn_t(rg, pil, beta, jax.device_put(h0), jax.device_put(w0))
    res_p = estimator.build_ri(
        case.hop1, case.hop2, cfg, nL, out_layout="serve"
    )(rg, pil, beta)
    a = np.asarray(res_p.channel_est_rg, np.float64)
    b = np.asarray(res_t.channel_est_rg, np.float64)
    nmse = float(np.sum((a - b) ** 2) / (np.sum(a**2) + 1e-30))
    assert nmse < 1e-9, f"tracked slot-0 gate (gain-1 passthrough): {nmse}"
    return {"nmse_slot0_vs_plain": nmse}


QUALITY_GATES = {
    "q_base_52prb_2l": _gate_oracle_both,
    "q_wiener_52prb_2l": _gate_oracle_both,
    "q_time_interp_52prb_2l": _gate_oracle_both,
    "q_tracked_52prb_2l": _gate_tracked,
    "q_learned2d_52prb": _gate_learned2d,
}


def _row_inputs(case, batch, n_rx=None):
    rg = _est.split_ri(case.received_rg.astype(np.complex64))
    if n_rx is not None:
        # joint receiver: n_rx port grids per problem (2, n_rx, n_sc, n_sym)
        rg = np.broadcast_to(rg[:, None], (2, n_rx) + rg.shape[1:]).copy()
    pil = _est.split_ri(case.pilots.astype(np.complex64))
    rg_b = jax.device_put(np.broadcast_to(rg, (batch,) + rg.shape).copy())
    pil_b = jax.device_put(np.broadcast_to(pil, (batch,) + pil.shape).copy())
    beta = jax.device_put(np.ones(batch, np.float32))
    return (rg_b, pil_b, beta), rg, pil


def make_row(name, kwargs, batch, out_layout="serve", n_rx=None, modulation=None,
             params=None, tracked=False):
    """Build one SlopeRow plus its static metadata (grid REs, HBM floor)."""
    case = synthetic.make_case(seed=1234, snr_db=30.0, **kwargs)
    nL = case.pilots.shape[2]
    plan = make_plan(case.hop1, case.hop2, _serving_config(case.config), nL)
    _est.prefetch_plan_constants(plan)
    args, rg, pil = _row_inputs(case, batch, n_rx)
    if params is not None:
        args = args + (jax.device_put(params),)
    if tracked:
        from srsran_ce.models import tracking

        h0, w0 = tracking.init_state(
            case.hop1, case.hop2, _serving_config(case.config), nL, batch=batch
        )
        args = args + (jax.device_put(h0), jax.device_put(w0))

    if tracked:
        make_fn = lambda reps: _chained_tracked_runner(
            case, _serving_config(case.config), nL, reps
        )
    elif n_rx is not None:
        make_fn = lambda reps: _chained_receiver_runner(plan, reps, modulation)
    else:
        make_fn = lambda reps: _chained_runner(
            case, _serving_config(case.config), nL, reps, out_layout
        )
    row = SlopeRow(name, make_fn, args)

    # channel REs produced per problem; the receiver performs n_rx estimations
    grid_res = case.received_rg.size * nL * (n_rx or 1)
    meta = {
        "batch": batch, "grid_res": grid_res, "case": case,
        "nL": nL, "params": params,
    }
    return row, meta


def row_details(row: SlopeRow, meta) -> dict:
    st = row.stats()
    per_batch = st["s_per_batch"]
    batch, grid_res = meta["batch"], meta["grid_res"]
    return {
        "latency_ms_per_batch": per_batch * 1e3,
        "batch": batch,
        "problems_per_s": batch / per_batch,
        "res_per_s": batch * grid_res / per_batch,
        "grid_res_per_problem": grid_res,
        "slope_estimates_ms": st["slope_estimates_ms"],
        "archived_slope_estimates_ms": st["archived_slope_estimates_ms"],
        "escalations": st["escalations"],
        "rep_points": st["rep_points"],
        "n_slopes_discarded": st["n_slopes_discarded"],
        "slope_spread": st["slope_spread"],
        "spread_warn": st["spread_warn"],
        "times_s": {str(k): v for k, v in row.last_times.items()},
        "setup_s": row.setup_s,
    }


def select_batch_rows(specs):
    """specs: list of (name, row_kwargs_per_batch). For each spec, prepare a row
    per candidate batch, keep the best pilot-estimate res_per_s. Returns
    {name: (row, meta)} of winners, all prepared (compiled)."""
    winners = {}
    for name, candidates in specs:
        best = None
        for make_kwargs in candidates:
            try:
                row, meta = make_row(name, **make_kwargs)
                s = row.prepare()
                r = meta["batch"] * meta["grid_res"] / s
                if best is None or r > best[2]:
                    best = (row, meta, r, s)
                else:
                    row.fns.clear()  # drop loser executables
            except Exception as e:
                log(f"{name} (batch candidate) FAILED: {type(e).__name__}: {e}")
        if best is not None:
            # the winner's pilot estimate is itself an independent slope sample
            # from a separate wall-clock period — keep it in the K pool
            best[0].slopes.append(best[3])
            winners[name] = (best[0], best[1])
    return winners


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX platform is {dev.platform!r}")
    log(f"bench device: {dev} ({dev.device_kind})")

    baseline = {}
    bl_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")
    if os.path.exists(bl_path):
        with open(bl_path) as f:
            baseline = json.load(f).get("results", {})

    details = {}

    # ---- Phase 1: build + compile every slope row (batch selection included) ----
    specs = []
    for name, (kwargs, batches) in BENCH_CONFIGS.items():
        specs.append((name, [dict(kwargs=kwargs, batch=b) for b in batches]))
    # Factored serving output (out_layout="factored": profile + per-symbol
    # rotation instead of the dense grid — lossless rank-1 factorization,
    # ~n_sym x less output; see FactoredResult). Same batch sweep as the dense
    # rows so the ratios are like-for-like; detail rows, not the headline.
    for fname in (HEADLINE, "c3_cnn_273prb"):
        kwargs, batches = BENCH_CONFIGS[fname]
        specs.append((
            fname + "_factored",
            [dict(kwargs=kwargs, batch=b, out_layout="factored") for b in batches],
        ))
    # Joint multi-RX receiver (models/receiver): 4 RX ports x 4 layers at the
    # headline geometry — 4 estimations + cross-port MMSE equalization fused in
    # one program; output = equalized-symbol grid (nL, n_sym, n_sc). And the
    # same receiver with the exact max-log 256QAM demap fused in (int8 LLR
    # grid: the complete PHY front-end in ONE program).
    kwargs, _ = BENCH_CONFIGS[HEADLINE]
    specs.append((
        "c2_receiver_4rx4l", [dict(kwargs=kwargs, batch=b, n_rx=4) for b in (64, 128)]
    ))
    specs.append((
        "c2_receiver_4rx4l_llr256",
        [dict(kwargs=kwargs, batch=b, n_rx=4, modulation="256qam") for b in (64, 128)],
    ))
    # Quality-bearing serving modes: recurring cost rows
    # so the "3-4x"-class claims (ARCHITECTURE.md time_interp note) and the
    # wiener/learned2d/tracked serving costs are re-measured every round, each
    # with a correctness gate (QUALITY_GATES below).
    q_kw = dict(n_prbs=52, n_layers=2, comb=2, scs_hz=30e3)
    specs.append(("q_base_52prb_2l", [dict(kwargs=q_kw, batch=128)]))
    specs.append((
        "q_wiener_52prb_2l",
        [dict(kwargs=dict(q_kw, smoothing="wiener"), batch=128)],
    ))
    specs.append((
        "q_time_interp_52prb_2l",
        [dict(kwargs=dict(q_kw, time_interp="linear", doppler_hz=300.0), batch=128)],
    ))
    specs.append((
        "q_tracked_52prb_2l",
        [dict(kwargs=q_kw, batch=128, tracked=True)],
    ))
    params2d = _load_params2d()
    if params2d is not None:
        # same (PRB, layer) geometry as q_base so x_vs_plain_serve is a
        # like-for-like cost multiple (code review r05: the original nL=1 row
        # understated the multiple against the nL=2 base)
        specs.append((
            "q_learned2d_52prb",
            [dict(
                kwargs=dict(q_kw, smoothing="learned2d", time_interp="linear",
                            doppler_hz=300.0),
                batch=128, params=params2d,
            )],
        ))

    rows = select_batch_rows(specs)

    # ---- Phase 2: K interleaved measurement passes over ALL rows ----
    for k in range(K_SLOPES):
        for name, (row, meta) in rows.items():
            try:
                row.slopes.append(row.measure_once())
            except Exception as e:
                log(f"{name} pass {k} FAILED: {type(e).__name__}: {e}")
        log(f"slope pass {k + 1}/{K_SLOPES} done")

    # ---- Phase 2.5: post-hoc chain-length escalation (r05: no row publishes
    # with spread_warn while a longer chain can fix it) ----
    for esc in range(len(REPS_LONGER)):
        noisy = [
            (n, rw)
            for n, (rw, _m) in rows.items()
            if rw.slopes and rw.stats()["spread_warn"]
        ]
        if not noisy:
            break
        moved = []
        for name, rw in noisy:
            if not rw.escalate():
                continue  # tiers exhausted; spread_warn stands, documented
            moved.append(name)
            try:
                for _ in range(K_SLOPES):
                    rw.slopes.append(rw.measure_once())
            except Exception as e:
                log(f"{name} escalation FAILED: {type(e).__name__}: {e}")
        if not moved:
            break
        log(f"escalation round {esc + 1}: re-measured {moved} at longer chains")

    # ---- Phase 3: details + correctness gates ----
    for name, (row, meta) in rows.items():
        try:
            if not row.slopes and row.archived_slopes:
                # escalated but the longer chain failed to measure: fall back
                # to the archived short-chain pool rather than losing the row
                row.slopes, row.archived_slopes = row.archived_slopes, []
            if not row.slopes:
                raise RuntimeError("no successful slope estimate")
            r = row_details(row, meta)
            case, nL = meta["case"], meta["nL"]
            if name in BENCH_CONFIGS:
                r["nmse_vs_oracle"] = _nmse_vs_oracle(case, nL)
                assert r["nmse_vs_oracle"] < 1e-6, f"bench correctness gate: {r['nmse_vs_oracle']}"
                r["nmse_vs_oracle_serve"] = _nmse_vs_oracle_serve(case, nL)
                assert r["nmse_vs_oracle_serve"] < 1e-6, (
                    f"serve correctness gate: {r['nmse_vs_oracle_serve']}"
                )
                if name == HEADLINE:
                    # conformance (ref-layout) path: exact fill, ~5e-15 — the
                    # round-2 "c2 outlier" (6.3e-11) came from HIGH-precision
                    # matmuls on multi-layer profiles (fused smoothing, now pinned
                    # to HIGHEST everywhere) and the fill (pinned on the ref path)
                    assert r["nmse_vs_oracle"] < 1e-12, (
                        f"c2 conformance NMSE regression: {r['nmse_vs_oracle']}"
                    )
                    # serving path: fill stays at 'high' (3-pass bf16; exactness
                    # costs a measured +15% latency) — hold its documented bound
                    assert r["nmse_vs_oracle_serve"] < 4e-11, (
                        f"c2 serve NMSE regression: {r['nmse_vs_oracle_serve']}"
                    )
                bl = baseline.get(name, {}).get("res_per_s")
                r["vs_reference_cpu"] = (r["res_per_s"] / bl) if bl else None
            if name in QUALITY_GATES:
                r.update(QUALITY_GATES[name](case, nL, meta.get("params")))
                base = details.get("q_base_52prb_2l", {}).get("latency_ms_per_batch")
                if base:
                    # cost multiple vs the plain filter serve path at the SAME
                    # geometry, same run (the recurring home of the "3-4x"
                    # time-interp class claims)
                    r["x_vs_plain_serve"] = r["latency_ms_per_batch"] / base
            details[name] = r
            warn = " [SPREAD>10%]" if r["spread_warn"] else ""
            log(
                f"{name}: {r['latency_ms_per_batch']:.3f} ms/batch{r['batch']} "
                f"(min of {len(row.slopes)}, spread {r['slope_spread']:.1%}{warn}) -> "
                f"{r['res_per_s']:.3e} REs/s"
                + (f", nmse {r['nmse_vs_oracle']:.1e}" if "nmse_vs_oracle" in r else "")
            )
        except Exception as e:  # keep the bench robust; report what ran
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            details[name] = {"error": str(e)}
    # free row executables before the decoder benches
    for name, (row, meta) in rows.items():
        row.fns.clear()
    rows = None

    # QC-LDPC decode throughput (ops/ldpc): 25-iteration normalized min-sum on
    # the rate-0.63 n=976 code the coded link-level eval uses, batch 512 words.
    # Chained with a clipped-posterior feedback (min-sum grows LLR magnitudes
    # every sweep; unclipped feedback overflows f32 across the rep chain).
    try:
        import numpy as _np

        from srsran_ce.ops import ldpc as _ldpc

        code = _ldpc.array_code(6, 16, 61)
        lplan = _ldpc.make_ldpc_plan(code)
        rng = _np.random.default_rng(0)
        u = rng.integers(0, 2, (512, lplan.k), dtype=_np.uint8)
        cw = _ldpc.encode(code, u)
        snr = 10.0**0.4
        llr = (
            4 * snr * ((1 - 2.0 * cw) + rng.normal(0, _np.sqrt(0.5 / snr), cw.shape))
        ).astype(_np.float32)
        dec = _ldpc.build_decoder(code, n_iters=25, kernels="auto")
        res = dec(llr)
        assert bool(_np.asarray(res.ok).all()) and _np.array_equal(
            _np.asarray(res.info), u
        ), "LDPC decode correctness gate failed on device"
        fb = lambda carry, out: jax.lax.optimization_barrier(jnp.clip(out, -20.0, 20.0))
        st = profiling.chained_slope_stats(
            lambda l: dec(l).posterior, fb, (jnp.asarray(llr),), reps_lo=4, reps_hi=20,
            k=K_SLOPES,
        )
        t = st["s_per_step"]
        # layered schedule at the matched-quality sweep count (~half of
        # flooding's; gate it on decoding this batch payload-exactly)
        dec_lay = _ldpc.build_decoder(code, n_iters=13, kernels="auto", schedule="layered")
        res_l = dec_lay(llr)
        lay_ok = bool(_np.asarray(res_l.ok).all()) and _np.array_equal(
            _np.asarray(res_l.info), u
        )
        r = {
            "latency_ms_per_batch": t * 1e3,
            "slope_spread": st["spread"],
            "layered13_payload_exact": lay_ok,
            "batch": 512,
            "code": "array(6,16,61) n=976 k=%d rate=%.2f" % (lplan.k, lplan.k / code.n),
            "n_iters": 25,
            "info_bits_per_s": 512 * lplan.k / t,
            "edge_msgs_per_s": 512 * len(lplan.edges) * code.z * 25 / t,
        }
        lay_msg = "exact=False (speedup withheld)"
        if lay_ok:
            # a layered speedup is only publishable from a payload-exact decode
            # (ADVICE r03: a wrong decode must not advertise its throughput)
            st_lay = profiling.chained_slope_stats(
                lambda l: dec_lay(l).posterior, fb, (jnp.asarray(llr),),
                reps_lo=16, reps_hi=64, k=K_SLOPES,
            )
            t_lay = st_lay["s_per_step"]
            r["layered13_ms_per_batch"] = t_lay * 1e3
            r["layered13_info_bits_per_s"] = 512 * lplan.k / t_lay
            lay_msg = (
                f"{t_lay*1e3:.3f} ms ({r['layered13_info_bits_per_s']/1e6:.0f} Mb/s, exact=True)"
            )
        details["ldpc_decode_n976_b512"] = r
        log(
            f"ldpc_decode_n976_b512: {t*1e3:.3f} ms/batch512 (auto tier, "
            f"spread {st['spread']:.1%}) -> "
            f"{r['info_bits_per_s']/1e6:.1f} info Mb/s; "
            f"layered-13 {lay_msg}"
        )
    except Exception as e:
        log(f"ldpc_decode FAILED: {type(e).__name__}: {e}")
        details["ldpc_decode_n976_b512"] = {"error": str(e)}

    # NR LDPC decode (TS 38.212-structured base graphs, ops/nr_ldpc). The
    # flooding rows run kernels="auto". Layered rows run the row-serial
    # schedule at HALF the sweeps (the classic ~2x convergence-per-sweep
    # property), gated on decoding the same payload exactly.
    for bname, bg, z, iters, batch, try_layered in (
        ("nr_bg2_z208", 2, 208, 16, 128, True),
        ("nr_bg1_z52", 1, 52, 16, 128, True),
        ("nr_bg1_z384", 1, 384, 16, 32, False),
    ):
        try:
            import numpy as _np

            from srsran_ce.ops import ldpc as _ldpc
            from srsran_ce.ops import nr_ldpc as _nr

            code = _nr.nr_base_graph(bg, z)
            lplan = _ldpc.make_ldpc_plan(code)
            rng = _np.random.default_rng(0)
            u = rng.integers(0, 2, (batch, lplan.k), dtype=_np.uint8)
            cw = _ldpc.encode(code, u)
            snr = 10.0**0.35
            llr = (
                4 * snr * ((1 - 2.0 * cw) + rng.normal(0, _np.sqrt(0.5 / snr), cw.shape))
            ).astype(_np.float32)
            dec = _ldpc.build_decoder(code, n_iters=iters, kernels="auto")
            res = dec(llr)
            assert bool(_np.asarray(res.ok).all()) and _np.array_equal(
                _np.asarray(res.info), u
            ), f"{bname} decode correctness gate failed"
            fb = lambda carry, out: jax.lax.optimization_barrier(jnp.clip(out, -20.0, 20.0))
            st = profiling.chained_slope_stats(
                lambda l: dec(l).posterior, fb, (jnp.asarray(llr),), reps_lo=4, reps_hi=16,
                k=K_SLOPES,
            )
            t = st["s_per_step"]
            tier = _ldpc.select_tier("auto", "flooding", jax.default_backend())
            r = {
                "latency_ms_per_batch": t * 1e3,
                "slope_spread": st["spread"],
                "batch": batch,
                "code": f"NR BG{bg} Z={z} n={code.n} k={lplan.k}",
                "n_iters": iters,
                "tier": tier,
                "info_bits_per_s": batch * lplan.k / t,
            }
            lay_msg = ""
            if try_layered:
                g_sel = 1
                dec_lay = _ldpc.build_decoder(
                    code, n_iters=iters // 2, kernels="auto", schedule="layered",
                    layered_group=g_sel,
                )
                res_l = dec_lay(llr)
                lay_ok = bool(_np.asarray(res_l.ok).all()) and _np.array_equal(
                    _np.asarray(res_l.info), u
                )
                r["layered_payload_exact"] = lay_ok
                r["layered_group"] = g_sel
                r["layered_tier"] = _ldpc.layered_tier(jax.default_backend())
                lay_msg = f"; layered-{iters//2} exact=False (speedup withheld)"
                if lay_ok:
                    st_lay = profiling.chained_slope_stats(
                        lambda l: dec_lay(l).posterior, fb, (jnp.asarray(llr),),
                        reps_lo=4, reps_hi=16, k=K_SLOPES,
                    )
                    t_lay = st_lay["s_per_step"]
                    r["layered_half_iters_ms_per_batch"] = t_lay * 1e3
                    r["layered_info_bits_per_s"] = batch * lplan.k / t_lay
                    r["layered_speedup"] = t / t_lay
                    lay_msg = (
                        f"; layered-{iters//2} {t_lay*1e3:.3f} ms "
                        f"({r['layered_info_bits_per_s']/1e6:.0f} Mb/s, "
                        f"{r['layered_speedup']:.2f}x, exact=True)"
                    )
            details[bname] = r
            log(
                f"{bname} [{r['tier']}]: {t*1e3:.3f} ms/batch{batch} ({iters} iters, "
                f"spread {st['spread']:.1%}) -> "
                f"{r['info_bits_per_s']/1e6:.1f} info Mb/s (n={code.n})" + lay_msg
            )
        except Exception as e:
            log(f"{bname} FAILED: {type(e).__name__}: {e}")
            details[bname] = {"error": str(e)}

    # Layered decoding of the large NR codes through kernels="auto" with bf16
    # messages, payload-exact gated.
    for sname, z_s, iters_s, batch_s in (
        ("nr_bg1_z384_streamed", 384, 8, 128),
        ("nr_bg1_z240_streamed", 240, 8, 128),
    ):
        try:
            import numpy as _np

            from srsran_ce.ops import ldpc as _ldpc
            from srsran_ce.ops import nr_ldpc as _nr

            code = _nr.nr_base_graph(1, z_s)
            lplan = _ldpc.make_ldpc_plan(code)
            rng = _np.random.default_rng(0)
            u = rng.integers(0, 2, (batch_s, lplan.k), dtype=_np.uint8)
            cw = _ldpc.encode(code, u)
            snr = 10.0**0.35
            llr = (
                4 * snr * ((1 - 2.0 * cw) + rng.normal(0, _np.sqrt(0.5 / snr), cw.shape))
            ).astype(_np.float32)
            g_sel = 1
            dec = _ldpc.build_decoder(
                code, n_iters=iters_s, kernels="auto", schedule="layered",
                layered_group=g_sel, stream_c2v_dtype="bfloat16",
            )
            res = dec(llr)
            ok = bool(_np.asarray(res.ok).all()) and _np.array_equal(
                _np.asarray(res.info), u
            )
            assert ok, f"streamed BG1 Z={z_s} decode not payload-exact; withheld"
            fb = lambda carry, out: jax.lax.optimization_barrier(
                jnp.clip(out, -20.0, 20.0)
            )
            st = profiling.chained_slope_stats(
                lambda l: dec(l).posterior, fb, (jnp.asarray(llr),),
                reps_lo=4, reps_hi=16, k=K_SLOPES,
            )
            t = st["s_per_step"]
            r = {
                "latency_ms_per_batch": t * 1e3,
                "slope_spread": st["spread"],
                "escalations": st.get("escalations", 0),
                "batch": batch_s,
                "code": f"NR BG1 Z={z_s} n={code.n} k={lplan.k}",
                "n_iters": iters_s,
                "schedule": "layered",
                "tier": _ldpc.layered_tier(jax.default_backend()),
                "layered_group": g_sel,
                "stream_c2v_dtype": "bfloat16",
                "payload_exact": ok,
                "info_bits_per_s": batch_s * lplan.k / t,
            }
            g = details.get("nr_bg1_z384", {}).get("info_bits_per_s")
            if g:
                # the measured gather-tier anchor is the Z=384 row above; at
                # Z=240 the per-sweep gather work is ~Z-proportional, so the
                # same-Z comparison is conservative for the dead-zone row
                r["speedup_vs_gather_tier_z384"] = r["info_bits_per_s"] / g
            details[sname] = r
            log(
                f"{sname} [{r['tier']}, layered-{iters_s}, G={g_sel}]: "
                f"{t*1e3:.3f} ms/batch{batch_s} (spread {st['spread']:.1%}) -> "
                f"{r['info_bits_per_s']/1e6:.1f} info Mb/s"
                + (f" ({r['speedup_vs_gather_tier_z384']:.0f}x the z384 gather row)" if g else "")
            )
        except Exception as e:
            log(f"{sname} FAILED: {type(e).__name__}: {e}")
            details[sname] = {"error": str(e)}

    # ---- Full NR uplink chain, end to end: 273-PRB QPSK
    # slots carrying TS 38.212 §5.4.2 rate-matched BG1 Z=384 words through
    # serving.process(out="decoded") — estimate -> joint MMSE -> int8 demap ->
    # deinterleave -> streamed layered decode -> CRC24B, HOST-side timing over
    # slot count (the per-slot slope includes packing, host transfers and the
    # decode post-pass: a regression in any seam moves this number). Min-of-K
    # slopes with the shared robust policy; payload-exact gate on every pass.
    try:
        import numpy as _np

        from srsran_ce import serving, transport
        from srsran_ce.ops import demap as _demap
        from srsran_ce.ops import ldpc as _ldpc
        from srsran_ce.ops import nr_ldpc as _nr
        from srsran_ce.ops import sequences as _seq  # noqa: F401

        code = _nr.nr_base_graph(1, 384)
        lplan = _ldpc.make_ldpc_plan(code)
        g_sel = 1
        coding = transport.TransportCoding(
            code=code, rate_match="nr", tx_bits=2 * 8448, schedule="layered",
            n_iters=16, crc="crc24b", interleave_seed=7, layered_group=g_sel,
            stream_c2v_dtype="bfloat16",
        )
        nbits = _demap.bits_per_symbol("qpsk")
        seed = 4242
        geo = synthetic.make_case(seed=seed, snr_db=15.0, n_prbs=273, n_layers=1)
        n_sc, n_sym = geo.received_rg.shape
        lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
        k_pay = transport.payload_bits(coding, lplan.k)
        rng = _np.random.default_rng(seed)
        u = rng.integers(0, 2, (lay.c_words, k_pay), dtype=_np.uint8)
        words = transport.crc_attach(u, "crc24b")
        if coding.n_filler:
            words = _np.concatenate(
                [words, _np.zeros((lay.c_words, coding.n_filler), _np.uint8)], axis=1
            )
        bits = transport.place_codewords(
            lay, _ldpc.encode(code, words), 1, nbits, fill_rng=rng
        )
        case = synthetic.make_mimo_case(
            seed=seed, n_rx=1, modulation="qpsk", scramble=False, bits=bits,
            n_prbs=273, n_layers=1, snr_db=15.0,
        )
        prob = serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            case.beta, case.hop1, case.hop2, case.config,
        )

        def run_slots(n, on_device=False):
            t0 = time.time()
            res = serving.process(
                [prob] * n, batch_size=8, out="decoded", modulation="qpsk",
                coding=coding, matmul_precision="high",
                decode_on_device=on_device,
            )
            dt = time.time() - t0
            for rr in res:  # payload-exact gate on EVERY timed pass
                assert bool(_np.asarray(rr.ok).all()) and _np.array_equal(
                    rr.info, u
                ), "e2e decoded chain not payload-exact; throughput withheld"
            return dt

        n_lo, n_hi = 8, 24
        run_slots(n_lo)  # warm/compile both chunk shapes
        run_slots(n_hi)

        def host_slopes(reps_inner):
            sl = []
            for _ in range(K_SLOPES):
                t_lo = min(run_slots(n_lo) for _ in range(reps_inner))
                t_hi = min(run_slots(n_hi) for _ in range(reps_inner))
                sl.append(max((t_hi - t_lo) / (n_hi - n_lo), 1e-9))
            return sl

        slopes_e2e = host_slopes(2)
        t_slot, spread_e2e, n_disc_e2e, _ = robust_slope_stats(slopes_e2e)
        if spread_e2e > SPREAD_WARN:
            # host-clock jitter on ~1 s wall times: escalate inner repeats
            # (same remedy as the device sub-measurement below)
            slopes_e2e = host_slopes(4)
            t_slot, spread_e2e, n_disc_e2e, _ = robust_slope_stats(slopes_e2e)
        # the round-5 DEVICE-RESIDENT chain (decode_on_device=True): the LLR
        # grid never crosses to the host — only decoded bits do. The chain is
        # fast enough (~20 ms/slot) that host-clock jitter dominates small
        # deltas: use a wider slot range + more inner repeats, and escalate
        # once more on a noisy spread.
        n_hi_dev = 3 * n_hi
        run_slots(n_lo, on_device=True)
        run_slots(n_hi_dev, on_device=True)

        def dev_slopes(reps_inner):
            sl = []
            for _ in range(K_SLOPES):
                t_lo = min(run_slots(n_lo, True) for _ in range(reps_inner))
                t_hi = min(run_slots(n_hi_dev, True) for _ in range(reps_inner))
                sl.append(max((t_hi - t_lo) / (n_hi_dev - n_lo), 1e-9))
            return sl

        slopes_dev = dev_slopes(2)
        t_dev, spread_dev, _, _ = robust_slope_stats(slopes_dev)
        if spread_dev > SPREAD_WARN:
            slopes_dev = dev_slopes(4)
            t_dev, spread_dev, _, _ = robust_slope_stats(slopes_dev)
        info_bits_slot = lay.c_words * k_pay
        details["e2e_decoded_273prb_bg1z384"] = {
            "latency_ms_per_slot": t_slot * 1e3,
            "slope_estimates_ms": [s * 1e3 for s in slopes_e2e],
            "slope_spread": spread_e2e,
            "n_slopes_discarded": n_disc_e2e,
            "slots": [n_lo, n_hi],
            "words_per_slot": int(lay.c_words),
            "info_bits_per_slot": int(info_bits_slot),
            "code": f"NR BG1 Z=384 rate-matched E={coding.tx_bits} crc24b",
            "schedule": f"layered-{coding.n_iters} G={g_sel} (auto -> {_ldpc.layered_tier(jax.default_backend())})",
            "payload_exact": True,
            "info_bits_per_s": info_bits_slot / t_slot,
            "device_decode_ms_per_slot": t_dev * 1e3,
            "device_decode_spread": spread_dev,
            "device_decode_slope_estimates_ms": [s * 1e3 for s in slopes_dev],
            "device_decode_info_bits_per_s": info_bits_slot / t_dev,
            "device_decode_speedup": t_slot / t_dev,
            "note": (
                "host wall-clock slope over slot count through serving.process"
                "(out='decoded'): includes native packing, estimation+MMSE+demap "
                "on device, int8 LLR fetch, descramble/deinterleave, "
                "chunked layered decode, CRC; decoder chunks pad to power-of-2 "
                "buckets so the slope is conservative. device_decode_* = the "
                "round-5 decode_on_device=True chain (in-graph descramble/"
                "deinterleave/rate-recovery/decode; only decoded bits cross "
                "to the host)"
            ),
        }
        log(
            f"e2e_decoded_273prb_bg1z384: {t_slot*1e3:.1f} ms/slot "
            f"(spread {spread_e2e:.1%}, {lay.c_words} words/slot) -> "
            f"{info_bits_slot / t_slot / 1e6:.1f} info Mb/s end-to-end; "
            f"device-resident {t_dev*1e3:.1f} ms/slot "
            f"({t_slot/t_dev:.1f}x, spread {spread_dev:.1%})"
        )
    except Exception as e:
        log(f"e2e_decoded FAILED: {type(e).__name__}: {e}")
        details["e2e_decoded_273prb_bg1z384"] = {"error": str(e)}

    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_DETAILS.json")
    with open(out_path, "w") as f:
        json.dump({"device": str(dev), "configs": details}, f, indent=2)

    head = details.get(HEADLINE, {})
    value = head.get("res_per_s", 0.0)
    vs = head.get("vs_reference_cpu") or 0.0
    print(
        json.dumps(
            {
                "metric": "channel-estimate REs/s/chip (106PRB 4-port MMSE)",
                "value": value,
                "unit": "REs/s",
                "vs_baseline": vs,
                "slope_spread": head.get("slope_spread"),
                "n_slope_estimates": len(head.get("slope_estimates_ms", [])),
            }
        )
    )


if __name__ == "__main__":
    main()
