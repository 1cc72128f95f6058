"""Deep-fuzz evidence runner — breadth coverage as an AUDITABLE artifact.

The repo's three fuzzers used to be opt-in env knobs on the test suite
(CE_FUZZ_N / CE_FUZZ_CODED_N / CE_FUZZ_HEADER_N); this module packages the same
coverage as a recorded run: `cli selftest --deep` executes all three at depth
and writes a committed JSON report (cases run, NMSE histogram, worst case), so
breadth claims are auditable instead of reproducible-in-principle
(SURVEY.md §4 implication (c)).

The three sweeps:
  geometry  — random (PRBs, layers, comb, SCS, smoothing, CFO, interp, hops,
              holes, pilot source, time-interp, Doppler) configurations through
              the production estimator vs the float64 numpy oracle
              (tests/test_fuzz_conformance.py runs the same draw function).
  coded     — random (modulation, code options, CRC, schedule, scramble, MIMO)
              configurations through the FULL served chain: encode ->
              interleave -> modulate -> channel -> estimate -> joint MMSE ->
              int8 demap -> descramble -> decode; exact payload recovery.
  header    — full-format-fidelity C++ test-header parser + hop-regrouping
              fuzz (generated FROM INTENT; checks recovery of the truth).

All functions return plain dicts; pass/fail policy lives in the callers
(pytest asserts, CLI exit code).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

# NMSE bound for the geometry sweep: the float64 (x64) estimator matches the
# oracle to reassociation error; tests/test_fuzz_conformance.py uses the same.
GEOMETRY_NMSE_BOUND = 1e-18


def draw_geometry(rng: np.random.Generator) -> dict:
    """One random estimator geometry (the same draw the pytest fuzzer uses)."""
    two_hops = bool(rng.random() < 0.25)
    smoothing = rng.choice(["filter", "filter", "mean", "none", "wiener"])
    comb = int(rng.choice([2, 2, 3, 4, 6]))
    n_layers = int(rng.choice([1, 1, 2, 3, 4]))
    if two_hops:
        n_prbs = int(rng.choice([3, 6, 12, 24, 52]))
    else:
        n_prbs = int(rng.choice([1, 2, 5, 16, 24, 52, 106, 273]))
    n_dmrs_syms = int(rng.choice([2, 4] if two_hops else [1, 2, 4]))
    kw = dict(
        n_prbs=n_prbs,
        n_layers=n_layers,
        comb=comb,
        scs_hz=float(rng.choice([15e3, 30e3])),
        smoothing=str(smoothing),
        cfo_compensate=bool(rng.random() < 0.7),
        interp=str(rng.choice(["linear", "linear", "cnn"])),
        cnn_alpha=float(rng.choice([0.0, 0.0, 0.3])),
        two_hops=two_hops,
        n_dmrs_syms=n_dmrs_syms,
        snr_db=float(rng.uniform(10.0, 40.0)),
        cfo_hz=float(rng.uniform(-300.0, 300.0)),
        beta=float(rng.choice([1.0, 1.0, 1.4125])),
        time_interp=str(rng.choice(["none", "none", "linear"])),
        doppler_hz=float(rng.choice([0.0, 0.0, 300.0])),
        cfo_estimator=str(rng.choice(["first_pair", "first_pair", "wls"])),
    )
    if not two_hops and rng.random() < 0.3:
        # offset band inside a wider carrier
        pad = int(rng.integers(1, 30))
        kw["n_prb_total"] = n_prbs + 2 * pad
        kw["prb_start"] = pad
    if n_prbs >= 4 and rng.random() < 0.2:
        # non-contiguous maskPRBs: interior hole (reference supports arbitrary
        # maskPRBs, validate_all.py:150-197 reassembles them from mask runs)
        h0 = int(rng.integers(1, n_prbs - 2))
        h1 = int(rng.integers(h0 + 1, n_prbs))
        kw["prb_hole"] = (h0, h1)
    if comb == 2 and rng.random() < 0.3:
        # standard TS 38.211 sequences instead of random QPSK pilots
        hole = kw.get("prb_hole")
        n_prbs_eff = n_prbs - (hole[1] - hole[0] if hole else 0)
        m_zc = n_prbs_eff * 6
        if m_zc >= 36 or m_zc == 30:  # 30 = closed-form short sequence
            kw["pilot_source"] = str(rng.choice(["dmrs", "srs"]))
        else:
            kw["pilot_source"] = "dmrs"
        if kw["pilot_source"] == "dmrs" and rng.random() < 0.3:
            kw["dmrs_type"] = 2  # adjacent-pair clusters, 4 REs/PRB
    return kw


def check_geometry(draw: int, seed_base: int = 0xCE_F0) -> dict:
    """Run one fuzzed geometry through the production estimator and the
    float64 oracle; returns {kwargs, nmse, scalar_errs, factored_err, ok}."""
    from ..models import estimator
    from ..utils import oracle, synthetic

    rng = np.random.default_rng(seed_base + draw)
    kw = draw_geometry(rng)
    case = synthetic.make_case(seed=int(rng.integers(0, 2**31)), **kw)
    res_j = estimator.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    res_o = oracle.estimate(
        case.received_rg, case.pilots, case.beta, case.hop1, case.hop2, case.config
    )
    ch_j = np.asarray(res_j.channel_est_rg)
    ch_o = res_o.channel_est_rg
    nmse = float(
        np.sum(np.abs(ch_j - ch_o) ** 2) / (np.sum(np.abs(ch_o) ** 2) + 1e-30)
    )

    def rel(a, b, atol=0.0):
        # allclose semantics: an absolute floor covers true-zero quantities
        # (e.g. smoothing="none" + 1 DM-RS symbol reconstructs the pilots
        # EXACTLY, so the noise estimate is pure rounding ~1e-33 and a bare
        # relative error is meaningless)
        return float(abs(a - b) / (abs(b) + atol / 1e-7 + 1e-300))

    scalar_errs = {
        "noise": rel(float(res_j.noise_est), res_o.noise_est, atol=1e-20),
        "rsrp": rel(float(res_j.rsrp), res_o.rsrp),
        "epre": rel(float(res_j.epre), res_o.epre),
        "ta": float(abs(float(res_j.time_alignment) - res_o.time_alignment)),
    }
    if res_o.cfo_hz is None:
        cfo_ok = bool(np.isnan(float(res_j.cfo_hz)))
        scalar_errs["cfo"] = 0.0 if cfo_ok else float("inf")
    else:
        scalar_errs["cfo"] = rel(float(res_j.cfo_hz), res_o.cfo_hz)

    factored_err = None
    if case.config.time_interp == "none":
        n_layers = case.pilots.shape[2]
        r_fac = estimator.build_ri(
            case.hop1, case.hop2, case.config, n_layers, out_layout="factored"
        )(
            estimator.split_ri(case.received_rg),
            estimator.split_ri(case.pilots),
            np.asarray(case.beta),
        )
        grid = estimator.reconstruct_factored(
            estimator.merge_ri(np.asarray(r_fac.profiles)),
            estimator.merge_ri(np.asarray(r_fac.sym_rot)),
            case.hop1,
            case.hop2,
        )
        factored_err = float(
            np.max(np.abs(grid - ch_j)) / (np.max(np.abs(ch_j)) + 1e-30)
        )

    ok = (
        nmse < GEOMETRY_NMSE_BOUND
        and scalar_errs["noise"] < 1e-7
        and scalar_errs["rsrp"] < 1e-8
        and scalar_errs["epre"] < 1e-8
        and scalar_errs["ta"] < 1e-12
        and scalar_errs["cfo"] < 1e-7
        and (factored_err is None or factored_err < 1e-11)
    )
    return {
        "draw": draw,
        "kwargs": {k: (list(v) if isinstance(v, tuple) else v) for k, v in kw.items()},
        "nmse": nmse,
        "scalar_errs": scalar_errs,
        "factored_err": factored_err,
        "ok": ok,
    }


def run_geometry_fuzz(n: int, seed_base: int = 0xCE_F0, progress=None) -> dict:
    """N geometry draws; returns a report with an NMSE histogram (log10 bins)
    and the worst case's full configuration."""
    t0 = time.time()
    rows = []
    for d in range(n):
        rows.append(check_geometry(d, seed_base))
        if progress and (d + 1) % 10 == 0:
            progress(f"geometry {d + 1}/{n}")
    nmses = np.array([r["nmse"] for r in rows])
    worst = max(rows, key=lambda r: r["nmse"])
    hist = {}
    for r in rows:
        b = "<=-24" if r["nmse"] <= 1e-24 else str(int(np.ceil(np.log10(r["nmse"]))))
        hist[b] = hist.get(b, 0) + 1
    return {
        "n_cases": n,
        "n_pass": int(sum(r["ok"] for r in rows)),
        "nmse_bound": GEOMETRY_NMSE_BOUND,
        "nmse_log10_histogram": dict(sorted(hist.items())),
        "nmse_max": float(nmses.max()),
        "nmse_median": float(np.median(nmses)),
        "worst_case": worst,
        "failures": [r for r in rows if not r["ok"]],
        "elapsed_s": time.time() - t0,
    }


def coded_trial(trial: int) -> dict:
    """One coded-chain fuzz trial (same draw as tests/test_fuzz_coded.py):
    full served TX->RX chain must recover the exact payload."""
    from .. import serving, transport
    from ..ops import demap, ldpc, sequences
    from ..utils import synthetic

    rng = np.random.default_rng(8800 + trial)
    two_hops = bool(trial % 3 == 1)
    n_prbs = int(rng.choice([6, 12, 18] if not two_hops else [4, 6]))
    n_layers = int(rng.choice([1, 2]))
    n_rx = int(rng.choice([1, 2, 3]))
    if n_rx < n_layers:
        n_rx = n_layers
    modulation = str(rng.choice(["bpsk", "qpsk", "16qam", "256qam", "1024qam"]))
    scramble = bool(rng.integers(0, 2))
    crc = str(rng.choice(["crc16", "crc24b"])) if rng.integers(0, 2) else None
    schedule = "layered" if rng.integers(0, 2) else "flooding"
    early = int(rng.choice([0, 6]))  # 0 -> disabled
    code = ldpc.array_code(4, 8, 23)  # n=184, rate ~0.5
    plan = ldpc.make_ldpc_plan(code)
    nbits = demap.bits_per_symbol(modulation)
    snr_db = {"256qam": 35.0, "1024qam": 42.0}.get(modulation, 30.0)
    if modulation in ("256qam", "1024qam"):
        n_rx = max(n_rx, n_layers + 1)
    seed = 9100 + trial
    rnti = 0x17A3
    c_init = sequences.pusch_scrambling_c_init(rnti, seed % 1024) if scramble else None
    coding = transport.TransportCoding(
        code=code, n_iters=25, interleave_seed=trial,
        scramble_c_init=c_init, crc=crc, schedule=schedule,
        early_iters=early or None,
    )
    geo = synthetic.make_case(
        seed=seed, snr_db=snr_db, n_prbs=n_prbs, n_layers=n_layers, two_hops=two_hops
    )
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, n_layers, nbits)
    kp = transport.payload_bits(coding, plan.k)
    u = rng.integers(0, 2, (lay.c_words, kp), dtype=np.uint8)
    payload = transport.crc_attach(u, crc) if crc else u
    bits = transport.place_codewords(
        lay, ldpc.encode(code, payload), n_layers, nbits, fill_rng=rng
    )
    case = synthetic.make_mimo_case(
        seed=seed, snr_db=snr_db, bits=bits, n_rx=n_rx, modulation=modulation,
        scramble=scramble, rnti=rnti, n_prbs=n_prbs, n_layers=n_layers,
        two_hops=two_hops,
    )
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        case.beta, case.hop1, case.hop2, case.config,
    )
    # every third trial runs the fully device-resident chain (round-5
    # decode_on_device: in-graph descramble/deinterleave/rate-recovery/decode);
    # it ignores early_iters, so pin them off for those draws
    on_device = bool(trial % 3 == 2)
    if on_device and early:
        import dataclasses as _dc

        coding = _dc.replace(coding, early_iters=None)
    res = serving.process(
        [prob], batch_size=4, out="decoded", modulation=modulation, coding=coding,
        matmul_precision=None, decode_on_device=on_device,
    )[0]
    cfg = dict(mod=modulation, prbs=n_prbs, nL=n_layers, rx=n_rx, hops=two_hops,
               scr=scramble, crc=crc, sched=schedule, early=early, words=lay.c_words,
               dev=on_device)
    ok = (
        res.info.shape == (lay.c_words, kp)
        and bool(np.asarray(res.ok).all())
        and np.array_equal(res.info, u)
    )
    return {"trial": trial, "config": cfg, "ok": bool(ok)}


def run_coded_fuzz(n: int, progress=None) -> dict:
    t0 = time.time()
    rows = []
    for t in range(n):
        rows.append(coded_trial(t))
        if progress and (t + 1) % 5 == 0:
            progress(f"coded {t + 1}/{n}")
    return {
        "n_cases": n,
        "n_pass": int(sum(r["ok"] for r in rows)),
        "configs": [r["config"] for r in rows],
        "failures": [r for r in rows if not r["ok"]],
        "elapsed_s": time.time() - t0,
    }


def draw_sp_case(rng: np.random.Generator) -> dict:
    """One random geometry for the shard_map-seam sweep (so that randomized
    geometries cross the shard_map seams in the recorded evidence). Draws the kind (plain estimator / joint receiver / tracked),
    the mesh split, hopped routes, non-divisible shard counts (pad+mask), and
    the smoothing/interp modes the SP builders support."""
    kind = str(rng.choice(["est", "est", "est", "est", "receiver", "tracked"]))
    n_sp = int(rng.choice([2, 4, 8]))
    two_hops = bool(rng.random() < 0.25)
    smoothings = ["filter", "filter", "mean", "none", "wiener"]
    if kind == "est" and not two_hops:
        smoothings.append("learned")
    smoothing = str(rng.choice(smoothings))
    if two_hops:
        n_prbs = int(rng.choice([4, 6, 12, 25]))
    else:
        # non-divisible counts (25/27/273) exercise the pad+mask route
        n_prbs = int(rng.choice([16, 24, 25, 27, 32, 52, 106, 273]))
    n_layers = int(rng.choice([1, 2, 2, 4] if kind != "receiver" else [1, 2]))
    comb = int(rng.choice([2, 2, 4]))
    if not two_hops:
        # honor make_shard_plan's documented geometry contracts: CDM pair
        # averaging (n_layers >= 2) needs EVEN per-shard pilot counts (R and
        # the masked last shard's n_rlast), and learned smoothing rejects the
        # padded route (the denoiser's conv stack has no band-edge
        # re-anchoring) — walk n_prbs up until the split is valid
        def _split_ok(p):
            n_re = p * (12 // comb)
            r = -(-n_re // n_sp)
            n_rlast = r - (n_sp * r - n_re)
            if n_layers >= 2 and (r % 2 or n_rlast % 2):
                return False
            if smoothing == "learned" and (n_re % n_sp or n_re // n_sp < 24):
                # no padded route, and the local block must cover the
                # denoiser's conv halo (18 taps for the shipped checkpoint)
                return False
            return True
        while not _split_ok(n_prbs):
            n_prbs += 1
    kw = dict(
        n_prbs=n_prbs,
        n_layers=n_layers,
        comb=comb,
        scs_hz=float(rng.choice([15e3, 30e3])),
        smoothing=smoothing,
        cfo_compensate=bool(rng.random() < 0.7),
        interp=str(rng.choice(["linear", "linear", "cnn"])),
        cnn_alpha=float(rng.choice([0.0, 0.0, 0.3])),
        two_hops=two_hops,
        snr_db=float(rng.uniform(10.0, 35.0)),
        cfo_hz=float(rng.uniform(-300.0, 300.0)),
        cfo_estimator=str(rng.choice(["first_pair", "first_pair", "wls"])),
    )
    if kind == "est" and rng.random() < 0.25 and smoothing != "learned":
        kw["time_interp"] = "linear"
        kw["doppler_hz"] = 300.0
    draw = dict(kind=kind, n_sp=n_sp, kw=kw)
    if kind == "est":
        draw["batched"] = bool(rng.random() < 0.5)
        draw["factored"] = bool(
            kw.get("time_interp", "none") == "none" and rng.random() < 0.3
        )
    if kind == "receiver":
        draw["n_rx"] = int(rng.choice([2, 3]))
        draw["modulation"] = str(rng.choice(["", "", "qpsk", "16qam"])) or None
    return draw


def check_sp_case(draw_idx: int, seed_base: int = 0xCE_59) -> dict:
    """Run one fuzzed geometry across the shard_map seams (2-8 virtual
    devices) and compare against the unsharded path: estimator draws gate on
    the float64 oracle (the same 1e-18 NMSE bound as the geometry sweep);
    receiver/tracked draws gate bitwise-tight (rtol 1e-9) against their
    unsharded builders."""
    import jax

    from ..models import estimator, receiver, tracking
    from ..parallel import mesh as mesh_lib
    from ..parallel.subcarrier import (
        build_sp,
        build_sp_batched,
        build_sp_receiver,
        build_sp_tracked,
    )
    from ..utils import oracle, synthetic

    rng = np.random.default_rng(seed_base + draw_idx)
    draw = draw_sp_case(rng)
    kind, n_sp, kw = draw["kind"], draw["n_sp"], draw["kw"]
    dp = max(1, len(jax.devices()) // n_sp)
    mesh = mesh_lib.make_mesh((dp, n_sp), ("dp", "sp"))
    ri = estimator.split_ri
    errs: dict = {}
    ok = True
    try:
        if kind == "est":
            case = synthetic.make_case(seed=int(rng.integers(0, 2**31)), **kw)
            nL = case.pilots.shape[2]
            params = None
            res_o = None
            if kw["smoothing"] == "learned":
                # no float64 oracle mirror for trainable weights: the gate for
                # learned draws is SP == unsharded (below)
                from ..models import training
                from pathlib import Path

                ckpt = Path(__file__).resolve().parents[1] / "artifacts" / "denoiser_ckpt.npz"
                # hand jit host arrays so it can replicate them over the mesh
                params = jax.tree_util.tree_map(
                    np.asarray, training.load_checkpoint(str(ckpt)).params
                )
            else:
                res_o = oracle.estimate(
                    case.received_rg, case.pilots, case.beta, case.hop1, case.hop2,
                    case.config,
                )
            if draw["batched"]:
                B = dp * 2
                fn = build_sp_batched(case.hop1, case.hop2, case.config, nL, mesh)
                rg_b = np.broadcast_to(ri(case.received_rg), (B,) + (2,) + case.received_rg.shape).copy()
                pil_b = np.broadcast_to(ri(case.pilots), (B, 2) + case.pilots.shape).copy()
                beta_b = np.full(B, case.beta)
                args = (rg_b, pil_b, beta_b) + ((params,) if params is not None else ())
                out = fn(*args)
                ch = estimator.merge_ri(np.asarray(out.channel_est_rg)[0])
                noise = float(np.asarray(out.noise_est)[0])
            else:
                fn = build_sp(case.hop1, case.hop2, case.config, nL, mesh)
                args = (ri(case.received_rg), ri(case.pilots), np.asarray(case.beta))
                args = args + ((params,) if params is not None else ())
                out = fn(*args)
                ch = estimator.merge_ri(np.asarray(out.channel_est_rg))
                noise = float(out.noise_est)
            if params is None:
                nmse = float(
                    np.sum(np.abs(ch - res_o.channel_est_rg) ** 2)
                    / (np.sum(np.abs(res_o.channel_est_rg) ** 2) + 1e-30)
                )
                errs["nmse_vs_oracle"] = nmse
                errs["noise_rel"] = float(
                    abs(noise - res_o.noise_est) / (abs(res_o.noise_est) + 1e-300)
                )
                ok = nmse < GEOMETRY_NMSE_BOUND and errs["noise_rel"] < 1e-7
            else:
                # learned smoothing has no oracle mirror: gate SP == unsharded
                fn_1 = estimator.build_ri(case.hop1, case.hop2, case.config, nL)
                out_1 = fn_1(
                    ri(case.received_rg), ri(case.pilots), np.asarray(case.beta),
                    params,
                )
                ch_1 = estimator.merge_ri(np.asarray(out_1.channel_est_rg))
                # unsharded is (sc, sym, L)-ref-layout too. Bound at f32
                # reassociation scale: the denoiser weights/conv stack are
                # float32 even under x64, and the halo split reassociates the
                # conv sums (measured ~1e-7 rel on wide geometries)
                err = float(
                    np.max(np.abs(ch - ch_1)) / (np.max(np.abs(ch_1)) + 1e-300)
                )
                errs["rel_vs_unsharded"] = err
                ok = err < 1e-6
            if ok and draw.get("factored"):
                builder = build_sp_batched if draw["batched"] else build_sp
                fnf = builder(
                    case.hop1, case.hop2, case.config, nL, mesh,
                    out_layout="factored",
                )
                rf = fnf(*args)
                prof = np.asarray(rf.profiles)
                rot = np.asarray(rf.sym_rot)
                if draw["batched"]:
                    prof, rot = prof[0], rot[0]
                grid = estimator.reconstruct_factored(
                    estimator.merge_ri(prof),
                    estimator.merge_ri(rot),
                    case.hop1, case.hop2,
                )
                errs["factored_rel"] = float(
                    np.max(np.abs(grid - ch)) / (np.max(np.abs(ch)) + 1e-300)
                )
                ok = errs["factored_rel"] < 1e-9
        elif kind == "receiver":
            kw = dict(kw)
            kw.pop("time_interp", None)
            kw.pop("doppler_hz", None)
            n_rx = max(draw["n_rx"], kw["n_layers"])
            case = synthetic.make_mimo_case(
                seed=int(rng.integers(0, 2**31)), n_rx=n_rx, scramble=False,
                modulation=draw["modulation"] or "qpsk",
                **{k: v for k, v in kw.items() if k in (
                    "n_prbs", "n_layers", "comb", "scs_hz", "smoothing",
                    "cfo_compensate", "interp", "cnn_alpha", "two_hops",
                    "snr_db", "cfo_hz", "cfo_estimator",
                )},
            )
            nL = case.pilots.shape[2]
            B = dp
            rg_b = np.broadcast_to(
                ri(case.received_rg), (B, 2) + case.received_rg.shape
            ).copy()
            pil_b = np.broadcast_to(ri(case.pilots), (B, 2) + case.pilots.shape).copy()
            beta_b = np.full(B, case.beta)
            fn_sp = build_sp_receiver(
                case.hop1, case.hop2, case.config, nL, mesh,
                modulation=draw["modulation"],
            )
            fn_1 = receiver.build_receiver_ri(
                case.hop1, case.hop2, case.config, nL, n_rx, batched=True,
                modulation=draw["modulation"],
            )
            out_sp = fn_sp(rg_b, pil_b, beta_b)
            out_1 = fn_1(rg_b, pil_b, beta_b)
            if draw["modulation"]:
                a = np.concatenate([np.asarray(p, np.float64) for p in out_sp.llr])
                b = np.concatenate([np.asarray(p, np.float64) for p in out_1.llr])
                # int8 LLRs: identical float math up to fusion reassociation;
                # round() can flip at quantization boundaries
                errs["llr_max_abs"] = float(np.abs(a - b).max())
                ok = errs["llr_max_abs"] <= 1.0
            else:
                a = np.asarray(out_sp.x, np.float64)
                b = np.asarray(out_1.x, np.float64)
                errs["x_rel"] = float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))
                ok = errs["x_rel"] < 1e-9
            na = np.asarray(out_sp.noise_est, np.float64)
            nb = np.asarray(out_1.noise_est, np.float64)
            errs["noise_rel"] = float(np.max(np.abs(na - nb) / (np.abs(nb) + 1e-300)))
            ok = ok and errs["noise_rel"] < 1e-9
        else:  # tracked
            kw = dict(kw)
            kw.pop("time_interp", None)
            kw.pop("doppler_hz", None)
            seed = int(rng.integers(0, 2**31))
            cases = [
                synthetic.make_case(seed=seed, noise_seed=900 + s, **kw)
                for s in range(2)
            ]
            c0 = cases[0]
            nL = c0.pilots.shape[2]
            f_sp = build_sp_tracked(c0.hop1, c0.hop2, c0.config, nL, mesh)
            f_un = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL)
            st_sp = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL)
            st_un = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL)
            worst = 0.0
            for c in cases:
                a = (ri(c.received_rg), ri(c.pilots), np.asarray(c.beta))
                r_sp, h_sp, w_sp = f_sp(*a, st_sp[0], st_sp[1])
                r_un, h_un, w_un = f_un(*a, st_un[0], st_un[1])
                st_sp = (tuple(np.asarray(h) for h in h_sp), np.asarray(w_sp))
                st_un = (tuple(np.asarray(h) for h in h_un), np.asarray(w_un))
                ga = np.asarray(r_sp.channel_est_rg, np.float64)
                gb = np.asarray(r_un.channel_est_rg, np.float64)
                worst = max(
                    worst,
                    float(np.max(np.abs(ga - gb)) / (np.max(np.abs(gb)) + 1e-300)),
                    float(abs(float(w_sp) - float(w_un)) / (abs(float(w_un)) + 1e-300)),
                )
            errs["tracked_rel"] = worst
            ok = worst < 1e-9
    except Exception as e:  # a crash on a valid draw is a failure, recorded
        errs["exception"] = f"{type(e).__name__}: {e}"
        ok = False
    return {
        "draw": draw_idx,
        "kind": kind,
        "n_sp": n_sp,
        "config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in kw.items()},
        "extras": {k: v for k, v in draw.items() if k not in ("kind", "n_sp", "kw")},
        "errs": errs,
        "ok": bool(ok),
    }


def run_sp_fuzz(n: int, seed_base: int = 0xCE_59, progress=None) -> dict:
    """N randomized geometries across the shard_map seams (needs >=2 JAX
    devices — the virtual 8-device CPU platform in tests/CLI)."""
    import jax

    t0 = time.time()
    if len(jax.devices()) < 2:
        return {
            "n_cases": 0,
            "n_pass": 0,
            "skipped": f"needs >=2 devices, have {len(jax.devices())}",
            "elapsed_s": 0.0,
        }
    rows = []
    for d in range(n):
        rows.append(check_sp_case(d, seed_base))
        if progress and (d + 1) % 5 == 0:
            progress(f"sp {d + 1}/{n}")
    kinds = {}
    for r in rows:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return {
        "n_cases": n,
        "n_pass": int(sum(r["ok"] for r in rows)),
        "kinds": kinds,
        "worst": max(
            (max(r["errs"].values()) for r in rows
             if r["errs"] and all(isinstance(v, float) for v in r["errs"].values())),
            default=0.0,
        ),
        "failures": [r for r in rows if not r["ok"]][:20],
        "elapsed_s": time.time() - t0,
    }


def run_header_fuzz(n_cases: int, seed: int = 20260820, tmp_dir: Optional[str] = None) -> dict:
    """Full-format-fidelity header-parser + hop-regrouping fuzz (the same
    truth-recovery checks as tests/test_fuzz_header.py)."""
    import tempfile
    from pathlib import Path

    from ..utils import vectors
    from . import conformance, synth_vectors

    t0 = time.time()
    rng = np.random.default_rng(seed)
    header, expected = synth_vectors.generate_fuzz_header(rng, n_cases)
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        path = Path(td) / "port_channel_estimator_test_data.h"
        path.write_text(header)
        cases = vectors.parse_test_header(path)

    failures = []
    if len(cases) != n_cases:
        failures.append(f"parsed {len(cases)} cases, emitted {n_cases}")
    for case, exp in zip(cases, expected):
        try:
            assert case.idx == exp["idx"]
            assert case.scs_hz == exp["scs_hz"]
            assert case.start_symbol == exp["start_symbol"]
            assert case.n_alloc_syms == exp["n_alloc_syms"]
            assert abs(case.beta_dmrs - exp["beta_dmrs"]) < 1e-9
            assert case.smoothing == exp["smoothing"]
            assert case.cfo_compensate == exp["cfo_compensate"]
            assert case.grid_size_prbs == exp["grid_size_prbs"]
            hops = conformance._group_hops(case)
            assert len(hops) == len(exp["hops"]), (
                f"hop count {len(hops)} != {len(exp['hops'])}"
            )
            for (mask, pm, rm), (e_syms, e_pm, e_rm) in zip(hops, exp["hops"]):
                got_syms = np.nonzero(mask)[0].tolist()
                assert got_syms == list(e_syms), (got_syms, e_syms)
                assert np.array_equal(np.asarray(pm, bool), np.asarray(e_pm, bool))
                got_cols = {rm[:, i].tobytes() for i in range(rm.shape[1])}
                want_cols = {
                    np.asarray(e_rm[:, i], bool).tobytes()
                    for i in range(e_rm.shape[1])
                }
                assert got_cols == want_cols, "re-mask columns mismatch"
                conformance.build_hop_config(
                    mask, pm, rm, case.start_symbol, case.n_alloc_syms
                )
        except AssertionError as e:
            failures.append(f"case {exp['idx']}: {e}")
    return {
        "n_cases": n_cases,
        "n_pass": n_cases - len(failures),
        "failures": failures[:20],
        "elapsed_s": time.time() - t0,
    }


def run_all(
    n_geometry: int = 100,
    n_coded: int = 30,
    n_header: int = 120,
    n_sp: int = 30,
    progress=None,
) -> dict:
    """The full deep-fuzz sweep; the CLI writes this dict as the committed
    DEEPFUZZ_REPORT.json."""
    import jax

    report = {
        "backend": jax.default_backend(),
        "x64": bool(jax.config.jax_enable_x64),
        "n_devices": len(jax.devices()),
        "geometry": run_geometry_fuzz(n_geometry, progress=progress),
        "coded": run_coded_fuzz(n_coded, progress=progress),
        "header": run_header_fuzz(n_header),
        "sp": run_sp_fuzz(n_sp, progress=progress),
    }
    report["all_pass"] = all(
        report[k]["n_pass"] == report[k]["n_cases"]
        for k in ("geometry", "coded", "header", "sp")
    )
    return report
