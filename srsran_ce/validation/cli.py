"""Unified CLI: validate / selftest / bench / diagnose subcommands.

Replaces the reference's scattered scripts (validate_all.py, validate_case{0,4,8}.py,
diagnose_furiosa_backend.py — SURVEY.md §2 #21-#24) with one entry point:

  python -m srsran_ce.validation.cli validate --data-dir testvector_outputs
  python -m srsran_ce.validation.cli validate --case 0 --case 4 --case 8
  python -m srsran_ce.validation.cli selftest
  python -m srsran_ce.validation.cli diagnose
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def cmd_validate(args) -> int:
    from . import conformance

    data_dir = Path(args.data_dir)
    header = data_dir / "port_channel_estimator_test_data.h"
    if not header.exists():
        print(f"error: {header} not found (srsRAN vectors are not shipped; "
              f"run `selftest` for the hermetic synthetic suite)", file=sys.stderr)
        return 2
    if args.debug_case is not None:
        # Failure forensics (reference DEBUG_CASES + complex-gain alignment)
        from ..utils import vectors as _vec

        cases = {c.idx: c for c in _vec.parse_test_header(header)}
        if args.debug_case not in cases:
            print(f"error: case {args.debug_case} not in header", file=sys.stderr)
            return 2
        rep = conformance.debug_case(cases[args.debug_case], data_dir)
        print(f"case {rep['idx']}: {rep['n_layers']} layer(s), {rep['n_rx']} RX port(s), "
              f"{rep['n_re']} DMRS REs x {rep['n_dsym']} DMRS symbols, "
              f"{rep['n_ref_coords']} reference coordinates")
        for h, d in enumerate(rep["dmrs_coords"]):
            print(f"  hop {h}: dmrs symbols {d['dmrs_symbols']} "
                  f"band start sc {d['sc_band_start']} ({d['n_dmrs_sc']} DMRS subcarriers)")
        for c in rep["candidates"][: args.debug_top]:
            dm = "-" if c["dmrs_rms"] is None else f"{c['dmrs_rms']:.3e}"
            print(f"  [{c['ordering']:>20s}] rms {c['rms']:.3e} nmse {c['nmse']:.3e} "
                  f"dmrs-rms {dm} | best gain {c['gain_abs']:.4f} @ "
                  f"{c['gain_deg']:+.1f} deg -> nmse {c['nmse_after_gain']:.3e}")
        if args.report:
            Path(args.report).write_text(json.dumps(rep, indent=2))
        return 0
    report = conformance.run_suite(
        header, data_dir, nmse_bound_db=args.nmse_bound_db, case_filter=args.case or None
    )
    for r in report["results"]:
        status = "PASS" if r["passed"] else "FAIL"
        print(
            f"case {r['idx']:3d} [{status}] max {r['max_err']:.3e} rms {r['rms_err']:.3e} "
            f"nmse {r['nmse']:.3e} ordering {r['ordering']}" + (f" ({r['message']})" if r.get("message") else "")
        )
    print(f"\n{report['n_pass']}/{report['n_cases']} cases within {args.nmse_bound_db} dB NMSE; "
          f"worst case {report['worst_case']} rms {report['worst_rms']}")
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2))
    return 0 if report["n_pass"] == report["n_cases"] else 1


def cmd_selftest(args) -> int:
    """Hermetic conformance: synthesize an srsRAN-format suite from the float64
    oracle, then replay it through the full vector pipeline. With --deep, run
    the three fuzzers (geometry-vs-oracle, coded chain, header parser) at depth
    and write the auditable JSON report (DEEPFUZZ_REPORT.json by default)."""
    import tempfile

    if getattr(args, "deep", False):
        return _selftest_deep(args)

    from . import conformance, synth_vectors

    specs = [
        dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3),
        dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3),
        dict(n_prbs=12, n_layers=1, comb=2, scs_hz=30e3, two_hops=True),
        dict(n_prbs=24, n_layers=1, comb=4, scs_hz=30e3, smoothing="mean"),
        dict(n_prbs=16, n_layers=4, comb=2, scs_hz=30e3),
        dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, cfo_compensate=False, smoothing="none"),
        dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, n_rx_ports=2),
        dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3, pilot_source="dmrs"),
        dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, prb_hole=(10, 14)),
        dict(n_prbs=16, n_layers=1, comb=2, scs_hz=30e3, pilot_source="srs", smoothing="wiener"),
        # DM-RS configuration type 2 (adjacent-pair clusters, 4 REs/PRB/CDM group)
        dict(n_prbs=24, n_layers=4, comb=2, scs_hz=30e3, pilot_source="dmrs", dmrs_type=2),
        # 5-PRB SRS: the closed-form M_ZC=30 short sequence (TS 38.211 §5.2.2.2)
        dict(n_prbs=5, n_layers=2, comb=2, scs_hz=30e3, pilot_source="srs"),
    ]
    with tempfile.TemporaryDirectory() as td:
        header = synth_vectors.generate_suite(td, specs)
        report = conformance.run_suite(header, td, nmse_bound_db=args.nmse_bound_db)
    for r in report["results"]:
        status = "PASS" if r["passed"] else "FAIL"
        print(f"case {r['idx']:3d} [{status}] rms {r['rms_err']:.3e} nmse {r['nmse']:.3e} "
              f"ordering {r['ordering']}")
    ok = report["n_pass"] == report["n_cases"]
    print(f"selftest: {report['n_pass']}/{report['n_cases']} within {args.nmse_bound_db} dB")
    return 0 if ok else 1


def _selftest_deep(args) -> int:
    """`selftest --deep`: the recorded deep-fuzz sweep (validation/deepfuzz.py).

    Runs on the CPU platform in float64 (the geometry fuzzer's 1e-18 oracle
    bound is an x64 property) — both flags are flipped BEFORE first backend
    use, the one window where jax_platforms can still be changed."""
    import os
    import time

    # the SP sweep needs the virtual multi-device CPU platform; XLA_FLAGS is
    # read at backend init, which has not happened yet on this code path
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass  # backend already initialized; trust the caller's platform
    jax.config.update("jax_enable_x64", True)

    from . import deepfuzz

    t0 = time.time()
    progress = lambda msg: print(f"  [{time.time()-t0:6.1f}s] {msg}", flush=True)
    print(
        f"deep fuzz: geometry n={args.geometry_n}, coded n={args.coded_n}, "
        f"header n={args.header_n}, sp n={args.sp_n} "
        f"(backend={jax.default_backend()}, x64, {len(jax.devices())} devices)",
        flush=True,
    )
    report = deepfuzz.run_all(
        n_geometry=args.geometry_n, n_coded=args.coded_n, n_header=args.header_n,
        n_sp=args.sp_n, progress=progress,
    )
    for k in ("geometry", "coded", "header", "sp"):
        r = report[k]
        print(f"{k}: {r['n_pass']}/{r['n_cases']} pass ({r['elapsed_s']:.1f}s)")
    g = report["geometry"]
    print(f"geometry NMSE: max {g['nmse_max']:.2e}, median {g['nmse_median']:.2e}, "
          f"histogram(log10) {g['nmse_log10_histogram']}")
    out = Path(args.report or "DEEPFUZZ_REPORT.json")
    out.write_text(json.dumps(report, indent=2, default=str))
    print(f"report written to {out}")
    print("deep selftest:", "ALL PASS" if report["all_pass"] else "FAILURES (see report)")
    return 0 if report["all_pass"] else 1


def cmd_diagnose(args) -> int:
    """JAX-native equivalent of the reference's Dynamo capture probe (#24,
    diagnose_furiosa_backend.py): verify the estimator traces to ONE XLA program and
    report its op statistics. Graph breaks structurally cannot occur — everything
    data-dependent is staticized at plan time — so this prints the proof."""
    import collections

    import jax
    import numpy as np

    from ..models import estimator
    from ..utils import synthetic

    case = synthetic.make_case(seed=8, n_prbs=int(args.n_prbs), n_layers=int(args.n_layers))
    nL = case.pilots.shape[2]
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, nL, batched=False)
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    lowered = fn.lower(rg, pil, np.float32(1.0))
    hlo = lowered.as_text()
    ops = collections.Counter()
    for line in hlo.splitlines():
        line = line.strip()
        if "=" in line and not line.startswith(("//", "module", "func", "}")):
            rhs = line.split("=", 1)[1].strip()
            op = rhs.split(" ", 1)[0].split("(")[0]
            if op.startswith(("stablehlo.", "mhlo.", "chlo.")) or "." not in op:
                ops[op] += 1
    print("graph_count: 1 (whole estimator traces to a single XLA program)")
    print("graph_break_count: 0 (static plan: no data-dependent Python control flow)")
    print(f"op_count: {sum(ops.values())}")
    for op, n in ops.most_common(15):
        print(f"  {op:35s} {n}")
    compiled = lowered.compile()
    print("compile: OK ->", type(compiled).__name__)
    print("offload verdict: fully offloadable — single fused program, no host fallbacks")
    return 0


def cmd_train(args) -> int:
    """Train the pilot denoiser on streamed synthetic channels and checkpoint it."""
    from ..models import training

    is_2d = args.model == "2d"
    load = training.load_checkpoint_2d if is_2d else training.load_checkpoint
    train = training.train2d if is_2d else training.train
    state = None
    if args.resume:
        state = load(args.resume, n_re=args.n_re, lr=args.lr)
        print(f"resumed from {args.resume} at step {state.step}")
    state, loss = train(
        n_steps=args.steps, batch=args.batch, n_re=args.n_re, lr=args.lr, state=state
    )
    print(f"final nmse {loss:.4e} after {state.step} total steps")
    if args.checkpoint:
        training.save_checkpoint(args.checkpoint, state)
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


def cmd_quality(args) -> int:
    """Channel-NMSE-vs-ground-truth sweep across SNR and smoothing strategies.

    Trains the denoiser briefly (or loads --checkpoint) so the table demonstrates
    the learned smoother against the reference's fixed RC-filter chain."""
    from . import quality
    from ..models import training

    ckpt = args.checkpoint
    if ckpt is None:
        shipped = Path(__file__).resolve().parents[1] / "artifacts" / "denoiser_ckpt.npz"
        if shipped.exists():
            ckpt = str(shipped)
    if ckpt:
        state = training.load_checkpoint(ckpt, n_re=args.n_re)
        print(f"loaded denoiser checkpoint {ckpt} (step {state.step})")
    else:
        print(f"training denoiser for {args.steps} steps ...")
        state, loss = training.train(n_steps=args.steps, batch=128, n_re=args.n_re, lr=2e-3)
        print(f"train nmse {loss:.4e}")

    snrs = tuple(float(s) for s in args.snr)
    table = quality.sweep(
        snrs_db=snrs,
        smoothings=("filter", "wiener", "learned", "mean", "none"),
        params=state.params,
        n_cases=args.cases,
        n_prbs=args.n_prbs,
        n_layers=1,
    )
    hdr = "smoothing " + "".join(f"  {s:>6.1f}dB" for s in snrs)
    print(hdr + "\n" + "-" * len(hdr))
    for sm, row in table.items():
        tag = {"filter": " (reference chain)", "learned": " (trainable, ours)", "wiener": " (MMSE, ours)"}.get(sm, "")
        print(f"{sm:9s} " + "".join(f"  {row[s]:7.2f}" for s in snrs) + tag)
    gain = {s: table["filter"][s] - table["learned"][s] for s in snrs}
    print("learned-vs-filter gain (dB): " + ", ".join(f"{s:.0f}dB SNR: {g:+.2f}" for s, g in gain.items()))

    gtable = quality.geometry_sweep(state.params, snr_db=0.0, n_cases=min(4, args.cases))
    print("\nGeometry generalization (one conv checkpoint, 0 dB SNR, NMSE dB):")
    print("n_prbs   n_re   learned   filter    gain")
    for p, row in gtable.items():
        print(
            f"{p:6d} {row['n_re']:6d} {row['learned_db']:9.2f} {row['filter_db']:8.2f} "
            f"{row['gain_db']:+7.2f}" + ("" if row["learned_wins"] else "  (filter wins)")
        )

    params2d = None
    shipped2d = Path(__file__).resolve().parents[1] / "artifacts" / "denoiser2d_ckpt.npz"
    if shipped2d.exists():
        state2d = training.load_checkpoint_2d(str(shipped2d), n_re=args.n_re)
        params2d = state2d.params
        print(f"\nloaded 2-D denoiser checkpoint {shipped2d} (step {state2d.step})")
    dops = (0.0, 100.0, 300.0, 600.0)
    tags = {
        "none": " (reference broadcast)",
        "linear": " (time interp, ours)",
        "learned2d": " (2-D DL denoiser, ours)",
    }
    dtables = {}
    for dsnr in (30.0, 5.0):
        dtable = quality.doppler_sweep(
            dopplers_hz=dops, snr_db=dsnr, n_cases=args.cases, n_prbs=args.n_prbs,
            params2d=params2d,
        )
        dtables[dsnr] = dtable
        hdr = "time strategy         " + "".join(f"  {d:>5.0f}Hz" for d in dops)
        print(f"\nDoppler tracking (NMSE dB vs truth, {dsnr:.0f} dB SNR):\n"
              + hdr + "\n" + "-" * len(hdr))
        for ti, row in dtable.items():
            print(f"time_interp={ti:9s} " + "".join(f"  {row[d]:7.2f}" for d in dops) + tags.get(ti, ""))
    dtable = {f"{snr:.0f}dB": t for snr, t in dtables.items()}
    ctable = quality.cfo_rmse_sweep(n_cases=max(8, args.cases), n_prbs=args.n_prbs)
    csnrs = sorted(next(iter(ctable.values())).keys())
    hdr = "cfo estimator        " + "".join(f"  {s:>5.0f}dB" for s in csnrs)
    print("\nCFO RMS error (Hz, 4 DM-RS symbols):\n" + hdr + "\n" + "-" * len(hdr))
    for mode, row in ctable.items():
        tag = " (reference)" if mode == "first_pair" else " (WLS, ours)"
        print(f"cfo={mode:12s} " + "".join(f"  {row[s]:7.2f}" for s in csnrs) + tag)
    ttable = quality.tracking_sweep(n_slots=8, n_cases=min(6, args.cases))
    print("\nMulti-slot tracking (static channel, 0 dB SNR, NMSE dB vs truth):")
    print(f"  single slot (reference): {ttable['single_slot_db']:7.2f}")
    print(f"  tracked, 8 slots (ours): {ttable['tracked_8slots_db']:7.2f}")
    atable = quality.delay_adapt_sweep(n_cases=min(6, args.cases), n_prbs=args.n_prbs)
    print("\nAuto-matched MMSE prior (serving wiener_auto_delay, 10 dB SNR, NMSE dB):")
    print("channel class    fixed 250ns    auto-matched")
    for label, row in atable.items():
        print(f"{label:15s} {row['fixed_db']:11.2f} {row['auto_db']:15.2f}")
    bsnrs = (5.0, 10.0, 15.0, 20.0, 30.0)
    btable = quality.ber_sweep(
        snrs_db=bsnrs, modulation="16qam", n_rx=2, n_layers=2,
        n_cases=min(4, args.cases),
    )
    print("\nLink-level uncoded BER (2x2 MIMO 16QAM, full chain: estimate ->")
    print("joint MMSE -> soft demap -> descramble; vs perfect-CSI MMSE bound):")
    print("      SNR " + "".join(f"  {s:>7.0f}dB" for s in bsnrs))
    print("estimated " + "".join(f"  {btable[s]['ber']:9.2e}" for s in bsnrs))
    print("perfectCSI" + "".join(f"  {btable[s]['ber_perfect_csi']:9.2e}" for s in bsnrs))
    ksnrs = (12.0, 14.0, 16.0, 20.0)
    ktable = quality.coded_ber_sweep(snrs_db=ksnrs, n_cases=min(2, args.cases))
    print("\nCoded link (rate-0.63 QC-LDPC n=976, batched min-sum, interleaved")
    print("over the same 2x2 16QAM chain; payload BER / block error rate):")
    print("      SNR " + "".join(f"  {s:>7.0f}dB" for s in ksnrs))
    print("uncoded   " + "".join(f"  {ktable[s]['uncoded_ber']:9.2e}" for s in ksnrs))
    print("coded BER " + "".join(f"  {ktable[s]['coded_ber']:9.2e}" for s in ksnrs))
    print("BLER      " + "".join(f"  {ktable[s]['coded_bler']:9.2e}" for s in ksnrs))
    if args.report:
        Path(args.report).write_text(
            json.dumps(
                {"snr": table, "geometry": gtable, "doppler": dtable, "cfo": ctable,
                 "tracking": ttable, "delay_adapt": atable, "link_ber": btable,
                 "coded_link": ktable},
                indent=2,
            )
        )
    return 0


def cmd_bench(args) -> int:
    """Run the throughput benchmark (same as `python bench.py`)."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location("bench", root / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="srsran-ce", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate", help="replay srsRAN conformance vectors")
    v.add_argument("--data-dir", default="testvector_outputs")
    v.add_argument("--nmse-bound-db", type=float, default=-40.0)
    v.add_argument("--case", type=int, action="append", help="restrict to case index (repeatable)")
    v.add_argument("--report", help="write JSON report to this path")
    v.add_argument("--debug-case", type=int, default=None,
                   help="failure forensics for ONE case: DMRS coordinates, per-"
                        "ordering DMRS-level error, best-fit complex-gain alignment")
    v.add_argument("--debug-top", type=int, default=6,
                   help="show this many best candidates in --debug-case output")
    v.set_defaults(fn=cmd_validate)

    s = sub.add_parser("selftest", help="hermetic synthetic-vector conformance")
    s.add_argument("--nmse-bound-db", type=float, default=-40.0)
    s.add_argument("--deep", action="store_true",
                   help="run the three fuzzers at depth (geometry-vs-oracle, "
                        "coded chain, header parser) and write an auditable "
                        "JSON report; forces the CPU x64 platform")
    s.add_argument("--geometry-n", type=int, default=100)
    s.add_argument("--coded-n", type=int, default=30)
    s.add_argument("--header-n", type=int, default=120)
    s.add_argument("--sp-n", type=int, default=30,
                   help="randomized shard_map-seam geometries (8 virtual devices)")
    s.add_argument("--report", default=None,
                   help="deep-report path (default DEEPFUZZ_REPORT.json)")
    s.set_defaults(fn=cmd_selftest)

    d = sub.add_parser("diagnose", help="graph-capture / offload diagnostic")
    d.add_argument("--n-prbs", default=52)
    d.add_argument("--n-layers", default=2)
    d.set_defaults(fn=cmd_diagnose)

    t = sub.add_parser("train", help="train the pilot denoiser (smoothing='learned'/'learned2d')")
    t.add_argument("--model", choices=("1d", "2d"), default="1d",
                   help="1d = frequency denoiser; 2d = time x frequency (Doppler)")
    t.add_argument("--steps", type=int, default=500)
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--n-re", type=int, default=128)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--checkpoint", help="checkpoint output file (.npz)")
    t.add_argument("--resume", help="checkpoint file (.npz) to resume from")
    t.set_defaults(fn=cmd_train)

    q = sub.add_parser("quality", help="channel NMSE vs ground truth across SNR / smoothing")
    q.add_argument("--steps", type=int, default=300, help="denoiser training steps")
    q.add_argument("--checkpoint", default=None, help="load denoiser checkpoint instead of training")
    q.add_argument("--n-re", type=int, default=104)
    q.add_argument("--n-prbs", type=int, default=26)
    q.add_argument("--cases", type=int, default=12)
    q.add_argument("--snr", nargs="*", default=[0.0, 5.0, 10.0, 20.0])
    q.add_argument("--report", default=None, help="write JSON table here")
    q.set_defaults(fn=cmd_quality)

    b = sub.add_parser("bench", help="single-GPU throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
