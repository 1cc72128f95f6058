"""Smoke test of the served receiver chain on one NVIDIA GPU.

Drives `serving.process` — channel estimates, equalized symbols, int8 LLRs and
decoded transport blocks — at full width, compares every result with the
repository's own references (the float64 oracle, `ldpc.decode_reference`, the
CPU), and prints one JSON line last:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (any failure exits non-zero): device, estimation (c2: 106 PRB, 4
layers, batch 128, per precision name), receiver (4 RX x 4 layers 256QAM
LLRs; a 2x2 QPSK link symbol-exact), decoded chain (273 PRB, NR BG1 Z=384
layered, host and device decode paths), decoder choice (the Triton layered
kernel against the plain-XLA walk at the benchmark's codes), learned
smoothing (against the same program on the CPU).

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # only the multi-device paths, on four GPUs

One process drives the card(s); no child process touches JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np


def log(*a):
    print(*a, flush=True)


def nmse(a, ref) -> float:
    a = np.asarray(a, np.complex128)
    return float(np.sum(np.abs(a - ref) ** 2) / (np.sum(np.abs(ref) ** 2) + 1e-30))


def timed(fn, n: int):
    """(median, max) host seconds of n warm calls, each ended by
    block_until_ready."""
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.max(ts))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(n_expected: int):
    import jax

    import srsran_ce
    from srsran_ce.native import loader

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {d0.platform!r}")
    if len(devs) < n_expected:
        raise RuntimeError(f"need {n_expected} GPUs, JAX sees {len(devs)}")
    log(f"device: {d0.platform} {d0.device_kind} x{len(devs)}")
    log(f"compile cache: {srsran_ce.compile_cache_dir()}")
    try:
        loader._get_lib()
        native = "yes"
    except (OSError, subprocess.CalledProcessError) as e:
        native = f"no ({type(e).__name__}: {e})"
    log(f"native packer loaded: {native}")
    return devs


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _c2_problems(n_distinct: int, n_prbs: int):
    from srsran_ce import serving
    from srsran_ce.utils import synthetic

    cases = [
        synthetic.make_case(seed=100 + i, n_prbs=n_prbs, n_layers=4, comb=2, scs_hz=30e3)
        for i in range(n_distinct)
    ]
    probs = [
        serving.Problem(
            c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
            np.float32(c.beta), c.hop1, c.hop2, c.config,
        )
        for c in cases
    ]
    return cases, probs


def phase_estimation(batch: int = 128, n_prbs: int = 106, n_warm: int = 20):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from srsran_ce import serving
    from srsran_ce.models import estimator
    from srsran_ce.utils import oracle

    n_distinct = min(4, batch)
    cases, probs = _c2_problems(n_distinct, n_prbs)
    refs = [
        oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        for c in cases
    ]
    problems = [probs[i % n_distinct] for i in range(batch)]
    default = serving.process.__defaults__[1]  # matmul_precision default
    results = {}
    c = cases[0]
    rg = np.broadcast_to(estimator.split_ri(c.received_rg.astype(np.complex64)),
                         (batch, 2) + c.received_rg.shape)
    pil = np.broadcast_to(estimator.split_ri(c.pilots.astype(np.complex64)),
                          (batch, 2) + c.pilots.shape)
    beta = jnp.ones((batch,), jnp.float32)
    for name in ("default", "high", "highest"):
        t0 = time.perf_counter()
        out = serving.process(problems, batch_size=batch, matmul_precision=name)
        dt = time.perf_counter() - t0
        serve = max(
            nmse(out[i].channel_est_rg, refs[i].channel_est_rg) for i in range(n_distinct)
        )
        cfg = dataclasses.replace(cases[0].config, matmul_precision=name)
        ref_res = estimator.estimate(
            cases[0].received_rg.astype(np.complex64), cases[0].pilots.astype(np.complex64),
            np.float32(cases[0].beta), cases[0].hop1, cases[0].hop2, cfg,
        )
        ref_nmse = nmse(ref_res.channel_est_rg, refs[0].channel_est_rg)
        results[name] = (serve, ref_nmse)
        fn = estimator.build_ri(c.hop1, c.hop2, cfg, 4, batched=True, out_layout="serve")
        med, mx = timed(lambda: fn(rg, pil, beta), n_warm)
        log(f"  c2 precision={name:8s} serve NMSE {serve:.3e}  reference-path NMSE "
            f"{ref_nmse:.3e}  (first call {dt:.1f} s); serve step batch {batch} median "
            f"{med*1e3:.3f} ms, max {mx*1e3:.3f} ms ({n_warm} warm calls)")
    serve, ref_nmse = results[default]
    log(f"  serving default precision: {default!r}")
    if not serve < 4e-11:
        raise AssertionError(f"c2 serve NMSE {serve:.3e} >= 4e-11 at {default!r}")
    if not ref_nmse < 1e-12:
        raise AssertionError(f"c2 reference NMSE {ref_nmse:.3e} >= 1e-12 at {default!r}")

    # memory of the serve step as compiled, at the serving default
    cfg = dataclasses.replace(c.config, matmul_precision=default)
    fn = estimator.build_ri(c.hop1, c.hop2, cfg, 4, batched=True, out_layout="serve")
    log(f"  serve step memory_analysis: {fn.lower(rg, pil, beta).compile().memory_analysis()}")


def phase_receiver(n_prbs: int = 106):
    import jax
    import jax.numpy as jnp

    from srsran_ce import serving
    from srsran_ce.ops import demap
    from srsran_ce.utils import synthetic

    # 4 RX x 4 layers, 256QAM int8 LLRs at the c2 width
    case = synthetic.make_mimo_case(
        seed=31, n_rx=4, modulation="256qam", scramble=False, n_prbs=n_prbs, n_layers=4,
        snr_db=45.0, cfo_hz=200.0,
    )
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        np.float32(case.beta), case.hop1, case.hop2, case.config,
    )
    res = serving.process([prob] * 8, batch_size=8, out="llrs", modulation="256qam")
    eq = serving.process([prob], batch_size=8, out="equalized")[0]
    llr = res[0].llr
    nbits = demap.bits_per_symbol("256qam")
    if llr.shape != case.bits.shape or llr.dtype != np.int8:
        raise AssertionError(f"LLR grid {llr.shape} {llr.dtype}, want {case.bits.shape} int8")
    if not all(np.array_equal(r.llr, llr) for r in res[1:]):
        raise AssertionError("identical problems in one batch gave different LLRs")
    # reference: the host-side demapper, on the CPU, applied to the equalized
    # symbols and SINR of the same receiver; one int8 step of slack for
    # round() at quantization boundaries
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(demap.llrs(jnp.asarray(eq.x), jnp.asarray(eq.sinr), "256qam"))
    ref_q = np.clip(np.round(ref * res[0].llr_scale), -127, 127)
    alloc = np.broadcast_to(np.any(llr != 0, axis=(2, 3))[:, :, None, None], llr.shape)
    step = float(np.abs(llr.astype(np.float64) - ref_q)[alloc].max())
    m = np.broadcast_to(case.data_mask[:, :, None, None], case.bits.shape)
    ber = float(np.mean((llr < 0)[m] != case.bits[m].astype(bool)))
    log(f"  4x4 256QAM LLRs: shape {llr.shape}, {nbits} bits/RE, max |LLR - host demap| "
        f"{step:.0f} int8 steps, hard-decision BER {ber:.2e}")
    if not (step <= 1 and np.isfinite(eq.x).all() and ber < 0.2):
        raise AssertionError("4x4 256QAM LLRs disagree with the host demapper")

    # 2x2 QPSK at 40 dB: symbol-exact equalized symbols
    case2 = synthetic.make_mimo_case(
        seed=7, n_rx=2, modulation="qpsk", scramble=False, n_prbs=24, n_layers=2,
        snr_db=40.0, cfo_hz=300.0,
    )
    prob2 = serving.Problem(
        case2.received_rg.astype(np.complex64), case2.pilots.astype(np.complex64),
        np.float32(case2.beta), case2.hop1, case2.hop2, case2.config,
    )
    eq = serving.process([prob2], batch_size=1, out="equalized")[0]
    x = eq.x[case2.data_mask]
    sent = case2.payload[case2.data_mask]
    good = eq.sinr[case2.data_mask] > 100.0
    dec = np.sign(x.real) + 1j * np.sign(x.imag)
    ref = np.sign(sent.real) + 1j * np.sign(sent.imag)
    ser = float(np.mean(dec != ref))
    log(f"  2x2 QPSK equalized: SER {ser:.2e}, exact where SINR > 20 dB: "
        f"{np.array_equal(dec[good], ref[good])} ({good.mean():.0%} of symbols)")
    if not (ser < 5e-3 and good.mean() > 0.7 and np.array_equal(dec[good], ref[good])):
        raise AssertionError("2x2 QPSK link not symbol-exact")


def _decoded_case(n_slots: int, n_prbs: int, bg: int, z: int):
    from srsran_ce import serving, transport
    from srsran_ce.ops import demap, ldpc, nr_ldpc
    from srsran_ce.utils import synthetic

    code = nr_ldpc.nr_base_graph(bg, z)
    plan = ldpc.make_ldpc_plan(code)
    coding = transport.TransportCoding(
        code=code, rate_match="nr", tx_bits=2 * plan.k, schedule="layered",
        n_iters=16, crc="crc24b", interleave_seed=7,
        stream_c2v_dtype="bfloat16",
    )
    nbits = demap.bits_per_symbol("qpsk")
    seed = 4242
    geo = synthetic.make_case(seed=seed, snr_db=15.0, n_prbs=n_prbs, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    rng = np.random.default_rng(seed)
    probs, payloads = [], []
    for s in range(n_slots):
        u = rng.integers(0, 2, (lay.c_words, transport.payload_bits(coding, plan.k)),
                         dtype=np.uint8)
        words = transport.crc_attach(u, "crc24b")
        if coding.n_filler:
            words = np.concatenate(
                [words, np.zeros((lay.c_words, coding.n_filler), np.uint8)], axis=1)
        bits = transport.place_codewords(lay, ldpc.encode(code, words), 1, nbits, fill_rng=rng)
        case = synthetic.make_mimo_case(
            seed=seed + s, n_rx=1, modulation="qpsk", scramble=False, bits=bits,
            n_prbs=n_prbs, n_layers=1, snr_db=15.0,
        )
        probs.append(serving.Problem(
            case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
            np.float32(case.beta), case.hop1, case.hop2, case.config,
        ))
        payloads.append(u)
    return coding, lay, probs, payloads


def phase_decoded(n_slots: int = 4, n_prbs: int = 273, bg: int = 1, z: int = 384,
                  n_warm: int = 5):
    from srsran_ce import serving

    coding, lay, probs, payloads = _decoded_case(n_slots, n_prbs, bg, z)
    log(f"  {n_prbs} PRB QPSK, NR BG{bg} Z={z} layered-16 bf16 messages, CRC24B: "
        f"{lay.c_words} words/slot x {n_slots} slots")
    for on_device in (False, True):
        run = lambda: serving.process(
            probs, batch_size=n_slots, out="decoded", modulation="qpsk", coding=coding,
            decode_on_device=on_device,
        )
        t0 = time.perf_counter()
        res = run()
        first = time.perf_counter() - t0
        bad = [
            s for s, (r, u) in enumerate(zip(res, payloads))
            if not (bool(np.all(r.ok)) and np.array_equal(r.info, u))
        ]
        ts = []
        for _ in range(n_warm):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        log(f"  decode_on_device={on_device}: payload-exact slots "
            f"{n_slots - len(bad)}/{n_slots}; first call {first:.1f} s, warm median "
            f"{np.median(ts)*1e3:.1f} ms, max {np.max(ts)*1e3:.1f} ms per {n_slots} slots")
        if bad:
            raise AssertionError(f"decoded chain not payload-exact in slots {bad}")


def code_cases():
    """The benchmark's codes: (label, code, batch, flooding sweeps)."""
    from srsran_ce.ops import ldpc, nr_ldpc

    return (
        ("array(8,16,61)", ldpc.array_code(8, 16, 61), 512, 25),
        ("NR BG2 Z=208", nr_ldpc.nr_base_graph(2, 208), 128, 16),
        ("NR BG1 Z=52", nr_ldpc.nr_base_graph(1, 52), 128, 16),
        ("NR BG1 Z=384", nr_ldpc.nr_base_graph(1, 384), 32, 16),
    )


def _llrs(code, batch, seed=0, snr_db=3.5):
    from srsran_ce.ops import ldpc

    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    snr = 10.0 ** (snr_db / 10)
    llr = 4 * snr * ((1 - 2.0 * cw) + rng.normal(0, np.sqrt(0.5 / snr), cw.shape))
    return u, llr.astype(np.float32)


def phase_decoders(cases=None, tiers=("xla", "triton"), n_warm: int = 10):
    import jax
    import jax.numpy as jnp

    from srsran_ce.ops import ldpc

    summary = []
    for label, code, batch, iters in cases or code_cases():
        u, llr = _llrs(code, batch)
        llr_d = jnp.asarray(llr)
        lay_iters = iters // 2
        n_ref = min(batch, 8)
        # flooding vs the float64 reference
        rb, _, rpost = ldpc.decode_reference(code, llr[:n_ref], n_iters=iters)
        auto_f = ldpc.select_tier("auto", "flooding", jax.default_backend())
        for tier in ("xla",):
            dec_f = ldpc.build_decoder(code, n_iters=iters, kernels=tier)
            t0 = time.perf_counter()
            res_f = jax.block_until_ready(dec_f(llr_d))
            compile_s = time.perf_counter() - t0
            med, mx = timed(lambda: dec_f(llr_d), n_warm)
            post = np.asarray(res_f.posterior[:n_ref], np.float64)
            err_f = np.abs(post - rpost).max() / np.abs(rpost).max()
            bits_f = np.array_equal(np.asarray(res_f.bits[:n_ref]), rb)
            log(f"  {label} batch {batch} flooding-{iters} [{tier}{'*' if tier == auto_f else ''}]"
                f": bits == reference {bits_f}, posterior rel err {err_f:.1e}; "
                f"compile {compile_s:.1f} s; warm median "
                f"{med*1e3:.3f} ms, max {mx*1e3:.3f} ms")
            if not (bits_f and err_f < 1e-4):
                raise AssertionError(f"{label}: flooding {tier} disagrees with decode_reference")
        rb, rok, rpost = ldpc.decode_reference(
            code, llr[:n_ref], n_iters=lay_iters, schedule="layered")
        times = {}
        for tier in tiers:
            dec = ldpc.build_decoder(code, n_iters=lay_iters, kernels=tier, schedule="layered")
            t0 = time.perf_counter()
            res = jax.block_until_ready(dec(llr_d))
            compile_s = time.perf_counter() - t0
            med, mx = timed(lambda: dec(llr_d), n_warm)
            post = np.asarray(res.posterior[:n_ref], np.float64)
            err = np.abs(post - rpost).max() / np.abs(rpost).max()
            bits = np.array_equal(np.asarray(res.bits[:n_ref]), rb)
            exact = bool(np.asarray(res.ok).all()) and np.array_equal(np.asarray(res.info), u)
            times[tier] = med
            log(f"  {label} batch {batch} layered-{lay_iters} [{tier}]: bits == reference "
                f"{bits}, posterior rel err {err:.1e}, payload-exact {exact}; compile "
                f"{compile_s:.1f} s; warm median {med*1e3:.3f} ms, max {mx*1e3:.3f} ms "
                f"({n_warm} calls)")
            if not (bits and err < 1e-4):
                raise AssertionError(f"{label}: layered {tier} disagrees with decode_reference")
        if "triton" in tiers:  # row groups: fewer barriers, slower convergence
            dec = ldpc.build_decoder(code, n_iters=lay_iters, kernels="triton",
                                     schedule="layered", layered_group=2)
            res = dec(llr_d)
            med, _ = timed(lambda: dec(llr_d), n_warm)
            exact = bool(np.asarray(res.ok).all()) and np.array_equal(np.asarray(res.info), u)
            log(f"  {label} layered-{lay_iters} [triton, layered_group=2]: payload-exact "
                f"{exact}, words ok {int(np.asarray(res.ok).sum())}/{batch}; warm median "
                f"{med*1e3:.3f} ms")
        auto = ldpc.layered_tier(jax.default_backend())
        faster = min(times, key=times.get)
        summary.append((label, times, faster, auto))
        ratio = "".join(
            f", {times['xla'] / times[t]:.2f}x xla/{t}" for t in times if t != "xla")
        log(f"  {label}: kernels='auto' picks {auto!r} for layered; faster here: "
            f"{faster!r}{ratio}")
    return summary


def phase_learned(n_prbs: int = 52, batch: int = 16):
    import jax

    from srsran_ce import serving
    from srsran_ce.models import estimator, training
    from srsran_ce.utils import synthetic

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "srsran_ce",
                        "artifacts", "denoiser2d_ckpt.npz")
    params = training.load_checkpoint_2d(path).params
    case = synthetic.make_case(seed=12, n_prbs=n_prbs, n_layers=2, smoothing="learned2d",
                               time_interp="linear", snr_db=10.0, doppler_hz=300.0)
    prob = serving.Problem(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        np.float32(case.beta), case.hop1, case.hop2, case.config,
    )
    dev = serving.process([prob] * batch, batch_size=batch, params=params)[0].channel_est_rg
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, 2)
    cpu = jax.devices("cpu")[0]
    args = (estimator.split_ri(case.received_rg.astype(np.complex64)),
            estimator.split_ri(case.pilots.astype(np.complex64)), np.float32(case.beta))
    with jax.default_device(cpu):
        p_cpu = jax.device_put(params, cpu)
        ref = fn(*[jax.device_put(a, cpu) for a in args], p_cpu)
        ref = estimator.merge_ri(np.asarray(ref.channel_est_rg))
    err = nmse(dev, ref)
    tol = 1e-10  # float32 on both sides, HIGHEST convolutions: rounding only
    log(f"  learned2d {n_prbs} PRB: device vs CPU NMSE {err:.2e} (tolerance {tol:.0e})")
    if not err < tol:
        raise AssertionError(f"learned2d GPU/CPU NMSE {err:.2e} >= {tol:.0e}")


def phase_four(devs, n_prbs: int = 106, per_dev: int = 128, n_prbs_sp: int = 273,
               z: int = 384, n_words: int = 32, n_warm: int = 10):
    """The paths across devices, each against one device."""
    import jax

    from srsran_ce.models import denoiser, estimator, training
    from srsran_ce.parallel import mesh as mesh_lib
    from srsran_ce.parallel.data_parallel import build_dp_batched, build_dp_decoder
    from srsran_ce.parallel.subcarrier import build_sp_batched
    from srsran_ce.utils import synthetic

    devs = devs[:4]
    mesh_dp = mesh_lib.make_mesh((4,), ("dp",), devices=devs)

    # dp estimation at c2, batch 4 x 128, against one device
    c = synthetic.make_case(seed=101, n_prbs=n_prbs, n_layers=4, comb=2, scs_hz=30e3)
    rg = estimator.split_ri(c.received_rg.astype(np.complex64))
    pil = estimator.split_ri(c.pilots.astype(np.complex64))
    B = 4 * per_dev
    rng = np.random.default_rng(0)
    rg_b = (rg[None] * (1 + 0.01 * rng.standard_normal((B, 1, 1, 1)))).astype(np.float32)
    pil_b = np.broadcast_to(pil, (B,) + pil.shape).copy()
    beta = np.ones(B, np.float32)
    fn_dp = build_dp_batched(c.hop1, c.hop2, c.config, 4, mesh_dp, out_layout="serve")
    out = fn_dp(rg_b, pil_b, beta)
    fn_1 = estimator.build_ri(c.hop1, c.hop2, c.config, 4, batched=True, out_layout="serve")
    one = fn_1(rg_b, pil_b, beta)
    e = nmse(np.asarray(out.channel_est_rg), np.asarray(one.channel_est_rg, np.float64))
    log(f"  dp estimation c2 batch {B} on 4 devices vs 1: NMSE {e:.2e}, sharded over "
        f"{len(out.channel_est_rg.sharding.device_set)} devices")
    if not (e < 1e-12 and len(out.channel_est_rg.sharding.device_set) == 4):
        raise AssertionError("dp estimation differs from one device")
    med, mx = timed(lambda: fn_dp(rg_b, pil_b, beta).channel_est_rg, n_warm)
    med1, mx1 = timed(lambda: fn_1(rg_b, pil_b, beta).channel_est_rg, n_warm)
    log(f"    4 devices median {med*1e3:.3f} ms (max {mx*1e3:.3f}); 1 device median "
        f"{med1*1e3:.3f} ms (max {mx1*1e3:.3f})")

    # sp estimation at 273 PRB against the unsharded path
    c3 = synthetic.make_case(seed=5, n_prbs=n_prbs_sp, n_layers=2, comb=2, scs_hz=30e3)
    mesh_sp = mesh_lib.make_mesh((1, 4), ("dp", "sp"), devices=devs)
    rg3 = estimator.split_ri(c3.received_rg.astype(np.complex64))[None].repeat(2, 0)
    pil3 = estimator.split_ri(c3.pilots.astype(np.complex64))[None].repeat(2, 0)
    b3 = np.ones(2, np.float32)
    out3 = build_sp_batched(c3.hop1, c3.hop2, c3.config, 2, mesh_sp)(rg3, pil3, b3)
    ref3 = estimator.build_ri(c3.hop1, c3.hop2, c3.config, 2, batched=True)(rg3, pil3, b3)
    e3 = nmse(np.asarray(out3.channel_est_rg), np.asarray(ref3.channel_est_rg, np.float64))
    log(f"  sp estimation {n_prbs_sp} PRB over 4 devices vs unsharded: NMSE {e3:.2e}")
    if not e3 < 1e-10:
        raise AssertionError("sp estimation differs from the unsharded path")

    # dp decode at NR BG1 Z=384, payload-exact
    from srsran_ce.ops import ldpc, nr_ldpc

    code = nr_ldpc.nr_base_graph(1, z)
    u, llr = _llrs(code, n_words, seed=3, snr_db=4.0)
    dres = build_dp_decoder(code, mesh_dp, n_iters=20)(llr)
    exact = bool(np.asarray(dres.ok).all()) and np.array_equal(np.asarray(dres.info), u)
    same = np.array_equal(np.asarray(dres.bits),
                          np.asarray(ldpc.build_decoder(code, n_iters=20, kernels="auto")(llr).bits))
    log(f"  dp decode NR BG1 Z={z} x{n_words} on 4 devices: payload-exact {exact}, "
        f"bits == one device {same}")
    if not (exact and same):
        raise AssertionError("dp decode not payload-exact")

    # one dp train step vs one device
    state, tx = training.init_state(seed=0, n_re=128)
    noisy, truth = denoiser.make_training_batch(np.random.default_rng(1), 256, 128)
    _, _, l4 = training.build_train_step(tx, mesh_lib.make_mesh((4, 1), ("dp", "sp"),
                                                                 devices=devs))(
        state.params, state.opt_state, noisy, truth)
    _, _, l1 = training.build_train_step(tx)(state.params, state.opt_state, noisy, truth)
    rel = abs(float(l4) - float(l1)) / abs(float(l1))
    tol = 1e-5  # float32 loss, the batch sum reassociated across 4 devices
    log(f"  dp train step on 4 devices: loss {float(l4):.6f} vs {float(l1):.6f} on one "
        f"(rel {rel:.1e}, tolerance {tol:.0e})")
    if not rel < tol:
        raise AssertionError("dp train step loss differs from one device")
    jax.block_until_ready(l4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args(argv)

    n_dev = 4 if args.four else 1
    try:
        devs = phase_device(n_dev)
    except Exception as e:  # no accelerator, or the program is missing
        log(f"FAIL device: {type(e).__name__}: {e}")
        return 1
    if args.four:
        phases = [("multi-device", lambda: phase_four(devs))]
    else:
        phases = [
            ("estimation", phase_estimation),
            ("receiver", phase_receiver),
            ("decoded chain", phase_decoded),
            ("decoder choice", phase_decoders),
            ("learned smoothing", phase_learned),
        ]
    failed = []
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
            log(f"   {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception as e:
            traceback.print_exc(file=sys.stdout)
            log(f"FAIL {name}: {type(e).__name__}: {e}")
            failed.append(name)
    log(gpu_name_and_limit())
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
