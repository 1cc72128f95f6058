"""Data-parallel batched estimation: shard the problem axis over the mesh.

Estimation problems are independent, so DP is pure SPMD with zero collectives: jit
with NamedShardings on the leading batch axis and XLA partitions everything. This is
the scale-out path for the "4096 concurrent (cell, UE, port) estimations" benchmark
config (BASELINE.json configs[4]); per-chip work stays identical so scaling
efficiency is bounded only by dispatch overheads.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EstimatorConfig, HopConfig
from ..models import estimator as _est
from ..models.plan import make_plan


def build_dp_batched(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    mesh: Mesh,
    axis: str = "dp",
    out_layout: str = "ref",
):
    """Jitted ri-layout batched estimator with the batch axis sharded over `axis`.

    fn(rg_ri[B,2,n_sc,n_sym], pil_ri[B,2,n_re,n_dsym,L], beta[B]) -> EstimateResult
    with every output sharded on its leading batch axis. B must be divisible by the
    mesh axis size. out_layout as in estimator.build_ri ("serve" = subcarrier-last
    (layer, sym, sc) channel grid — the fast production layout). With a learned
    smoothing mode ("learned"/"learned2d") the returned fn takes the denoiser
    params pytree as a trailing replicated (non-batched) argument.
    """
    if hop2 is not None and hop2.is_empty:
        hop2 = None
    plan = make_plan(hop1, hop2, config, n_layers)
    _est.prefetch_plan_constants(plan)

    batch = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    if out_layout == "factored":
        out_shardings = _est.FactoredResult(
            profiles=batch,
            sym_rot=batch,
            noise_est=batch,
            rsrp=batch,
            epre=batch,
            time_alignment=batch,
            cfo_hz=batch,
        )
    else:
        out_shardings = _est.EstimateResult(
            channel_est_rg=batch,
            noise_est=batch,
            rsrp=batch,
            epre=batch,
            time_alignment=batch,
            cfo_hz=batch,
        )

    def single(rg_ri, pil_ri, beta, params=None):
        res = _est._estimate_impl(
            plan, _est._ri_to_complex(rg_ri), _est._ri_to_complex(pil_ri), beta,
            params, out_layout
        )
        return _est.result_to_ri(res)

    if config.smoothing in ("learned", "learned2d"):
        fn = jax.jit(
            jax.vmap(single, in_axes=(0, 0, 0, None)),
            in_shardings=(batch, batch, batch, repl),
            out_shardings=out_shardings,
        )
    else:
        fn = jax.jit(
            jax.vmap(lambda r, p, b: single(r, p, b)),
            in_shardings=(batch, batch, batch),
            out_shardings=out_shardings,
        )
    return fn


def build_dp_receiver(
    hop1: HopConfig,
    hop2: Optional[HopConfig],
    config: EstimatorConfig,
    n_layers: int,
    mesh: Mesh,
    axis: str = "dp",
    mode: str = "auto",
    data_beta: float = 1.0,
    modulation=None,
    llr_scale: float = 8.0,
):
    """Batch-sharded joint multi-RX receiver (models/receiver) — DP scale-out of
    the fused estimate+equalize program, zero collectives (problems independent).

    fn(rg_ri[B,2,n_rx,n_sc,n_sym], pil_ri[B,2,n_re,n_dsym,L], beta[B][, params])
    -> ReceiverResult with every output batch-sharded. mode/data_beta as in
    receiver.build_receiver_ri ("auto" picks the exact factored per-subcarrier
    filter when time_interp="none"). `modulation` fuses the int8 soft demapper
    (an LlrResult comes back, like receiver.build_receiver_ri).
    """
    from ..models import receiver as _rcv

    if hop2 is not None and hop2.is_empty:
        hop2 = None
    assert mode in ("auto", "dense", "factored")
    if mode == "factored" and config.time_interp != "none":
        raise ValueError("mode='factored' requires time_interp='none'")
    plan = make_plan(hop1, hop2, config, n_layers)
    _est.prefetch_plan_constants(plan)
    factored = mode == "factored" or (mode == "auto" and config.time_interp == "none")

    batch = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    meas = dict(noise_est=batch, rsrp=batch, epre=batch,
                time_alignment=batch, cfo_hz=batch)
    if modulation is None:
        out_shardings = _rcv.ReceiverResult(x=batch, sinr=batch, **meas)
    else:
        from ..ops import demap as _demap

        nbits = _demap.bits_per_symbol(modulation)
        out_shardings = _rcv.LlrResult(llr=(batch,) * nbits, sinr=batch, **meas)

    def single(rg_ri, pil_ri, beta, params=None):
        return _rcv.receiver_impl(
            plan, rg_ri, pil_ri, beta, factored, data_beta, params,
            modulation, llr_scale,
        )

    if config.smoothing in ("learned", "learned2d"):
        return jax.jit(
            jax.vmap(single, in_axes=(0, 0, 0, None)),
            in_shardings=(batch, batch, batch, repl),
            out_shardings=out_shardings,
        )
    return jax.jit(
        jax.vmap(lambda r, p, b: single(r, p, b)),
        in_shardings=(batch, batch, batch),
        out_shardings=out_shardings,
    )


def build_dp_decoder(
    code,
    mesh: Mesh,
    n_iters: int = 20,
    norm: float = 0.75,
    kernels: str = "auto",
    axis: str = "dp",
):
    """Batch-sharded QC-LDPC decode (ops/ldpc): codewords are independent, so
    DP is pure SPMD with zero collectives — each device min-sum-decodes its
    local slice of the word batch (any decoder tier, via shard_map so a
    kernel's custom call partitions trivially).

    fn(llr[B, n]) -> DecodeResult with every output sharded on the leading
    word axis. B must be divisible by the mesh axis size. This is how the
    served int8 LLR streams (serving.process(out="llrs")) scale out: the
    receiver dp-shards the problem axis, the decoder dp-shards the codeword
    axis of the reassembled streams.
    """
    from jax import shard_map

    from ..ops import ldpc as _ldpc

    dec = _ldpc.build_decoder(code, n_iters=n_iters, norm=norm, kernels=kernels)
    spec = P(axis)
    out_specs = _ldpc.DecodeResult(bits=spec, info=spec, ok=spec, posterior=spec)
    return jax.jit(
        shard_map(dec, mesh=mesh, in_specs=(spec,), out_specs=out_specs)
    )
