"""Device-mesh helpers for one host with several GPUs (or several hosts).

The reference has no distribution at all (SURVEY.md §2: no torch.distributed, no
collectives); the mesh axes here implement the scale-out design:

  dp — data parallel over (cell, UE, antenna-port, slot) estimation problems
  sp — sequence(subcarrier) parallel over the frequency axis of one wideband problem,
       with overlap-save halo exchange of RC-filter edge taps

The GPUs of one host are joined all to all (NVLink), so the mesh shape follows
the algorithm alone: choose (n_dp, n_sp) from the traffic, not from a topology.
XLA hands the collectives to NCCL.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "sp"),
    devices=None,
) -> Mesh:
    """Create a mesh over the available devices.

    Default: all devices on axis 'dp' (sp=1). Pass shape=(n_dp, n_sp) to split.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    assert int(np.prod(shape)) == n, f"mesh shape {shape} != {n} devices"
    # Auto axis types: classic sharding propagation (zeros/intermediates created
    # inside jit pick up shardings from consumers instead of demanding explicit
    # out_sharding annotations on every scatter/creation op).
    axis_types = (jax.sharding.AxisType.Auto,) * len(axis_names)
    return jax.make_mesh(shape, tuple(axis_names), devices=devices, axis_types=axis_types)


def multihost_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed for multi-host pods; returns True if a
    multi-process runtime is (now) active.

    The reference framework has no multi-host story; this is the JAX-native
    equivalent of what would otherwise be an MPI/NCCL bootstrap. With no
    arguments, cluster auto-detection is attempted (JAX_COORDINATOR_ADDRESS
    et al.); explicit arguments configure a manual
    rendezvous (see tests/test_multiprocess.py for a live 2-process example).

    Must be called BEFORE any operation that touches the XLA backend —
    including jax.devices()/jax.process_count() — or JAX will already have
    started a single-process runtime (this is why the idempotence guard below
    inspects the distributed client directly rather than calling
    jax.process_count()).
    """
    try:
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return jax.process_count() > 1  # already initialized
    except Exception:  # pragma: no cover - private-API drift
        pass
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return jax.process_count() > 1
    except Exception:
        # No cluster configuration found (CPU tests, one-chip bench) —
        # single-process operation.
        return False


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding for (B, ...) problem batches: leading axis split over `axis`."""
    return NamedSharding(mesh, P(axis))


# ---------------------------------------------------------------------------
# Failure detection (SURVEY.md §5): coarse fail-fast for long-running jobs.
# An inference pipeline needs no elastic-training semantics — just a cheap way
# to notice that a chip/host stopped responding and abort the job promptly.
# ---------------------------------------------------------------------------


def all_device_barrier(devices=None, timeout_s: float = 300.0) -> float:
    """One cross-device sum touching EVERY device; returns elapsed seconds.

    Each device contributes its ordinal+1, so the reduced value verifies that all
    devices actually participated (a wedged device hangs the collective instead —
    call under the heartbeat's timeout to convert that into a detected failure).
    """
    import time

    devs = list(devices or jax.devices())
    n = len(devs)
    t0 = time.time()
    if n == 1:
        jax.block_until_ready(jax.device_put(np.ones((), np.float32), devs[0]) + 0.0)
        return time.time() - t0
    mesh = make_mesh((n,), ("all",), devices=devs)
    x = jax.device_put(
        np.arange(1, n + 1, dtype=np.float32), NamedSharding(mesh, P("all"))
    )
    s = jax.jit(jax.numpy.sum, out_shardings=NamedSharding(mesh, P()))(x)
    got = float(jax.block_until_ready(s))
    want = n * (n + 1) / 2
    if got != want:
        raise RuntimeError(f"device barrier mismatch: sum {got} != {want}")
    return time.time() - t0


class Heartbeat:
    """Background watchdog: runs `all_device_barrier` every `interval_s`; if a
    round raises or exceeds `timeout_s`, records the failure and invokes
    `on_failure` (default: log loudly). `healthy` flips False on first failure.

    Usage:
        hb = Heartbeat(interval_s=30).start()
        ... long bench / serving loop, checking hb.healthy ...
        hb.stop()
    """

    def __init__(self, interval_s: float = 30.0, timeout_s: float = 120.0, on_failure=None):
        import threading

        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.on_failure = on_failure
        self.healthy = True
        self.last_latency_s: Optional[float] = None
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _fail(self, msg: str) -> None:
        self.healthy = False
        self.error = msg
        if self.on_failure is not None:
            self.on_failure(msg)
        else:  # pragma: no cover - side-effect logging
            import sys

            print(f"[heartbeat] DEVICE FAILURE: {msg}", file=sys.stderr, flush=True)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                dt = all_device_barrier(timeout_s=self.timeout_s)
                self.last_latency_s = dt
                if dt > self.timeout_s:
                    self._fail(f"barrier took {dt:.1f}s (> {self.timeout_s}s)")
                    return
            except Exception as e:  # noqa: BLE001 - any device error is a failure
                self._fail(f"{type(e).__name__}: {e}")
                return

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
