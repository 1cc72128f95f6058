"""Live multi-process (multi-"host") distributed test.

Everything else in tests/ simulates a pod slice with 8 virtual devices in ONE
process; this test actually spawns TWO JAX processes (4 virtual CPU devices
each), rendezvouses them through `parallel.mesh.multihost_initialize`, and runs

  * the all-device barrier (one cross-PROCESS collective touching all 8
    devices — the failure-detection primitive), and
  * a dp-sharded batched estimation over a global mesh where each process
    contributes its process-local problems (`jax.make_array_from_process_local_data`)
    and checks its local results against the float64 oracle.

This is the closest a single machine gets to the real N-host deployment: the
coordination service, cross-process collectives, and process-local data paths
are all the genuine ones (only the transport is loopback instead of DCN).
"""
import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["CE_REPO"])
import jax
from srsran_ce.parallel import mesh as mesh_lib

pid = int(os.environ["CE_PROC_ID"])
ok = mesh_lib.multihost_initialize(
    coordinator_address=os.environ["CE_COORD"], num_processes=2, process_id=pid
)
assert ok, "multihost_initialize did not produce a multi-process runtime"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

# 1) failure-detection barrier: one collective over all 8 devices, both processes
dt = mesh_lib.all_device_barrier()
print(f"proc {pid}: barrier ok in {dt:.3f}s", flush=True)

# 2) dp-sharded estimation with process-local data
import numpy as np
from srsran_ce.models import estimator
from srsran_ce.parallel.data_parallel import build_dp_batched
from srsran_ce.utils import oracle, synthetic

mesh = mesh_lib.make_mesh((8,), ("dp",))
sharding = mesh_lib.batch_sharding(mesh)

cases = [synthetic.make_case(seed=100 + 4 * pid + i, n_prbs=16, n_layers=1, snr_db=25.0)
         for i in range(4)]  # this process's local problems
c0 = cases[0]
rg_l = np.stack([estimator.split_ri(c.received_rg.astype(np.complex64)) for c in cases])
pil_l = np.stack([estimator.split_ri(c.pilots.astype(np.complex64)) for c in cases])
beta_l = np.ones(4, np.float32)

rg = jax.make_array_from_process_local_data(sharding, rg_l, (8,) + rg_l.shape[1:])
pil = jax.make_array_from_process_local_data(sharding, pil_l, (8,) + pil_l.shape[1:])
beta = jax.make_array_from_process_local_data(sharding, beta_l, (8,))

fn = build_dp_batched(c0.hop1, c0.hop2, c0.config, 1, mesh)
out = fn(rg, pil, beta)
ch = out.channel_est_rg  # global (8, 2, n_sc, 14, 1), dp-sharded

for shard in ch.addressable_shards:
    i_local = shard.index[0].start - 4 * pid
    c = cases[i_local]
    got = np.asarray(shard.data)[0]
    est = (got[0] + 1j * got[1]).astype(np.complex128)
    ref = oracle.estimate(c.received_rg, c.pilots, 1.0, c.hop1, c.hop2, c.config)
    nmse = np.sum(np.abs(est - ref.channel_est_rg) ** 2) / np.sum(np.abs(ref.channel_est_rg) ** 2)
    assert nmse < 1e-9, (pid, i_local, nmse)
print(f"proc {pid}: dp-sharded results match oracle", flush=True)
print(f"proc {pid}: MULTIPROC_OK", flush=True)
"""


_WORKER_SP = r"""
import os, sys
sys.path.insert(0, os.environ["CE_REPO"])
import jax
from srsran_ce.parallel import mesh as mesh_lib

pid = int(os.environ["CE_PROC_ID"])
ok = mesh_lib.multihost_initialize(
    coordinator_address=os.environ["CE_COORD"], num_processes=2, process_id=pid
)
assert ok and jax.process_count() == 2

import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from srsran_ce.models import estimator
from srsran_ce.parallel.subcarrier import build_sp_batched
from srsran_ce.utils import oracle, synthetic

# sp axis spans BOTH processes: the overlap-save halo ppermute between shard 3
# (this side of the boundary, process 0) and shard 4 (process 1) is a genuine
# cross-process edge-tap exchange — the north-star "halo over ICI" collective,
# here riding the loopback coordination transport.
mesh = mesh_lib.make_mesh((1, 8), ("dp", "sp"))
case = synthetic.make_case(seed=321, n_prbs=16, n_layers=1, snr_db=25.0)
rg = estimator.split_ri(case.received_rg.astype(np.complex64))[None]   # (1,2,n_sc,14)
pil = estimator.split_ri(case.pilots.astype(np.complex64))[None]
beta = np.ones(1, np.float32)

rg_sh = NamedSharding(mesh, P("dp", None, "sp", None))
repl = NamedSharding(mesh, P("dp"))
n_sc = rg.shape[2]
half = slice(pid * n_sc // 2, (pid + 1) * n_sc // 2)  # this process's 4 shards
rg_g = jax.make_array_from_process_local_data(rg_sh, rg[:, :, half, :], rg.shape)
pil_g = jax.make_array_from_process_local_data(repl, pil, pil.shape)
beta_g = jax.make_array_from_process_local_data(repl, beta, beta.shape)

fn = build_sp_batched(case.hop1, case.hop2, case.config, 1, mesh)
out = fn(rg_g, pil_g, beta_g)
ref = oracle.estimate(case.received_rg, case.pilots, 1.0, case.hop1, case.hop2, case.config)

err = den = 0.0
for shard in out.channel_est_rg.addressable_shards:
    sc = shard.index[2]
    got = np.asarray(shard.data)[0]
    est = (got[0] + 1j * got[1]).astype(np.complex128)
    tru = ref.channel_est_rg[sc]
    err += float(np.sum(np.abs(est - tru) ** 2))
    den += float(np.sum(np.abs(tru) ** 2))
assert err / den < 1e-9, (pid, err / den)
noise = float(np.asarray(out.noise_est.addressable_shards[0].data)[0])
assert abs(noise - ref.noise_est) < 1e-6 * max(ref.noise_est, 1e-12)
print(f"proc {pid}: sp halo-exchange across processes matches oracle", flush=True)
print(f"proc {pid}: MULTIPROC_OK", flush=True)
"""


def _spawn_pair(worker: str):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        "PATH": os.environ.get("PATH", ""),
        "HOME": os.environ.get("HOME", ""),
        "PYTHONPATH": "",
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "CE_REPO": repo,
        "CE_COORD": f"localhost:{port}",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker],
            env=dict(env, CE_PROC_ID=str(pid)),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "MULTIPROC_OK" in out, f"proc {pid} incomplete:\n{out}"


def test_two_process_sp_halo_exchange():
    """Subcarrier sharding with the sp axis spanning two processes: the RC-filter
    halo exchange crosses the process boundary and must still be oracle-exact."""
    _spawn_pair(_WORKER_SP)


def test_two_process_distributed_dp():
    """Distributed rendezvous, cross-process barrier, and dp-sharded estimation
    from process-local data."""
    _spawn_pair(_WORKER)
