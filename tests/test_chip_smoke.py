"""chip_smoke.py: refuses to run without a GPU, its phases' control flow at a
tiny size on the CPU, and the full smoke on a card (marked `gpu`)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(kw)
    return env


def test_exits_nonzero_on_cpu_and_names_the_platform():
    p = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=_env(JAX_PLATFORMS="cpu"),
    )
    assert p.returncode != 0
    assert "'cpu'" in p.stdout
    assert '"ok"' not in p.stdout  # no result line


def test_exits_nonzero_without_the_program(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=_env(JAX_PLATFORMS="cpu", PYTHONPATH=""),
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def _tiny_codes():
    from srsran_ce.ops import ldpc, nr_ldpc

    return (("NR BG2 Z=16", nr_ldpc.nr_base_graph(2, 16), 8, 8),
            ("array(3,8,13)", ldpc.array_code(3, 8, 13), 8, 8))


@pytest.mark.parametrize(
    "phase",
    [
        lambda: chip_smoke.phase_estimation(batch=4, n_prbs=12, n_warm=2),
        lambda: chip_smoke.phase_receiver(n_prbs=12),
        lambda: chip_smoke.phase_decoded(n_slots=2, n_prbs=24, bg=2, z=16, n_warm=1),
        lambda: chip_smoke.phase_decoders(cases=_tiny_codes(), tiers=("xla",), n_warm=2),
        lambda: chip_smoke.phase_learned(n_prbs=12, batch=2),
    ],
    ids=["estimation", "receiver", "decoded", "decoders", "learned"],
)
def test_phase_runs_at_tiny_size_on_cpu(phase):
    """Each phase's control flow and gates, at a size the CPU runs quickly
    (the chip run uses the full widths)."""
    phase()


@pytest.fixture
def gpu():
    """Skip unless this machine has an NVIDIA GPU (decided here, at run time)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke on the card, in its own process (one process drives
    the card; this test process stays on the CPU)."""
    p = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=1200, env=_env(),
    )
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
