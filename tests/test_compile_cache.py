"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (nothing
else set in code), else one fixed directory inside the checkout."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE = (
    "import jax, srsran_ce; "
    "print(srsran_ce.compile_cache_dir()); "
    "print(jax.config.jax_compilation_cache_dir); "
    "print(jax.config.jax_persistent_cache_min_entry_size_bytes)"
)


def _probe(**env_extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split()
    return out[0], out[1], int(out[2])


def test_cache_defaults_to_a_fixed_directory_in_the_checkout():
    import srsran_ce

    used, configured, min_size = _probe()
    assert used == configured == srsran_ce.CACHE_DIR == str(ROOT / ".jax_cache")
    assert min_size == -1  # cache every entry, however small


def test_cache_follows_the_environment_variable(tmp_path):
    used, configured, min_size = _probe(JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert used == configured == str(tmp_path)  # JAX reads the variable itself
    assert min_size == 0  # JAX's own default: nothing else is set in code
