"""Test configuration: a virtual 8-device CPU platform with float64 enabled.

Tests validate the production JAX path bit-tight against the float64 numpy oracle
(complex128 end to end), and sharding tests use the 8 virtual CPU devices as a
stand-in mesh. The platform is pinned here, before first backend use, so the
tests run on the CPU whatever accelerator the machine has; tests that need a
GPU are marked `gpu` and run their work in a child process (tests/test_chip_smoke.py).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
