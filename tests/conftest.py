"""Test configuration: an 8-device virtual CPU mesh by default.

The tests run on the CPU: JAX_PLATFORMS defaults to "cpu" here, and a
value set in the environment is kept.  XLA_FLAGS gains
--xla_force_host_platform_device_count=8 unless it already sets a count,
so the mesh tests see eight CPU devices.

The card-only tests carry the `gpu` marker; they run on a GPU with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

and skip, with a reason, where JAX finds no GPU.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from fetalreconstruction_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)

configure_compile_cache()


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} x {jax.devices()[0].platform}"
