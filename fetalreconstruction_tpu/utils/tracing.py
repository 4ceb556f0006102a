"""Profiling / tracing / numerical-guard utilities.

Analog of the reference's observability (SURVEY.md §5): PerfStats
covers phase wall-clock; this module adds device traces (jax.profiler,
viewable in TensorBoard/XProf), device-memory telemetry (the reference's
checkGPUMemory), and NaN guards (the reference has none — atomics + exit()
was its whole error story).
"""
from __future__ import annotations

import contextlib
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace around a code block:

        with tracing.trace("/tmp/trace"):
            run_svr(cfg)
    """
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (jax.profiler.TraceAnnotation)."""
    import jax
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats(device=None) -> dict:
    """Device memory telemetry (the reference's checkGPUMemory,
    reconstruction_cuda2.cu:72-87)."""
    import jax
    d = device or jax.devices()[0]
    stats = getattr(d, "memory_stats", lambda: None)()
    return stats or {}


def check_finite(tree, name: str = "state") -> None:
    """Raise if any array in the pytree contains NaN/Inf (host-side guard;
    call between pipeline phases under --debug)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    leaves = jax.tree_util.tree_leaves(tree)
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite values")
