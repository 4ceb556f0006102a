"""Benchmark: SVR EM/SR inner-iteration throughput on one device.

Prints ONE JSON line {"metric", "value", "unit", "platform",
"device_kind", "device_count", ...} naming the device it ran on.

Workload: canonical-shaped synthetic problem (4 stacks -> ~168 slices of
144x144 at 1.25 mm in-plane / 5 mm thick, reconstructed at 1.0 mm on a
160^3 grid) — the same shape class as the reference's bundled 4-stack 3T
run.  One "iteration" = the full inner SR/EM step the reference times as
Superresolution + SimulateSlices + MStep + EStep (reconstruction.cc:
1013-1110).  The reference publishes no benchmark numbers, so the line
carries no comparison against a baseline.
"""
import json
import os
import sys
import time

import numpy as np


def build_problem(n_stacks=4, stack_slices=42, hw=144, vol=160,
                  recon_dx=1.0, in_plane=1.25, thickness=5.0,
                  max_support=12):
    import jax.numpy as jnp
    from fetalreconstruction_tpu.core.geometry import (ImageAttributes,
                                                       rigid_matrix)
    from fetalreconstruction_tpu.ops import psf as psf_ops
    from fetalreconstruction_tpu.pipeline import svr_core

    rng = np.random.default_rng(0)
    recon_attr = ImageAttributes(x=vol, y=vol, z=vol, dx=recon_dx,
                                 dy=recon_dx, dz=recon_dx)
    n = n_stacks * stack_slices
    i2w = np.zeros((n, 4, 4))
    dims = np.tile([[in_plane, in_plane, thickness]], (n, 1))
    rots = [[0, 0, 0, 0, 0, 0], [0, 0, 0, 90, 0, 0], [0, 0, 0, 0, 90, 0],
            [0, 0, 0, 45, 45, 0]]
    k = 0
    for s in range(n_stacks):
        t = rigid_matrix(rots[s % len(rots)])
        for j in range(stack_slices):
            a = ImageAttributes(x=hw, y=hw, z=1, dx=in_plane, dy=in_plane,
                                dz=thickness)
            a.zorigin = (j - stack_slices / 2) * thickness / 2.0
            i2w[k] = t @ a.i2w()
            k += 1
    offsets = psf_ops.make_offsets(
        psf_ops.reference_support(dims, recon_dx, 1.0, max_support))
    from fetalreconstruction_tpu.ops.psf_fast import FastPSF
    support = psf_ops.reference_support(dims, recon_dx, 1.0, max_support)
    ranges = [(s * stack_slices, (s + 1) * stack_slices)
              for s in range(n_stacks)]
    a3s = [np.linalg.inv((recon_attr.w2i() @ i2w[r[0]])[:3, :3])
           for r in ranges]
    fast = FastPSF(np.asarray(a3s), dims[[r[0] for r in ranges]], ranges,
                   support)
    ctx = svr_core.SVRContext(
        vol_shape=recon_attr.shape_zyx,
        vol_spacing=(recon_dx,) * 3,
        offsets=offsets, slice_spacing_xy=(in_plane, in_plane),
        disable_bias=True,
        fast=None if os.environ.get("BENCH_ENGINE") == "exact" else fast)
    slices = jnp.asarray(
        rng.uniform(100, 700, (n, hw, hw)).astype(np.float32))
    valid = jnp.ones((n, hw, hw), bool)
    transforms = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1))
    mask_flat = jnp.ones(vol ** 3, jnp.float32)
    geom, sume = svr_core.build_geometry(
        ctx, jnp.asarray(recon_attr.w2i(), jnp.float32), transforms,
        jnp.asarray(i2w, jnp.float32), jnp.asarray(dims, jnp.float32),
        valid, mask_flat)
    return ctx, dict(slices=slices, valid=valid, geom=geom, sume=sume,
                     mask_flat=mask_flat, n=n, i2w=i2w, dims=dims,
                     recon_w2i=recon_attr.w2i())


def main():
    import jax
    from fetalreconstruction_tpu.utils.compile_cache import \
        configure_compile_cache
    configure_compile_cache()
    import jax.numpy as jnp
    from fetalreconstruction_tpu.pipeline import svr_core

    size = os.environ.get("BENCH_SIZE", "full")
    if size == "small":
        ctx, p = build_problem(n_stacks=2, stack_slices=12, hw=64, vol=64)
    else:
        ctx, p = build_problem()

    em = svr_core.init_em_state(p["n"], p["valid"])
    recon, wts, _ = svr_core.gaussian_reconstruction(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em.bias,
        em.scale, p["mask_flat"])
    sim = svr_core.simulate(ctx, p["geom"], p["sume"], recon,
                            p["mask_flat"])
    excluded = jnp.zeros((p["n"],), bool)
    em = svr_core.initialize_robust_statistics(
        ctx, p["slices"], p["valid"], sim, em, 700.0, 100.0, excluded)

    vol_shape = tuple(ctx.vol_shape)
    mask = p["mask_flat"].reshape(vol_shape)

    # One inner SR/EM iteration = scale -> SR scatter+regularize ->
    # simulate -> M-step -> E-step.  svr_core.inner_iteration takes EVERY
    # array as a jit ARGUMENT (em/sim/recon donated) — nothing is baked
    # into the program as a constant.
    def one_iteration(em, sim, recon):
        return svr_core.inner_iteration(
            ctx, p["geom"], p["sume"], p["slices"], p["valid"], em, sim,
            recon, wts, mask, p["mask_flat"], excluded, 1.0, 450.0,
            100.0, 700.0, 2, do_bias=False, do_scale=True,
            do_normalise_bias=False)

    # warmup/compile
    em, sim, recon = jax.block_until_ready(one_iteration(em, sim, recon))

    iters = int(os.environ.get("BENCH_ITERS", "3"))
    t0 = time.perf_counter()
    for _ in range(iters):
        em, sim, recon = one_iteration(em, sim, recon)
    jax.block_until_ready(recon)
    dt = (time.perf_counter() - t0) / iters

    dev = jax.devices()
    row = {
        "metric": "svr_em_sr_inner_iterations_per_s",
        "value": 1.0 / dt,
        "unit": "iterations/s",
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
    }
    # END-TO-END canonical pipeline (BENCH_E2E=0 skips): the inner
    # iteration is ~10% of real wall — registration is the dominant
    # stage — so the driver-recorded bench must regress if registration
    # regresses.  Extra keys on the SAME line; `value` stays the
    # inner-iteration metric for round-over-round continuity.
    if os.environ.get("BENCH_E2E", "1") != "0" and size != "small":
        row.update(run_e2e())
    print(json.dumps(row))


def run_e2e():
    """Full-pipeline wall-clock at the canonical shape (the
    tools/bench_full problem: 4 motion-corrupted stacks, 3 outer
    iterations, ~160^3 @ 1 mm): the headline numbers only; the per-phase
    table comes from tools/bench_full.py."""
    import time as _time
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    from bench_full import build_problem
    from fetalreconstruction_tpu.pipeline.config import SVRConfig
    from fetalreconstruction_tpu.pipeline.svr import run_svr

    gt, mask, stacks = build_problem()
    cfg = SVRConfig(iterations=3, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    no_log=True)
    t0 = _time.perf_counter()
    res = run_svr(cfg, stacks=stacks, mask=mask)
    total = _time.perf_counter() - t0
    reg = res.stats._samples.get("registration", [])
    n_slices = len(res.slice_weights)
    out = {"e2e_minutes": total / 60.0, "e2e_iterations": 3,
           "e2e_n_slices": n_slices}
    if reg:
        out["slices_per_s"] = n_slices * len(reg) / max(sum(reg), 1e-9)
        out["registration_s_per_round"] = sum(reg) / len(reg)
    return out


if __name__ == "__main__":
    main()
