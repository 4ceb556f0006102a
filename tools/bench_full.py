"""Full-pipeline SVR wall-clock: per-phase table + registration
throughput on the canonical phantom.

Canonical-shaped synthetic problem (the same class as the reference's
bundled 4-stack 3T run): textured ellipsoid ground truth on a ~160^3
1 mm grid, 4 stacks of 144x144 slices at 1.25 mm in-plane / 5 mm thick
(~40 slices each) with per-slice rigid motion, reconstructed at 1 mm.

Measures with FETALRECON_SYNC_STATS=1 so the PerfStats table attributes
device time to the stage that spent it, and reports:
  - the run_svr per-phase table (the reference's performance_GPU_<date>
    analog, reconstruction.cc:1278-1296)
  - slices-registered/s over the slice-to-volume registration stage
    (registerMultipleSlicesToVolume, reconstruction_cuda2.cu:4001-4147)
  - end-to-end minutes and PSNR against the ground truth

build_problem and psnr_vs_ground_truth are shared with bench.py,
tools/bench_pvr.py and chip_smoke.py.  Run:
  python tools/bench_full.py [--iterations 3]
"""
import argparse
import os
import sys
import time

os.environ.setdefault("FETALRECON_SYNC_STATS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_problem(n_stacks=4, hw=144, in_plane=1.25, thickness=5.0,
                  motion_t=1.5, motion_r=1.5, seed=0):
    """Ground-truth volume + motion-corrupted thick-slice stacks."""
    from fetalreconstruction_tpu.core.geometry import (ImageAttributes,
                                                       rigid_matrix)
    from fetalreconstruction_tpu.core.image import Image
    from fetalreconstruction_tpu.ops.sampling import resample_to_grid
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    # ground truth: textured ellipsoid on a 1 mm grid covering the FOV
    gn, gd = 168, 1.0
    ga = ImageAttributes(x=gn, y=gn, z=gn, dx=gd, dy=gd, dz=gd)
    lin = np.linspace(-1, 1, gn)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xx ** 2 + 1.15 * yy ** 2 + 1.25 * zz ** 2)
    tex = (360.0 + 140.0 * np.cos(9 * np.pi * r)
           + 90.0 * np.sin(7 * xx + 11 * yy - 9 * zz)
           + 70.0 * np.sin(13 * xx * yy + 8 * zz))
    vol = np.where(r < 0.82, np.maximum(tex, 1.0), 0.0).astype(np.float32)
    gt = Image(vol, ga)
    mask = Image((r < 0.86).astype(np.float32), ga.copy())

    def _np_trilinear(v, pts):
        """numpy trilinear sample of [z,y,x] volume at (..., 3) (x,y,z)."""
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        zs, ys, xs = v.shape
        u, w, q = np.floor(x).astype(int), np.floor(y).astype(int), \
            np.floor(z).astype(int)
        du, dv, dw = x - u, y - w, z - q
        out = np.zeros(x.shape, np.float32)
        for cw in (0, 1):
            for cv in (0, 1):
                for cu in (0, 1):
                    xi, yi, zi = u + cu, w + cv, q + cw
                    inb = ((xi >= 0) & (xi < xs) & (yi >= 0) & (yi < ys)
                           & (zi >= 0) & (zi < zs))
                    val = np.where(
                        inb, v[np.clip(zi, 0, zs - 1),
                               np.clip(yi, 0, ys - 1),
                               np.clip(xi, 0, xs - 1)], 0.0)
                    wgt = ((du if cu else 1 - du) * (dv if cv else 1 - dv)
                           * (dw if cw else 1 - dw))
                    out += (wgt * val).astype(np.float32)
        return out

    stack_rots = [[0, 0, 0], [90, 0, 0], [0, 90, 0], [45, 45, 0]]
    n_sl = int(round(gn * gd / (thickness / 2))) // 2  # ~2x coverage
    stacks = []
    for s in range(n_stacks):
        srot = rigid_matrix([0, 0, 0] + stack_rots[s % len(stack_rots)])
        a = ImageAttributes(x=hw, y=hw, z=n_sl, dx=in_plane, dy=in_plane,
                            dz=thickness)
        data = np.zeros((n_sl, hw, hw), np.float32)
        px = np.arange(hw, dtype=np.float32)
        for j in range(n_sl):
            # per-slice rigid motion on every other slice (the unmoved
            # half anchors the initial template — motion on ALL slices
            # has no bootstrap anchor and no registration of this family
            # recovers it; see tools/README.md round-4 findings)
            if j % 2:
                mot = np.eye(4)
            else:
                mot = rigid_matrix(
                    list(rng.uniform(-motion_t, motion_t, 3))
                    + list(rng.uniform(-motion_r, motion_r, 3)))
            sa = a.region(0, 0, j, hw, hw, j + 1)
            # sample gt at the slice raster mapped through motion @ srot
            fwd = np.asarray(ga.w2i() @ mot @ srot @ sa.i2w(), np.float64)
            gy, gx = np.meshgrid(px, px, indexing="ij")
            pts = (fwd[:3, 0][None, None] * gx[..., None]
                   + fwd[:3, 1][None, None] * gy[..., None]
                   + fwd[:3, 3][None, None])
            data[j] = _np_trilinear(vol, pts)
        aa = a.copy()
        st = Image(data, aa)
        # stack world placement: srot is the stack-to-world transform;
        # bake it into the i2w so initial stack transforms are identity
        st.attr = _compose_attr(aa, srot)
        stacks.append(st)
    return gt, mask, stacks


def _compose_attr(attr, t):
    """Return attributes whose i2w equals t @ attr.i2w() (exactly
    representable for rigid t: rotate the axes, move the origin)."""
    a = attr.copy()
    m = np.asarray(t, np.float64)
    r = m[:3, :3]
    a.xaxis = list(r @ np.asarray(attr.xaxis, np.float64))
    a.yaxis = list(r @ np.asarray(attr.yaxis, np.float64))
    a.zaxis = list(r @ np.asarray(attr.zaxis, np.float64))
    o = r @ np.asarray([attr.xorigin, attr.yorigin, attr.zorigin],
                       np.float64) + m[:3, 3]
    a.xorigin, a.yorigin, a.zorigin = map(float, o)
    return a


def psnr_vs_ground_truth(gt, out) -> float:
    """PSNR (dB) of reconstruction `out` against ground truth `gt`, both
    Images, over the voxels where the resampled ground truth is > 1."""
    from fetalreconstruction_tpu.ops.sampling import resample_to_grid
    import jax.numpy as jnp
    gt_on_out = np.asarray(resample_to_grid(
        jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i(), jnp.float32),
        out.attr.shape_zyx, jnp.asarray(out.attr.i2w(), jnp.float32),
        interp="linear", padding=0.0))
    m = gt_on_out > 1.0
    diff = (np.asarray(out.data) - gt_on_out)[m]
    return float(10 * np.log10(gt_on_out[m].max() ** 2
                               / np.mean(diff ** 2)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--rec-iterations", type=int, default=4)
    ap.add_argument("--resolution", type=float, default=1.0)
    ap.add_argument("--mesh", type=int, default=0)
    args = ap.parse_args()

    import jax
    from fetalreconstruction_tpu.utils.compile_cache import \
        configure_compile_cache
    configure_compile_cache()
    print(f"backend: {jax.default_backend()}")

    t0 = time.perf_counter()
    gt, mask, stacks = build_problem()
    print(f"problem built in {time.perf_counter() - t0:.1f}s: "
          f"{len(stacks)} stacks of {stacks[0].data.shape}")

    from fetalreconstruction_tpu.pipeline.config import SVRConfig
    from fetalreconstruction_tpu.pipeline.svr import run_svr

    cfg = SVRConfig(iterations=args.iterations,
                    resolution=args.resolution,
                    rec_iterations_first=args.rec_iterations,
                    rec_iterations_last=args.rec_iterations,
                    no_log=True)
    mesh = None
    if args.mesh:
        from fetalreconstruction_tpu.parallel import sharded
        mesh = sharded.make_mesh(jax.devices()[:args.mesh])

    t0 = time.perf_counter()
    res = run_svr(cfg, stacks=stacks, mask=mask, mesh=mesh)
    total = time.perf_counter() - t0
    print()
    print(res.stats.table())
    print()
    reg = res.stats._samples.get("registration", [])
    n_slices = len(res.slice_weights)
    if reg:
        reg_total = sum(reg)
        print(f"slice-to-volume registration: {n_slices} slices x "
              f"{len(reg)} rounds in {reg_total:.1f}s = "
              f"{n_slices * len(reg) / reg_total:.1f} slices/s")
    print(f"END-TO-END: {total:.1f}s ({total / 60:.2f} min) for "
          f"{args.iterations} outer iterations, {n_slices} slices")
    psnr = psnr_vs_ground_truth(gt, res.reconstructed)
    print(f"PSNR vs ground truth (masked): {psnr:.2f} dB")


if __name__ == "__main__":
    main()
