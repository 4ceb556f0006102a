"""Orthogonal-stacks s2v diagnosis: oracle vs registration.

Round-4: the orthogonal-stacks variant of the acceptance scenario
measured no-reg 16.9 dB / reg 16.35 dB — registration HURT.  This diag
adds the true-transform oracle (slice mapping by full world-origin
distance — rotated stacks advance along world y/x, not z) to tell
whether the scenario has headroom at all, and per-slice transform error
stats to see whether registration moves toward or away from the truth.
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
import jax

jax.config.update("jax_platforms", "cpu")
from fetalreconstruction_tpu.utils.compile_cache import \
    configure_compile_cache  # noqa: E402

configure_compile_cache()

import jax.numpy as jnp
from phantom import make_ground_truth, simulate_stacks, psnr, \
    make_stack_attr
from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.ops.sampling import resample_to_grid
from fetalreconstruction_tpu.pipeline.config import SVRConfig
from fetalreconstruction_tpu.pipeline import svr as svr_mod


def main(orientations=((0, 0, 0), (90, 0, 0)), seed=3, t_amp=4.0,
         r_amp=5.0, every=2):
    gt = make_ground_truth(n=32, spacing=1.25)
    rng = np.random.default_rng(seed)
    in_plane, dz, noise = 1.5, 2.5, 0.25
    slice_motions = []
    for s in range(2):
        a = make_stack_attr(gt, orientations[s], in_plane, dz)
        m = np.zeros((a.z, 6))
        m[::every, :3] = rng.uniform(-t_amp, t_amp,
                                     (len(m[::every]), 3))
        m[::every, 3:] = rng.uniform(-r_amp, r_amp,
                                     (len(m[::every]), 3))
        slice_motions.append(m)
    print(f"orientations={orientations} t_amp={t_amp} r_amp={r_amp} "
          f"every={every}", flush=True)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=in_plane, dz=dz,
                                noise=noise, slice_motions=slice_motions,
                                orientations=list(orientations))
    mask_img = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())

    # original-slice world ORIGINS (3-vectors) per stack
    orig_o = []
    for st in stacks:
        a = st.attr
        zax = np.asarray(a.zaxis, np.float64)
        c = np.asarray([a.xorigin, a.yorigin, a.zorigin], np.float64)
        orig_o.append(np.stack(
            [c + (j - (a.z - 1) / 2.0) * a.dz * zax for j in range(a.z)]))

    def _psnr(out):
        gt_on = np.asarray(resample_to_grid(
            jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i(), jnp.float32),
            out.attr.shape_zyx, jnp.asarray(out.attr.i2w(), jnp.float32)))
        roi = (gt_on > 1.0) & (out.data > 0)
        return psnr(out.data[roi], gt_on[roi])

    import os
    base = dict(resolution=1.25, rec_iterations_first=3,
                rec_iterations_last=4, smooth_mask=2.0, multires_levels=1,
                reg_levels=2, reg_iterations=8)
    n_it = int(os.environ.get("DIAG_ITERS", "3"))

    p0 = _psnr(svr_mod.run_svr(SVRConfig(iterations=1, **base),
                               stacks=stacks, mask=mask_img).reconstructed)
    print(f"no-reg : {p0:.2f}", flush=True)

    captured = {}
    orig_create = svr_mod.create_slices

    def capture_create(stks, thickness, **kw):
        b = orig_create(stks, thickness, **kw)
        captured["batch"] = b
        return b

    def true_transforms(b):
        n = b.n_slices
        out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for idx in range(n):
            s = int(b.stack_index[idx])
            a = b.attrs[idx]
            o = np.asarray([a.xorigin, a.yorigin, a.zorigin], np.float64)
            j = int(np.argmin(np.linalg.norm(orig_o[s] - o, axis=1)))
            out[idx] = rigid_matrix(slice_motions[s][j])
        return out

    orig_reg = svr_mod.s2v.register_slices_to_volume

    def oracle_reg(cfg, recon, recon_w2i, transforms, mo, ofs, targets,
                   recon_dx, **kw):
        out = true_transforms(captured["batch"])
        return jnp.asarray(out), jnp.zeros((out.shape[0],), jnp.float32)

    svr_mod.create_slices = capture_create
    svr_mod.s2v.register_slices_to_volume = oracle_reg
    try:
        p_or = _psnr(svr_mod.run_svr(SVRConfig(iterations=n_it, **base),
                                     stacks=stacks,
                                     mask=mask_img).reconstructed)
    finally:
        svr_mod.s2v.register_slices_to_volume = orig_reg
    print(f"oracle : {p_or:.2f} (ceiling {p_or - p0:+.2f})", flush=True)

    res = svr_mod.run_svr(SVRConfig(iterations=n_it, **base), stacks=stacks,
                          mask=mask_img)
    svr_mod.create_slices = orig_create
    p1 = _psnr(res.reconstructed)
    print(f"reg    : {p1:.2f} (gain {p1 - p0:+.2f})", flush=True)

    # per-slice transform error vs truth (translation part of T - T_true
    # evaluated at the slice centre)
    b = captured["batch"]
    tt = true_transforms(b)
    got = np.asarray(res.transforms)
    errs0, errs1 = [], []
    for idx in range(b.n_slices):
        a = b.attrs[idx]
        c = np.asarray([a.xorigin, a.yorigin, a.zorigin, 1.0])
        d_id = np.linalg.norm((np.eye(4) @ c - tt[idx] @ c)[:3])
        d_got = np.linalg.norm((got[idx] @ c - tt[idx] @ c)[:3])
        errs0.append(d_id)
        errs1.append(d_got)
    errs0, errs1 = np.asarray(errs0), np.asarray(errs1)
    print(f"slice-centre displacement error vs truth: "
          f"identity {errs0.mean():.2f} mm -> registered "
          f"{errs1.mean():.2f} mm (moved slices only: "
          f"{errs0[errs0 > 0.5].mean():.2f} -> "
          f"{errs1[errs0 > 0.5].mean():.2f})", flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=float, default=4.0)
    ap.add_argument("--r", type=float, default=5.0)
    ap.add_argument("--every", type=int, default=2)
    a = ap.parse_args()
    main(t_amp=a.t, r_amp=a.r, every=a.every)
