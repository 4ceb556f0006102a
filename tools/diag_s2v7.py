"""Scenario design for the s2v acceptance test: find a per-slice-motion
configuration where the ORACLE (true transforms) gains well over 1 dB —
i.e. motion genuinely destroys reconstruction quality — then check what
the real registration recovers.

Round-3 finding (diag_s2v6): the round-2 scenario (±2 mm/±3°, noise 0.5,
2 mm in-plane / 3 mm spacing / 6 mm thick, 1.6 mm recon) has an oracle
ceiling of 0.06 dB — PSF blur + noise dominate PSNR, so NO registration
could ever pass the old test."""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
from phantom import make_ground_truth, simulate_stacks, psnr
from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.ops.sampling import resample_to_grid
from fetalreconstruction_tpu.pipeline.config import SVRConfig
from fetalreconstruction_tpu.pipeline import svr as svr_mod
from fetalreconstruction_tpu.register import slice2vol as s2v


def scenario(gt_n, gt_sp, in_plane, dz, noise, t_amp, r_amp, res,
             reg_kw=None, seed=3):
    gt = make_ground_truth(n=gt_n, spacing=gt_sp)
    rng = np.random.default_rng(seed)
    slice_motions = []
    nz_bound = int(gt_n * gt_sp / dz)
    for s in range(2):
        m = np.zeros((nz_bound, 6))
        m[::2, :3] = rng.uniform(-t_amp, t_amp, (len(m[::2]), 3))
        m[::2, 3:] = rng.uniform(-r_amp, r_amp, (len(m[::2]), 3))
        slice_motions.append(m)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=in_plane, dz=dz,
                                noise=noise, slice_motions=slice_motions)
    mask_img = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    nz = stacks[0].attr.z
    # original-slice world z-origins per stack: the pipeline CROPS stacks
    # to the mask bbox before slicing, so batch slice j is original slice
    # j + z1 — map batch slices back by world position, not index
    orig_zo = []
    for st in stacks:
        a = st.attr
        zo = [a.zorigin + (j - (a.z - 1) / 2.0) * a.dz for j in range(a.z)]
        orig_zo.append(np.asarray(zo))

    def _psnr(out):
        gt_on = np.asarray(resample_to_grid(
            jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i(), jnp.float32),
            out.attr.shape_zyx, jnp.asarray(out.attr.i2w(), jnp.float32)))
        roi = (gt_on > 1.0) & (out.data > 0)
        return psnr(out.data[roi], gt_on[roi])

    base = dict(resolution=res, rec_iterations_first=3,
                rec_iterations_last=4, smooth_mask=2.0, multires_levels=1,
                reg_levels=2, reg_iterations=8)
    if reg_kw:
        base.update(reg_kw)

    p0 = _psnr(svr_mod.run_svr(SVRConfig(iterations=1, **base),
                               stacks=stacks, mask=mask_img).reconstructed)

    # capture the pipeline's (cropped) slice batch so the oracle can map
    # each batch slice back to its ORIGINAL stack slice by world position
    captured = {}
    orig_create = svr_mod.create_slices

    def capture_create(stks, thickness, **kw):
        b = orig_create(stks, thickness, **kw)
        captured["batch"] = b
        return b

    orig_reg = svr_mod.s2v.register_slices_to_volume

    def oracle_reg(cfg, recon, recon_w2i, transforms, mo, ofs, targets,
                   recon_dx):
        b = captured["batch"]
        n = transforms.shape[0]
        out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for idx in range(min(n, b.n_slices)):
            s = int(b.stack_index[idx])
            j = int(np.argmin(np.abs(orig_zo[s] - b.attrs[idx].zorigin)))
            out[idx] = rigid_matrix(slice_motions[s][j])
        return jnp.asarray(out), jnp.zeros((n,), jnp.float32)

    svr_mod.create_slices = capture_create
    svr_mod.s2v.register_slices_to_volume = oracle_reg
    try:
        p_or = _psnr(svr_mod.run_svr(SVRConfig(iterations=3, **base),
                                     stacks=stacks,
                                     mask=mask_img).reconstructed)
    finally:
        svr_mod.s2v.register_slices_to_volume = orig_reg
        svr_mod.create_slices = orig_create

    p1 = _psnr(svr_mod.run_svr(SVRConfig(iterations=3, **base),
                               stacks=stacks, mask=mask_img).reconstructed)
    return p0, p_or, p1


if __name__ == "__main__":
    import time
    cfgs = [
        ("big motion, low noise, finer grid",
         dict(gt_n=32, gt_sp=1.25, in_plane=1.5, dz=2.5, noise=0.25,
              t_amp=4.0, r_amp=5.0, res=1.25)),
    ]
    for name, kw in cfgs:
        t0 = time.time()
        p0, p_or, p1 = scenario(**kw)
        print(f"[{name}] no-reg {p0:.2f}  oracle {p_or:.2f} "
              f"(ceiling {p_or - p0:+.2f})  reg {p1:.2f} "
              f"(gain {p1 - p0:+.2f})  [{time.time() - t0:.0f}s]",
              flush=True)
