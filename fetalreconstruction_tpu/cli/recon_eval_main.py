"""Reconstruction-evaluation research harness
(irtkReconstructionEvaluation.cc — the crop + rigid-refine + histogram
battery used for the paper's quantitative tables).

Flow (irtkReconstructionEvaluation.cc:272-360):
  1. cropImage() (:56-98): resample the target onto the SOURCE grid
     where source > 0 (nearest voxel, matching the reference's integer
     indexing), producing the cropped target, the difference volume
     (cropped - source; -1 outside) and the source>0 mask;
  2. rreg2() (:100-270): rigid registration of the cropped target to the
     source over the mask, written as a .dof transform;
  3. the irtkEvaluation histogram battery between the registered pair
     (CC/SSD/JE/MI/NMI/CR/LC/Kappa/PSNR) printed as the metric row.

Usage mirrors the reference:
  fetalrecon-recon-eval target source output diff_volume mask dofout
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fetalrecon-recon-eval",
        description="Crop + rigidly refine + evaluate a reconstruction "
                    "against a reference volume "
                    "(irtkReconstructionEvaluation.cc)")
    p.add_argument("target")
    p.add_argument("source")
    p.add_argument("output", help="cropped target (written)")
    p.add_argument("diff_volume", help="difference volume (written)")
    p.add_argument("mask", help="source>0 mask (written)")
    p.add_argument("dofout", help="rigid refinement transform (written)")
    p.add_argument("--nbins_x", type=int, default=0)
    p.add_argument("--nbins_y", type=int, default=0)
    args = p.parse_args(argv)

    from ..utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    import jax.numpy as jnp
    from ..core.image import Image
    from ..io.nifti import read_nifti, write_nifti
    from ..io.dof import write_dof
    from ..ops.sampling import resample_to_grid
    from ..register.volume import VolRegConfig, register_volumes
    from ..evaluation.metrics import evaluate

    target = read_nifti(args.target)
    source = read_nifti(args.source)

    # ---- cropImage(): target resampled onto the source grid where
    # source > 0 (the reference indexes the target with truncated
    # doubles — nearest-voxel semantics)
    tvals = np.asarray(resample_to_grid(
        jnp.asarray(target.data), jnp.asarray(target.attr.w2i(),
                                              jnp.float32),
        source.attr.shape_zyx, jnp.asarray(source.attr.i2w(),
                                           jnp.float32),
        interp="nn", padding=0.0))
    smask = source.data > 0
    cropped = np.where(smask, tvals, 0.0).astype(np.float32)
    diff = np.where(smask, cropped - source.data, -1.0).astype(np.float32)
    write_nifti(Image(cropped, source.attr.copy()), args.output)
    write_nifti(Image(diff, source.attr.copy()), args.diff_volume)
    write_nifti(Image(smask.astype(np.float32), source.attr.copy()),
                args.mask)
    print("Crop Image ... done")

    # ---- rreg2(): rigid refinement of the cropped target vs the source
    cfg = VolRegConfig(metric="cc")
    t_mat, sim = register_volumes(cfg, Image(cropped, source.attr.copy()),
                                  source, target_padding=0.0)
    write_dof(args.dofout, t_mat)
    print(f"Registration ... done (similarity {sim:.4f})")

    # ---- evaluation battery on the registered pair: sample the source
    # through the refined transform onto the cropped-target grid
    sdata = np.asarray(resample_to_grid(
        jnp.asarray(source.data),
        jnp.asarray(source.attr.w2i() @ t_mat, jnp.float32),
        source.attr.shape_zyx,
        jnp.asarray(source.attr.i2w(), jnp.float32),
        interp="linear", padding=0.0))
    r = evaluate(Image(cropped, source.attr.copy()),
                 Image(sdata.astype(np.float32), source.attr.copy()),
                 nbins_x=args.nbins_x, nbins_y=args.nbins_y)
    print(f"CC: {r.cc}")
    print(f"SSD: {r.ssd}")
    print(f"JE: {r.je}")
    print(f"MI: {r.mi}")
    print(f"NMI: {r.nmi}")
    print(f"CR_X|Y: {r.cr_xy}")
    print(f"CR_Y|X: {r.cr_yx}")
    print(f"LC: {r.lc}")
    print(f"KS: {r.ks}")
    print(f"PSNR: {r.psnr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
