"""SVR reconstruction CLI.

Flag-compatible port of the reference SVRreconstructionGPU option table
(reconstruction.cc:162-211); GPU-device flags are accepted but ignored
(device placement is JAX's job).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="svr-reconstruct",
        description="Slice-to-volume reconstruction (SVR)")
    p.add_argument("-o", "--output", default="3TReconstruction.nii.gz",
                   help="Name for the reconstructed volume")
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="Input stacks (NIfTI)")
    p.add_argument("-m", "--mask", default=None, help="Binary mask")
    p.add_argument("-t", "--transformations", nargs="*", default=[],
                   help="Initial stack transform .dof files (optional)")
    p.add_argument("--thickness", nargs="*", type=float, default=[],
                   help="Slice thickness per stack [default: 2*dz]")
    p.add_argument("-p", "--packages", nargs="*", type=int, default=[],
                   help="Packages per stack (hierarchical registration)")
    p.add_argument("--iterations", type=int, default=9)
    p.add_argument("--sigma", type=float, default=20.0)
    p.add_argument("--resolution", type=float, default=0.75)
    p.add_argument("--multires", type=int, default=3)
    p.add_argument("--average", type=float, default=700.0)
    p.add_argument("--delta", type=float, default=150.0)
    p.add_argument("--lambda", dest="lambda_", type=float, default=0.02)
    p.add_argument("--lastIterLambda", type=float, default=0.01)
    p.add_argument("--smooth_mask", type=float, default=4.0)
    p.add_argument("--global_bias_correction", action="store_true")
    p.add_argument("--low_intensity_cutoff", type=float, default=0.01)
    p.add_argument("--force_exclude", nargs="*", type=int, default=[])
    p.add_argument("--no_intensity_matching", action="store_true")
    p.add_argument("--log_prefix", default="")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_gpu", action="store_true",
                   help="Debug device-side results (alias of --debug)")
    p.add_argument("--patchBased", action="store_true",
                   help="Experimental patch-based slice mode")
    p.add_argument("--patchSize", type=int, default=64)
    p.add_argument("--patchStride", type=int, default=32)
    p.add_argument("--superpixelBased", action="store_true",
                   help="Experimental superpixel-based slice mode")
    p.add_argument("-s", "--superpixel", type=float, default=0.0,
                   help="[noLabels] number of superpixels per slice")
    p.add_argument("--manualMask", default="",
                   help="Per-slice manual mask of the FIRST stack; pushed "
                        "through the PSF into recon space at the end")
    p.add_argument("--rec_iterations_first", type=int, default=4)
    p.add_argument("--rec_iterations_last", type=int, default=13)
    p.add_argument("--disableBiasCorrection", action="store_true",
                   default=True)
    p.add_argument("--enableBiasCorrection", dest="disableBiasCorrection",
                   action="store_false",
                   help="Enable the 2D slice bias correction")
    p.add_argument("--useNMI", action="store_true")
    p.add_argument("--saveSliceTransformations", action="store_true")
    p.add_argument("--no_log", action="store_true")
    # accepted for reference compatibility; ignored
    p.add_argument("-d", "--devices", nargs="*", type=int, default=[])
    p.add_argument("--useCPU", action="store_true",
                   help="Run on the CPU backend (forces jax platform cpu; "
                        "the reference's CPU reconstruction path)")
    p.add_argument("--useCPUReg", action="store_true")
    p.add_argument("--useGPUReg", action="store_true")
    p.add_argument("--useAutoTemplate", action="store_true")
    p.add_argument("--num_stacks_tuner", type=int, default=0)
    p.add_argument("--sfolder", default="",
                   help="Folder with replacement slices")
    p.add_argument("--referenceVolume", default="",
                   help="Reference volume (seeds reconstruction; "
                        "required by --T1PackageSize)")
    p.add_argument("--T1PackageSize", type=int, default=0)
    p.add_argument("--tfolder", default="",
                   help="Folder with per-slice transformation%%i.dof files")
    p.add_argument("--engine", choices=["fast", "exact"], default="fast",
                   help="PSF engine: fast (conv+trilinear) or exact "
                        "(reference-faithful offsets)")
    p.add_argument("--checkpoint", default="",
                   help="Directory for per-outer-iteration checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in --checkpoint")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="Shard the slice batch over the first N devices "
                        "(0 = all devices if more than one, else single)")
    p.add_argument("--mesh-mode", choices=("slices", "volume", "grid"),
                   default="slices",
                   help="'slices': data-parallel slice sharding "
                        "(replicated volume); 'volume': z-slab volume "
                        "sharding for large-area runs "
                        "(parallel/volume_sharded.py); 'grid': 2-D "
                        "slice-DP x z-slab composition "
                        "(parallel/mesh2d.py)")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host: call jax.distributed.initialize() "
                        "before device discovery (set JAX coordinator env "
                        "vars or rely on auto-detection)")
    p.add_argument("--trace", default="",
                   help="Capture a jax.profiler device trace to this dir")
    p.add_argument("--bspline", action="store_true",
                   help="Also write the alternative B-spline reconstruction "
                        "(<output>.bspline.nii.gz)")
    return p


def make_mesh(n: int, mode: str = "slices"):
    """Build a 1-D mesh over the first n devices (all if n==0 and more
    than one device is present; None for single-device runs).  The axis
    name selects the sharding mode: "slices" (slice-DP) or "vol_z"
    (volume z-slab sharding)."""
    import jax
    from jax.sharding import Mesh
    import numpy as np
    devs = jax.devices()
    if n == 0:
        n = len(devs)
    if n <= 1:
        return None
    if mode == "grid":
        # 2-D slice-DP x vol_z mesh (parallel/mesh2d.py)
        from ..parallel.mesh2d import grid_shape, make_mesh2d
        s, v = grid_shape(n)
        return make_mesh2d(s, v, devs[:n])
    axis = "vol_z" if mode == "volume" else "slices"
    return Mesh(np.asarray(devs[:n]), (axis,))


class _LogRedirect:
    """stdout/stderr redirection to log files (reconstruction.cc:633-656:
    log-registration.txt / log-registration-error.txt; restored on exit)."""

    def __init__(self, prefix: str, enabled: bool):
        self.enabled = enabled
        self.prefix = prefix

    def __enter__(self):
        if not self.enabled:
            return self
        self._out, self._err = sys.stdout, sys.stderr
        self._fo = open(self.prefix + "log-reconstruction.txt", "a")
        self._fe = open(self.prefix + "log-registration-error.txt", "a")
        sys.stdout, sys.stderr = self._fo, self._fe
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        sys.stdout, sys.stderr = self._out, self._err
        self._fo.close()
        self._fe.close()
        return False


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.useCPU:
        # the reference's --useCPU selects its CPU reconstruction path
        # (reconstruction.cc:121); here it forces the CPU backend (the env
        # var alone may be re-exported by site packages, so set the config)
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.distributed:
        # all three mesh modes place host-global state through
        # parallel.sharded.place_global, which switches to
        # make_array_from_callback when process_count > 1 — every mode
        # (slices / volume / grid) runs across hosts
        import jax
        jax.distributed.initialize()

    from ..utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    from ..pipeline.config import SVRConfig
    from ..pipeline.svr import run_svr
    from ..io.nifti import write_nifti

    cfg = SVRConfig(
        output=args.output,
        input_stacks=args.input,
        mask=args.mask,
        thickness=args.thickness,
        packages=args.packages,
        iterations=args.iterations,
        sigma=args.sigma,
        resolution=args.resolution,
        multires_levels=args.multires,
        average_value=args.average,
        delta=args.delta,
        lambda_=args.lambda_,
        last_iter_lambda=args.lastIterLambda,
        smooth_mask=args.smooth_mask,
        global_bias_correction=args.global_bias_correction,
        low_intensity_cutoff=args.low_intensity_cutoff,
        intensity_matching=not args.no_intensity_matching,
        rec_iterations_first=args.rec_iterations_first,
        rec_iterations_last=args.rec_iterations_last,
        disable_bias_correction=args.disableBiasCorrection,
        use_nmi=args.useNMI,
        tfolder=args.tfolder,
        sfolder=args.sfolder,
        reference_volume=args.referenceVolume,
        t1_package_size=args.T1PackageSize,
        force_excluded=args.force_exclude,
        debug=args.debug,
        log_prefix=args.log_prefix,
        save_slice_transformations=args.saveSliceTransformations,
        use_auto_template=args.useAutoTemplate,
        engine=args.engine,
        patch_based=args.patchBased,
        patch_size=args.patchSize,
        patch_stride=args.patchStride,
        superpixel_based=args.superpixelBased,
        num_superpixels=args.superpixel,
        manual_mask=args.manualMask,
        num_stacks_tuner=args.num_stacks_tuner,
        no_log=args.no_log,
        checkpoint_dir=args.checkpoint,
        resume=args.resume,
        bspline=args.bspline)
    cfg.debug = cfg.debug or args.debug_gpu
    cfg.transformation_files = args.transformations

    mesh = make_mesh(args.mesh, args.mesh_mode) \
        if (args.mesh or args.distributed) else None
    import contextlib
    tracer = contextlib.nullcontext()
    if args.trace:
        from ..utils.tracing import trace
        tracer = trace(args.trace)
    with tracer, _LogRedirect(args.log_prefix, not args.no_log):
        result = run_svr(cfg, mesh=mesh,
                         mesh_mode=args.mesh_mode)
    write_nifti(result.reconstructed, cfg.output)
    print(f"wrote {cfg.output} ({len(result.slice_weights)} slices)")
    if result.bspline_reconstructed is not None:
        write_nifti(result.bspline_reconstructed,
                    cfg.output + ".bspline.nii.gz")
        print(f"wrote {cfg.output}.bspline.nii.gz")

    if result.manual_mask_volume is not None:
        import os
        d, b = os.path.split(args.manualMask)
        mpath = os.path.join(d, "PSFTransformed_" + b)
        write_nifti(result.manual_mask_volume, mpath)
        print(f"wrote {mpath}")

    if args.saveSliceTransformations:
        from ..io.dof import save_transformations
        folder = cfg.output + ".transforms"
        save_transformations(folder, result.transforms)
        print(f"wrote {folder}/transformation*.dof")

    result.stats.print()
    perf_name = (args.log_prefix
                 + time.strftime("performance_%Y-%m-%d-%H-%M-%S.txt"))
    result.stats.write(perf_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
