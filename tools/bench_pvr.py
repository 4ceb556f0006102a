"""PVR (patch-to-volume) wall-clock — BASELINE.json configs 3-5.

Two workloads on the bench_full synthetic (textured ellipsoid GT, 4
stacks 144x144 @1.25 mm in-plane / 5 mm thick, per-slice motion):

  default        BASELINE config-3 class: 32x32 patches, stride 16x16,
                 reconstruct at 1.0 mm
  --superpixel   config-4 class: SLIC superpixels --spxSize 64
  --large        config-5 class: 8 stacks, 64x64 patches stride 32,
                 0.75 mm reconstruction (the large-area scaling config;
                 one device here — the multi-host grid mode is
                 exercised separately by tests/test_multihost.py)

Reports the per-phase PerfStats table, patches/s over the registration
stage, end-to-end minutes, and PSNR vs the ground truth.  Run:
  python tools/bench_pvr.py [--large|--superpixel] [--iterations 3]
"""
import argparse
import os
import sys
import time

os.environ.setdefault("FETALRECON_SYNC_STATS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_full import build_problem, psnr_vs_ground_truth


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--rec-iterations", type=int, default=4)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--superpixel", action="store_true")
    ap.add_argument("--hierarchical", action="store_true")
    args = ap.parse_args()

    import jax
    from fetalreconstruction_tpu.utils.compile_cache import \
        configure_compile_cache
    configure_compile_cache()
    print(f"backend: {jax.default_backend()}")

    if args.large:
        n_stacks, resolution = 8, 0.75
        patch_size, patch_stride = 64, 32
    else:
        n_stacks, resolution = 4, 1.0
        patch_size, patch_stride = 32, 16

    t0 = time.perf_counter()
    gt, mask, stacks = build_problem(n_stacks=n_stacks)
    print(f"problem built in {time.perf_counter() - t0:.1f}s: "
          f"{len(stacks)} stacks of {stacks[0].data.shape}")

    from fetalreconstruction_tpu.pipeline.pvr import PVRConfig, run_pvr

    cfg = PVRConfig(iterations=args.iterations,
                    resolution=resolution,
                    rec_iterations_first=args.rec_iterations,
                    rec_iterations_last=args.rec_iterations,
                    patch_size=patch_size, patch_stride=patch_stride,
                    superpixel=args.superpixel,
                    hierarchical=args.hierarchical,
                    no_log=True)

    t0 = time.perf_counter()
    res = run_pvr(cfg, stacks=stacks, mask=mask)
    total = time.perf_counter() - t0
    print()
    print(res.stats.table())
    print()
    reg = res.stats._samples.get("registration", [])
    n_patches = len(res.slice_weights)
    if reg:
        reg_total = sum(reg)
        print(f"patch-to-volume registration: {n_patches} patches x "
              f"{len(reg)} rounds in {reg_total:.1f}s = "
              f"{n_patches * len(reg) / reg_total:.1f} patches/s")
    print(f"END-TO-END: {total:.1f}s ({total / 60:.2f} min) for "
          f"{args.iterations} outer iterations, {n_patches} patches "
          f"(size {patch_size} stride {patch_stride}, "
          f"{resolution} mm recon)")
    psnr = psnr_vs_ground_truth(gt, res.reconstructed)
    print(f"PSNR vs ground truth (masked): {psnr:.2f} dB")


if __name__ == "__main__":
    main()
