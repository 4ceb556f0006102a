"""Smoke run of the reconstruction system on one NVIDIA GPU.

Drives the main path once at canonical widths and checks each phase:

  device     the card (nvidia-smi name and power limit), JAX, XLA_FLAGS
  gpu tests  `pytest -m gpu` in a child process, run before this process
             touches the card (a JAX process reserves most of its memory)
  kernels    fast_scatter2, fast_simulate and conv_separable at canonical
             widths (132 slices of 144x144, 4 stacks, 160^3 grid) against
             the NumPy float64 reference (ops/psf_fast_ref.py) on the same
             inputs; the fast engine against the exact engine (ops/psf.py);
             memory analysis of the fused inner SR/EM iteration
  svr        the canonical phantom (tools/bench_full.py) written to NIfTI
             and reconstructed by svr-reconstruct at 1.0 mm, 3 outer and
             4/4 SR iterations; PSNR against the phantom's ground truth
  pvr        the same stacks through pvr-reconstruct, square patches
             32/16, one outer iteration

The last line of standard output is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed.  Where JAX finds no GPU the script exits non-zero.

  python chip_smoke.py [--seed N]
  python chip_smoke.py --four     # only the four-card phase: the canonical
                                  # SVR (2 outer iterations) over 4 cards,
                                  # slices and 2x2 grid meshes, against the
                                  # one-card run
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# f32 kernels against a float64 reference on the same inputs: the device
# sums in another (and, for the atomic scatter, unfixed) order, so errors
# are float32 rounding, ~1e-7 per operation; measured as max |dev - ref|
# over max |ref|.
KERNEL_TOL = 1e-5
# fast engine against the exact engine: the README's bound on the mean
# deviation of the normalized fields (two discretizations of one model)
ENGINE_TOL = 0.03
# sanity floor for the canonical SVR (an all-zero volume scores ~5 dB)
PSNR_FLOOR_DB = 20.0
# four-card runs against the one-card run: atomics sum in no fixed order,
# so registration accept decisions may differ; the volumes must agree in
# quality, not bitwise
MESH_PSNR_TOL_DB = 1.0
FOUR_ITERATIONS = 2


class PhaseError(RuntimeError):
    pass


def card() -> str:
    """`name, power limit` of the GPU(s) as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0] if len(set(out)) == 1 else " / ".join(out)


def require_gpu():
    """The JAX devices, or PhaseError unless the first one is a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise PhaseError(f"no GPU: JAX found platform "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    return devs


def device_peaks(devs):
    """Peak bytes each device's arrays have held so far."""
    return [d.memory_stats()["peak_bytes_in_use"] for d in devs]


def say(phase, card_str, **fields):
    vals = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {vals} | {card_str}", flush=True)


def rel_err(dev, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(dev, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def check(name, err, tol):
    if not err <= tol:
        raise PhaseError(f"{name}: error {err:.3e} above tolerance {tol}")


class _Tee(io.TextIOBase):
    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def run_cli(main, argv):
    """Run a CLI main in-process; returns its captured standard output."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    if rc != 0:
        raise PhaseError(f"{main.__module__} returned {rc}")
    return tee.buf.getvalue()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_gpu_tests(card_str):
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider"], cwd=ROOT, env=env, capture_output=True,
        text=True)
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-2000:]]
    print(proc.stdout[-4000:], flush=True)
    if proc.returncode != 0 or "skipped" in tail[0] or "passed" not in tail[0]:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise PhaseError(f"pytest -m gpu: rc={proc.returncode}: {tail[0]}")
    say("gpu tests", card_str, result=tail[0].replace(" ", "_"))


def _canonical_kernels_problem():
    """Canonical widths with an ellipsoid mask and a textured volume."""
    import jax.numpy as jnp
    import bench
    from fetalreconstruction_tpu.ops import psf_fast as pf
    from fetalreconstruction_tpu.pipeline import svr_core
    ctx, p = bench.build_problem(stack_slices=33)
    vs = tuple(ctx.vol_shape)
    lin = np.linspace(-1, 1, vs[0])
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xx ** 2 + 1.15 * yy ** 2 + 1.25 * zz ** 2)
    mask = (r < 0.86).astype(np.float32)
    vol = np.where(r < 0.82, 360.0 + 140.0 * np.cos(9 * np.pi * r)
                   + 90.0 * np.sin(7 * xx + 11 * yy - 9 * zz), 0.0)
    fwd = svr_core.slice_forward_matrices(
        jnp.asarray(p["recon_w2i"], jnp.float32),
        jnp.tile(jnp.eye(4, dtype=jnp.float32), (p["n"], 1, 1)),
        jnp.asarray(p["i2w"], jnp.float32))
    geom = pf.make_fast_geom(ctx.fast, fwd, p["valid"], vs,
                             jnp.asarray(mask))
    return ctx, p, fwd, geom, jnp.asarray(mask), vol.astype(np.float32)


def phase_kernels(card_str):
    import jax
    import jax.numpy as jnp
    from fetalreconstruction_tpu.ops import psf as exact
    from fetalreconstruction_tpu.ops import psf_fast as pf
    from fetalreconstruction_tpu.ops import psf_fast_ref as ref
    from fetalreconstruction_tpu.pipeline import svr_core

    ctx, p, fwd, geom, mask, vol = _canonical_kernels_problem()
    fast, vs = ctx.fast, tuple(ctx.vol_shape)
    terms = fast.terms
    say("kernels", card_str, slices=p["n"], slice_hw=p["valid"].shape[1],
        stacks=len(terms), grid="x".join(map(str, vs)))
    rng = np.random.default_rng(0)
    xp, sid = np.asarray(geom.xp), np.asarray(geom.sid)
    sume, den = np.asarray(geom.sume), np.asarray(geom.den)
    gate = np.asarray(geom.valid) & (sume > 0)
    pa = np.where(gate, rng.uniform(-50, 50, gate.shape), 0).astype(
        np.float32)
    pb = np.where(gate, rng.uniform(0, 1, gate.shape), 0).astype(np.float32)

    t0 = time.perf_counter()
    scat = jax.jit(lambda a, b: pf.fast_scatter2(fast, geom, a, b, mask, vs))
    da, db = jax.block_until_ready(scat(jnp.asarray(pa), jnp.asarray(pb)))
    ra, rb = ref.scatter2(terms, xp, sid, sume, pa, pb, np.asarray(mask), vs)
    err = max(rel_err(da, ra), rel_err(db, rb))
    check("fast_scatter2", err, KERNEL_TOL)
    say("kernels", card_str, kernel="fast_scatter2", max_rel_err=err,
        tol=KERNEL_TOL, wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    simf = jax.jit(lambda v: pf.fast_simulate(fast, geom, v, mask, vs))
    sim, simw, inside = jax.block_until_ready(simf(jnp.asarray(vol)))
    rsim, rsimw, rinside = ref.simulate(terms, xp, sid, sume, den,
                                        np.asarray(geom.valid), vol,
                                        np.asarray(mask))
    if not np.array_equal(np.asarray(inside), rinside):
        raise PhaseError("fast_simulate: inside mask differs from reference")
    err = max(rel_err(sim, rsim), rel_err(simw, rsimw))
    check("fast_simulate", err, KERNEL_TOL)
    say("kernels", card_str, kernel="fast_simulate", max_rel_err=err,
        tol=KERNEL_TOL, wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    v2 = rng.uniform(0, 1, (2,) + vs).astype(np.float32)
    err = 0.0
    conv = jax.jit(lambda v, flip: [pf.conv_separable(v, tt, flip=flip)
                                    for tt in terms], static_argnums=1)
    for flip in (False, True):
        outs = jax.block_until_ready(conv(jnp.asarray(v2), flip))
        for o, tt in zip(outs, terms):
            err = max(err, rel_err(o, ref.conv_separable(v2, tt, flip)))
    check("conv_separable", err, KERNEL_TOL)
    say("kernels", card_str, kernel="conv_separable", max_rel_err=err,
        tol=KERNEL_TOL, wall_s=time.perf_counter() - t0)

    # fast engine against the exact engine, at canonical size
    t0 = time.perf_counter()
    dims = jnp.asarray(p["dims"], jnp.float32)
    egeom = exact.make_slice_geom(fwd, dims, p["valid"])
    esume = jax.jit(lambda g: exact.psf_sums(g, ctx.offsets, vs))(egeom)
    mflat = mask.reshape(-1)
    esim, _, ein = jax.jit(lambda g, s, v: exact.psf_gather(
        g, ctx.offsets, s, v, mflat, vs))(egeom, esume,
                                         jnp.asarray(vol).reshape(-1))
    both = np.asarray(ein) & np.asarray(inside)
    a, b = np.asarray(sim)[both], np.asarray(esim)[both]
    dev_sim = float(np.abs(a - b).mean() / np.abs(b).mean())
    egate = p["valid"] & (esume > 0)
    pay = jnp.where(egate, jnp.asarray(np.abs(pa) + 10.0), 0.0)
    ea, eb = jax.jit(lambda g, s, x, y: exact.psf_scatter(
        g, ctx.offsets, s, [x, y], mflat, vs))(
            egeom, esume, pay, jnp.where(egate, 1.0, 0.0))
    fgate = jnp.asarray(gate)
    fa, fb = scat(jnp.where(fgate, jnp.asarray(np.abs(pa) + 10.0), 0.0),
                  jnp.where(fgate, 1.0, 0.0))
    ea, eb = np.asarray(ea).reshape(vs), np.asarray(eb).reshape(vs)
    fa, fb = np.asarray(fa), np.asarray(fb)
    core = (eb > 0.2) & (fb > 0.2)
    re_, rf = ea[core] / eb[core], fa[core] / fb[core]
    dev_scat = float(np.abs(rf - re_).mean() / np.abs(re_).mean())
    mass = float(fb.sum() / eb.sum())
    check("fast vs exact simulate", dev_sim, ENGINE_TOL)
    check("fast vs exact scatter", dev_scat, ENGINE_TOL)
    if not 0.8 < mass < 1.25:
        raise PhaseError(f"fast vs exact weight mass ratio {mass}")
    say("kernels", card_str, kernel="fast_vs_exact",
        offsets=len(ctx.offsets), simulate_mean_dev=dev_sim,
        scatter_mean_dev=dev_scat, weight_mass_ratio=mass, tol=ENGINE_TOL,
        wall_s=time.perf_counter() - t0)

    # the fused inner SR/EM iteration: memory analysis + one finite step
    t0 = time.perf_counter()
    sume_j = geom.sume
    em = svr_core.init_em_state(p["n"], p["valid"])
    recon, wts, _ = svr_core.gaussian_reconstruction(
        ctx, geom, sume_j, p["slices"], p["valid"], em.bias, em.scale,
        mask.reshape(-1))
    simst = svr_core.simulate(ctx, geom, sume_j, recon, mask.reshape(-1))
    excluded = jnp.zeros((p["n"],), bool)
    em = svr_core.initialize_robust_statistics(
        ctx, p["slices"], p["valid"], simst, em, 700.0, 100.0, excluded)
    args = (ctx, geom, sume_j, p["slices"], p["valid"], em, simst, recon,
            wts, mask, mask.reshape(-1), excluded, 1.0, 450.0, 100.0, 700.0,
            2)
    compiled = svr_core.inner_iteration.lower(*args).compile()
    print(f"inner_iteration memory_analysis: {compiled.memory_analysis()}",
          flush=True)
    _, _, recon = jax.block_until_ready(svr_core.inner_iteration(*args))
    if not np.all(np.isfinite(np.asarray(recon))):
        raise PhaseError("inner_iteration produced non-finite values")
    say("kernels", card_str, kernel="inner_iteration", finite=True,
        wall_s=time.perf_counter() - t0)


def _phantom_on_disk(tmp, seed):
    from fetalreconstruction_tpu.io.nifti import write_nifti
    from tools.bench_full import build_problem
    gt, mask, stacks = build_problem(seed=seed)
    paths = []
    for i, st in enumerate(stacks):
        paths.append(os.path.join(tmp, f"stack{i}.nii.gz"))
        write_nifti(st, paths[-1])
    mpath = os.path.join(tmp, "mask.nii.gz")
    write_nifti(mask, mpath)
    return gt, paths, mpath


def _svr(tmp, paths, mpath, out, extra=(), iterations=3):
    from fetalreconstruction_tpu.cli import svr_main
    from fetalreconstruction_tpu.io.nifti import read_nifti
    t0 = time.perf_counter()
    text = run_cli(svr_main.main, [
        "-o", out, "-i", *paths, "-m", mpath, "--resolution", "1.0",
        "--iterations", str(iterations), "--rec_iterations_first", "4",
        "--rec_iterations_last", "4", "--no_log",
        "--log_prefix", tmp + os.sep, *extra])
    wall = time.perf_counter() - t0
    n = int(text.rsplit(" slices)", 1)[0].rsplit("(", 1)[1])
    img = read_nifti(out)
    if not np.all(np.isfinite(img.data)):
        raise PhaseError(f"svr-reconstruct {extra}: non-finite volume")
    return img, n, wall


def phase_svr_pvr(card_str, seed):
    from fetalreconstruction_tpu.cli import pvr_main
    from fetalreconstruction_tpu.io.nifti import read_nifti
    from tools.bench_full import psnr_vs_ground_truth
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gt, paths, mpath = _phantom_on_disk(tmp, seed)
        say("svr", card_str, phantom_seed=seed, stacks=len(paths),
            setup_s=time.perf_counter() - t0)
        img, n, wall = _svr(tmp, paths, mpath,
                            os.path.join(tmp, "svr.nii.gz"))
        psnr = psnr_vs_ground_truth(gt, img)
        say("svr", card_str, slices=n, psnr_db=psnr, floor_db=PSNR_FLOOR_DB,
            wall_s=wall)
        if not psnr >= PSNR_FLOOR_DB:
            raise PhaseError(f"svr PSNR {psnr:.2f} dB below the floor")

        out = os.path.join(tmp, "pvr.nii.gz")
        t0 = time.perf_counter()
        text = run_cli(pvr_main.main, [
            "-o", out, "-i", *paths, "-m", mpath, "--resolution", "1.0",
            "--iterations", "1", "--patchSize", "32", "--patchStride", "16",
            "--rec_iterations_first", "4", "--rec_iterations_last", "4",
            "--no_log", "--log_prefix", tmp + os.sep])
        wall = time.perf_counter() - t0
        n = int(text.rsplit(" patches)", 1)[0].rsplit("(", 1)[1])
        pimg = read_nifti(out)
        if not np.all(np.isfinite(pimg.data)):
            raise PhaseError("pvr-reconstruct: non-finite volume")
        say("pvr", card_str, patches=n, psnr_db=psnr_vs_ground_truth(gt, pimg),
            wall_s=wall)


def phase_four(card_str, seed):
    """Canonical SVR over four cards, slices and grid meshes, against the
    one-card run on device 0 in the same process.  Two outer iterations:
    the second runs one sharded slice-to-volume registration round, so
    every sharded program of the outer loop runs."""
    import jax
    from tools.bench_full import psnr_vs_ground_truth
    devs = jax.devices()
    if len(devs) != 4:
        raise PhaseError(f"--four needs 4 GPUs, JAX found {len(devs)}")
    with tempfile.TemporaryDirectory() as tmp:
        gt, paths, mpath = _phantom_on_disk(tmp, seed)
        runs = {}
        for mode in ("slices", "grid"):
            img, n, wall = _svr(tmp, paths, mpath,
                                os.path.join(tmp, f"svr_{mode}.nii.gz"),
                                ("--mesh", "4", "--mesh-mode", mode),
                                FOUR_ITERATIONS)
            runs[mode] = img
            say("four", card_str, mesh_mode=mode, devices=4, slices=n,
                psnr_db=psnr_vs_ground_truth(gt, img), wall_s=wall)
        # every card holds a share of the work: no array on device 0 alone
        peaks = device_peaks(devs)
        say("four", card_str, peak_bytes_per_device=peaks)
        if min(peaks) < 0.5 * max(peaks):
            raise PhaseError(f"unbalanced device memory: {peaks}")
        one, n, wall = _svr(tmp, paths, mpath,
                            os.path.join(tmp, "svr_one.nii.gz"),
                            iterations=FOUR_ITERATIONS)
        p1 = psnr_vs_ground_truth(gt, one)
        say("four", card_str, mesh_mode="one_card", devices=1, slices=n,
            psnr_db=p1, wall_s=wall)
        for mode, img in runs.items():
            pm = psnr_vs_ground_truth(gt, img)
            diff = np.abs(img.data - one.data)
            say("four", card_str, mesh_mode=mode,
                max_voxel_diff=float(diff.max()),
                max_voxel_diff_rel=float(diff.max() / np.abs(one.data).max()),
                mean_voxel_diff=float(diff.mean()),
                psnr_delta_db=pm - p1, psnr_tol_db=MESH_PSNR_TOL_DB)
            if not (pm >= PSNR_FLOOR_DB and abs(pm - p1) <= MESH_PSNR_TOL_DB):
                raise PhaseError(f"{mode} mesh PSNR {pm:.2f} dB against "
                                 f"one card {p1:.2f} dB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the phantom's motion")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)

    t0 = time.perf_counter()
    card_str = card()
    import jax
    print(f"card: {card_str}", flush=True)
    print(f"jax {jax.__version__}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    from fetalreconstruction_tpu.utils.compile_cache import \
        configure_compile_cache
    print(f"compile cache: {configure_compile_cache()}", flush=True)

    failed = []

    def phase(name, fn, *a):
        t = time.perf_counter()
        try:
            fn(*a)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        say(name, card_str, phase_wall_s=time.perf_counter() - t,
            ok=name not in failed)

    if not args.four:
        phase("gpu tests", phase_gpu_tests, card_str)
    devs = require_gpu()
    say("device", card_str, platform=devs[0].platform,
        kind=devs[0].device_kind.replace(" ", "_"), count=len(devs),
        setup_s=time.perf_counter() - t0)
    if args.four:
        phase("four", phase_four, card_str, args.seed)
    else:
        phase("kernels", phase_kernels, card_str)
        phase("svr+pvr", phase_svr_pvr, card_str, args.seed)
    say("total", card_str, wall_s=time.perf_counter() - t0,
        failed_phases=failed or None)
    if failed:
        return 1
    print(f"card: {card_str}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
