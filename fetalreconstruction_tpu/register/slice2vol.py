"""Batched rigid slice-to-volume registration (NCC gradient descent).

JAX reimplementation of the reference GPU registration path
(reconstruction_cuda2.cu):
- registerMultipleSlicesToVolume (:4001-4147): 2 pyramid levels x 4 step
  sizes (0.1 * 2^level mm/deg, halved per step round) x <=20 iterations of
  {6-param central-difference NCC gradient, normalized step, greedy line
  search, backtrack, convergence masking};
- evaluateCostsMultipleSlices (:4150-4230): cost = sum over through-plane
  offsets z in {-2, 0, +2} resampled-voxels of NCC(blur(target),
  blur(generated)), with per-level pixel subsampling (lin % (level+1) == 0);
- genenerateRegistrationSlices (:3565): generated pixel = trilinear sample
  of the volume at the transformed slice raster, kept only if > 0;
- the ResetOrigin trick (irtkReconstructionGPU.cc:2218-2276): optimize
  T' = T @ Mo with the slice origin zeroed so rotations pivot at the slice
  centre; recover T = T' @ Mo^-1.

All slices advance in lock-step with boolean active masks (the reference
compacts indices; masking is the XLA-native equivalent).

Documented deviations from the reference GPU path:
- the reference samples its registration texture at `volumePos/size`
  normalized coords, which shifts sampling by -0.5 voxel on every axis (the
  CPU path has no such shift); we sample at the exact voxel position,
  matching the IRTK CPU convention;
- the reference reuses its un-reset generated-slice buffer across cost
  evaluations (pixels that leave the volume keep stale values); we treat
  them as padding every evaluation.

The registration blur replicates GaussXKernel/GaussYKernel
(GPUGauss/gaussfilter.cu:93-176): padded (-1) pixels stay -1; valid pixels
convolve neighbours clamped to >= 0, no boundary renormalization.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import rigid_matrix_jax
from ..ops.sampling import sample_linear
from .optimizer import (OptimizerConfig, optimize_level,
                        optimize_level_coord)


@dataclasses.dataclass(frozen=True)
class SliceRegConfig:
    """Slice-to-volume registration hyperparameters.

    The DEFAULTS follow the reference's default registration path — the
    CPU GuessParameterSliceToVolume preset
    (irtkImageRigidRegistrationWithPadding.cc:304-377): 3 pyramid levels,
    4 step rounds x 20 iterations, step length 2 * 2^level (mm/deg,
    halved each round), epsilon 1e-4.  The GPU path's fine-step preset
    (prepareSliceToVolumeReg, reconstruction_cuda2.cu:3884-3900: 2
    levels, step 0.1 * 2^level) is reachable with levels=2, step0=0.1 —
    round-3 measurement: its 0.1-0.2 mm/deg steps cannot traverse
    multi-mm/deg motion within the iteration budget, so rotations never
    move (tools/README.md, diag_s2v4/5)."""
    levels: int = 3
    steps: int = 4
    iterations: int = 20
    epsilon: float = 1e-4
    step0: float = 2.0          # _LengthOfSteps[l] = step0 * 2^l
    max_linesearch: int = 16
    through_plane_offsets: Tuple[int, ...] = (-1, 0, 1)  # x2 voxels in z
    # similarity: "ncc" (reference GPU path) or "nmi" (the CPU
    # GuessParameterSliceToVolume(useNMI=true) preset,
    # irtkImageRigidRegistrationWithPadding.cc:304-377 — NMI similarity
    # over a `bins`-bin joint histogram)
    metric: str = "ncc"
    bins: int = 64
    # pyramid: true image pyramid — blur + DECIMATE the pixel grid by
    # 2^level (the reference CPU registration's Initialize(level)
    # downsampling).  False reverts to the round-3 blur-only form with
    # the GPU path's lin%(level+1) subsample.
    pyramid: bool = True
    # optimizer: "coord" (per-DOF Gauss-Seidel sweeps — round-4 default:
    # recovers rotation+translation couplings the reference's
    # normalized-gradient line search measurably stalls on, at the same
    # cost-eval budget; optimizer.optimize_level_coord), "coord-scan"
    # (the same algorithm, but always the fixed-length scanned program —
    # no stepped host loop / no compaction; what mesh paths run inside
    # shard_map, exposed for single-device equality testing), or "gd"
    # (the reference-faithful gradient scheme)
    optimizer: str = "coord"
    # psf_matched: generate registration slices from the per-stack
    # PSF-convolved volume (generate_slices_psf) instead of the raw
    # recon.  MEASURED round-4 (tools/diag_ortho.py + the acceptance
    # scenario): helps the all-slices-moved orthogonal scenario slightly
    # (+0.75 vs +0.61 dB) but REGRESSES the same-geometry acceptance
    # scenario and the half-moved orthogonal one (-1.75 vs -0.55 dB) —
    # the blur flattens the cost landscape more than the model-mismatch
    # removal gains.  Default OFF; kept as a validated-off option.
    psf_matched: bool = False
    # table_dtype: storage precision of the REGISTRATION shingle table
    # (the volume samples feeding NCC/NMI — never the reconstruction
    # itself).  The shingle gather dominates a cost eval and is bound by
    # memory bandwidth, so a bf16 table halves the bytes it reads.
    # bf16's ~0.4% per-sample quantization is far below the acquisition
    # noise the similarity metrics already average over (acceptance
    # scenarios re-validated, tests/test_s2v_*).  "f32" reverts.
    table_dtype: str = "bf16"

    def blur_sigmas(self, recon_dx: float):
        """_Blurring[0] = recon_dx/2, doubled per level (mm)."""
        out = [recon_dx / 2.0]
        for _ in range(1, self.levels):
            out.append(out[-1] * 2.0)
        return out


def _gauss_kernel_taps(sigma_pix: float):
    r = max(int(round(4.0 * sigma_pix)), 1)
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-xs * xs / (2.0 * max(sigma_pix, 1e-6) ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def _shift_edge(x, i: int, axis: int):
    """x shifted so out[j] = x[clip(j + i, 0, n-1)] along `axis` —
    slicing + edge replication instead of an index gather."""
    n = x.shape[axis]
    a = abs(i)
    if a == 0:
        return x
    if i > 0:
        body = jax.lax.slice_in_dim(x, a, n, axis=axis)
        edge = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
        return jnp.concatenate([body, jnp.repeat(edge, a, axis=axis)],
                               axis=axis)
    body = jax.lax.slice_in_dim(x, 0, n - a, axis=axis)
    edge = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    return jnp.concatenate([jnp.repeat(edge, a, axis=axis), body],
                           axis=axis)


def reg_blur(batch, sigma_pix: float):
    """The GPU registration blur: -1 stays -1; valid pixels convolve
    neighbours clamped to >= 0, clamp-to-edge boundary."""
    if sigma_pix <= 0:
        return batch
    k = _gauss_kernel_taps(sigma_pix)
    r = (len(k) - 1) // 2
    out = batch
    for axis in (2, 1):  # x then y (last two axes of (N,H,W))
        acc = out * float(k[r])
        clamped = jnp.maximum(out, 0.0)
        for i in range(1, r + 1):
            acc = acc + float(k[r + i]) * (_shift_edge(clamped, i, axis)
                                           + _shift_edge(clamped, -i,
                                                         axis))
        out = jnp.where(out == -1.0, -1.0, acc)
    return out


def params_to_matrix(params):
    """(N,6) -> (N,4,4), IRTK Euler-degree convention."""
    return rigid_matrix_jax(params)


def matrix_to_params_jax(m):
    """(N,4,4) -> (N,6); batched Matrix2Parameters (degrees)."""
    tx, ty, tz = m[..., 0, 3], m[..., 1, 3], m[..., 2, 3]
    ry = jnp.arcsin(jnp.clip(-m[..., 0, 2], -1.0, 1.0))
    cos_ry = jnp.cos(ry)
    gimbal = jnp.abs(cos_ry) <= 1e-6
    rx = jnp.where(gimbal,
                   jnp.arctan2(-m[..., 0, 2] * m[..., 1, 0],
                               -m[..., 0, 2] * m[..., 2, 0]),
                   jnp.arctan2(m[..., 1, 2], m[..., 2, 2]))
    rz = jnp.where(gimbal, 0.0, jnp.arctan2(m[..., 0, 1], m[..., 0, 0]))
    deg = 180.0 / jnp.pi
    return jnp.stack([tx, ty, tz, rx * deg, ry * deg, rz * deg], axis=-1)


def generate_slices_psf(table, vol_shape, sid, recon_w2i, params, ofs_i2w,
                        shape_hw, insofs):
    """PSF-MATCHED slice generation: sample the slice's own stack's
    convolved volume (corner-major shingle `table`, ops.psf_fast layout)
    instead of the raw reconstruction.

    DOCUMENTED DEVIATION from the reference (which samples the raw
    volume texture, reconstruction_cuda2.cu:3515-3528): the targets are
    PSF-blurred acquisitions, so raw-volume sampling leaves an
    orientation-DEPENDENT forward-model mismatch — with orthogonal
    stacks the mismatch pulls each stack differently and registration
    can drag well-aligned slices off truth (round-4 measurement,
    tools/diag_ortho.py).  Sampling K_s * recon (the simulate tables)
    makes the registration cost consistent with the EM forward model."""
    from ..ops.psf_fast import shingle_gather
    n = params.shape[0]
    h, w = shape_hw
    t = params_to_matrix(params)
    m = jnp.einsum("ij,njk,nkl->nil", recon_w2i, t, ofs_i2w,
                   precision=jax.lax.Precision.HIGHEST)
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    zval = jnp.asarray(insofs, jnp.float32) * 2.0  # traced OK
    pts = (m[:, None, None, :3, 0] * xs[None, None, :, None]
           + m[:, None, None, :3, 1] * ys[None, :, None, None]
           + m[:, None, None, :3, 2] * zval
           + m[:, None, None, :3, 3])
    (vals,) = shingle_gather(table, pts, vol_shape, 1, sid=sid)
    return jnp.where(vals < 0.0, -1.0, vals)


def generate_slices(recon, recon_w2i, params, ofs_i2w, shape_hw, insofs):
    """Sample the volume at the transformed slice raster
    (genenerateRegistrationSlices): pixel (x, y, insofs*2) of the
    origin-zeroed resampled slice grid -> world via ofs_i2w -> T -> volume.

    Returns (N, H, W).  Samples outside the volume read 0 (the reference's
    border-addressed texture) and only NEGATIVE samples become -1 padding
    (genenerateRegistrationSlices `if (val < 0) val = -1`,
    reconstruction_cuda2.cu:3526-3528) — for a non-negative volume every
    generated pixel is therefore valid, so the NCC support is the FIXED
    set of target-valid pixels.  (A content-dependent `> 0` keep rule
    would let slices drift toward high-content regions: NCC over a
    shrinking support rewards overlap loss.)
    """
    n = params.shape[0]
    h, w = shape_hw
    t = params_to_matrix(params)                       # (N,4,4)
    m = jnp.einsum("ij,njk,nkl->nil", recon_w2i, t, ofs_i2w,
                   precision=jax.lax.Precision.HIGHEST)
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    zval = jnp.asarray(insofs, jnp.float32) * 2.0  # traced OK
    pts = (m[:, None, None, :3, 0] * xs[None, None, :, None]
           + m[:, None, None, :3, 1] * ys[None, :, None, None]
           + m[:, None, None, :3, 2] * zval
           + m[:, None, None, :3, 3])
    vals = sample_linear(recon, pts, padding=0.0)
    return jnp.where(vals < 0.0, -1.0, vals)


def _masked_mean(batch):
    """Per-slice mean over pixels > -1 (averageIf)."""
    ok = batch > -1.0
    cnt = jnp.sum(ok, axis=(1, 2))
    s = jnp.sum(jnp.where(ok, batch, 0.0), axis=(1, 2))
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), 0.0), cnt


def _ncc(target, target_mean, source, sub_mask):
    """Per-slice NCC over pixels where both >= 0 (computeNCCAndReduce)."""
    src_mean, _ = _masked_mean(source)
    ok = (target >= 0.0) & (source >= 0.0) & sub_mask[None, :, :]
    a = jnp.where(ok, target - target_mean[:, None, None], 0.0)
    b = jnp.where(ok, source - src_mean[:, None, None], 0.0)
    sab = jnp.sum(a * b, axis=(1, 2))
    saa = jnp.sum(a * a, axis=(1, 2))
    sbb = jnp.sum(b * b, axis=(1, 2))
    norm = saa * sbb
    return jnp.where(norm > 0, sab / jnp.sqrt(jnp.maximum(norm, 1e-30)), 0.0)


def _bin_indices(batch, ok, bins: int):
    """Per-slice rescale of valid intensities to [0, bins-1] int32
    (irtkImageRegistration::Initialize rescales each image to the bin
    range by its own extrema)."""
    big = jnp.float32(3.4e38)
    mx = jnp.max(jnp.where(ok, batch, -big), axis=(1, 2))
    mn = jnp.min(jnp.where(ok, batch, big), axis=(1, 2))
    span = jnp.maximum(mx - mn, 1e-6)[:, None, None]
    t = (batch - mn[:, None, None]) / span * (bins - 1)
    return jnp.clip(t, 0, bins - 1).astype(jnp.int32)


def _nmi_slices(targets, source, sub_mask, bins: int):
    """Per-slice NMI over the valid-pair support (the s2v analog of
    register/volume._nmi_metric)."""
    from .volume import _nmi_metric
    ok = (targets >= 0.0) & (source >= 0.0) & sub_mask[None, :, :]
    t_bin = _bin_indices(targets, ok, bins)
    s_bin = _bin_indices(source, ok, bins)
    return _nmi_metric(t_bin, s_bin, ok, bins)


def make_cost_fn(cfg: SliceRegConfig, recon, recon_w2i, ofs_i2w,
                 targets_blurred, target_means, shape_hw, level: int,
                 sigma_pix: float, psf_table=None, vol_shape=None,
                 sid=None):
    """Build the per-level cost function params (N,6) -> similarity (N,).

    psf_table/vol_shape/sid (optional): PSF-matched sampling — generate
    from the per-stack convolved volumes instead of the raw recon."""
    h, w = shape_hw
    lin = (jnp.arange(h)[:, None] * w + jnp.arange(w)[None, :])
    sub_mask = (lin % (level + 1)) == 0
    use_nmi = getattr(cfg, "metric", "ncc") == "nmi"

    def cost(params):
        # (the through-plane offsets stay UNROLLED; the DOF-level scan
        # in coord_sweep already bounds program size)
        sim = jnp.zeros((params.shape[0],), jnp.float32)
        for insofs in cfg.through_plane_offsets:
            if psf_table is not None:
                gen = generate_slices_psf(psf_table, vol_shape, sid,
                                          recon_w2i, params, ofs_i2w,
                                          shape_hw, insofs)
            else:
                gen = generate_slices(recon, recon_w2i, params, ofs_i2w,
                                      shape_hw, insofs)
            gen = reg_blur(gen, sigma_pix)
            if use_nmi:
                sim = sim + _nmi_slices(targets_blurred, gen, sub_mask,
                                        cfg.bins)
            else:
                sim = sim + _ncc(targets_blurred, target_means, gen,
                                 sub_mask)
        return sim

    return cost


@partial(jax.jit, static_argnames=("dtype",))
def _make_reg_table(recon, dtype: str):
    """Registration shingle table build (+ optional bf16 cast) as ONE
    jitted program (the eager make_shingle chain paid ~7 s of per-op
    first-touch compiles per fresh process)."""
    from ..ops.psf_fast import make_shingle
    t = make_shingle([recon])
    return t.astype(jnp.bfloat16) if dtype == "bf16" else t


def _level_factor(cfg: SliceRegConfig, shape_hw, level: int) -> int:
    """Decimation factor for a pyramid level (shape-only decision)."""
    f = 2 ** level if getattr(cfg, "pyramid", True) else 1
    # minimum-size guard (the reference pyramid stops downsampling small
    # images): decimating tiny targets destroys the cost signal
    while f > 1 and min(shape_hw) // f < 32:
        f //= 2
    return f


@partial(jax.jit, static_argnames=("f", "sigma_pix_full"))
def _level_arrays(f, sigma_pix_full, targets, ofs_i2w):
    """Jitted per-level target prep: blur (+ padding-aware f x f average
    pooling when f > 1) + per-slice masked means — ONE program instead
    of ~35 separately dispatched ops."""
    tgt = reg_blur(targets, sigma_pix_full)
    if f > 1:
        # padding-aware f x f average pooling (the reference resamples
        # with interpolation — a strided pick ALIASES and measurably
        # degraded the acceptance scenario); decimated pixel (x', y')
        # sits at original (f x' + (f-1)/2)
        n, h, w = tgt.shape
        hp, wp = h - h % f, w - w % f
        t2 = tgt[:, :hp, :wp].reshape(n, hp // f, f, wp // f, f)
        ok = t2 > -1.0
        s = jnp.sum(jnp.where(ok, t2, 0.0), axis=(2, 4))
        c = jnp.sum(ok, axis=(2, 4))
        tgt = jnp.where(c > 0, s / jnp.maximum(c, 1), -1.0)
        scale = np.diag([f, f, 1.0, 1.0]).astype(np.float32)
        scale[0, 3] = scale[1, 3] = (f - 1) / 2.0
        ofs_l = jnp.einsum("nij,jk->nik", ofs_i2w, jnp.asarray(scale),
                           precision=jax.lax.Precision.HIGHEST)
    else:
        ofs_l = ofs_i2w
    mean, _ = _masked_mean(tgt)
    return tgt, ofs_l, mean


def _level_data(cfg: SliceRegConfig, targets, ofs_i2w, sigma_pix_full,
                level: int):
    """Per-level target/geometry preparation.

    With cfg.pyramid (default): blur at the level sigma, then DECIMATE
    the pixel grid by 2^level — the reference CPU registration's true
    image pyramid (irtkImageRegistration::Initialize downsamples by
    _Resolution[l]); the round-3 implementation only blurred and kept
    the GPU path's lin%(level+1) subsample.  Decimation cuts level-l
    cost-eval work 4^l x and is what makes coarse levels cheap enough
    for the stepped driver.  ofs_i2w absorbs the pixel scale."""
    f = _level_factor(cfg, targets.shape[1:], level)
    tgt, ofs_l, _ = _level_arrays(f, float(sigma_pix_full), targets,
                                  ofs_i2w)
    if f > 1:
        return tgt, ofs_l, sigma_pix_full / f, 0
    return tgt, ofs_l, sigma_pix_full, \
        (0 if getattr(cfg, "pyramid", True) else level)


@partial(jax.jit, static_argnames=("cfg", "sub_level", "gen_sigma",
                                   "vol_shape"))
def _cost_once(cfg, sub_level, gen_sigma, vol_shape, table, sid,
               recon_w2i, ofs_l, tgt, tgt_mean, params):
    cost = make_cost_fn(cfg, None, recon_w2i, ofs_l, tgt, tgt_mean,
                        tgt.shape[1:], sub_level, gen_sigma,
                        psf_table=table, vol_shape=vol_shape, sid=sid)
    return cost(params)


@partial(jax.jit, static_argnames=("cfg", "sub_level", "gen_sigma",
                                   "vol_shape"))
def _sweep_once(cfg, sub_level, gen_sigma, vol_shape, table, sid,
                recon_w2i, ofs_l, tgt, tgt_mean, params, active, best,
                step):
    from .optimizer import coord_sweep
    cost = make_cost_fn(cfg, None, recon_w2i, ofs_l, tgt, tgt_mean,
                        tgt.shape[1:], sub_level, gen_sigma,
                        psf_table=table, vol_shape=vol_shape, sid=sid)
    params, active, best = coord_sweep(cost, params, active, best, step,
                                       cfg.epsilon)
    return params, active, best, jnp.any(active)


@partial(jax.jit, static_argnames=("bucket",))
def _compact_rows(bucket, sel, *arrays):
    """Gather rows `sel` (padded to a static `bucket` length) from each
    (N, ...) array — the device side of active-set compaction."""
    return tuple(jnp.take(a, sel, axis=0) for a in arrays)


def _bucket_size(k: int, n: int) -> int:
    """Smallest ladder bucket >= k, capped at n.  The ladder is SHORT
    ({16, 128, 1024}): active counts collapse to <= 16 within a few
    sweeps, and every distinct sweep shape is one more program to
    compile — fewer shapes beats marginally tighter batches."""
    for b in (16, 128, 1024):
        if k <= b:
            return min(b, n)
    return n


def _stepped_round(cfg, statics, args, params, best, step, n):
    """One step-size round of the stepped driver with ACTIVE-SET
    COMPACTION (the reference GPU registration compacts its active slice
    indices, reconstruction_cuda2.cu:4030-4075; the round-4 lock-step
    masking evaluated ALL slices every sweep, so a handful of straggler
    slices kept paying the full 168-slice gather; the shingle gather
    dominates a cost eval, so sweep cost must scale with the ACTIVE
    count).

    After each sweep the host reads the active mask; once the active set
    fits a smaller power-of-two bucket, the remaining sweeps run on the
    compacted sub-batch (per-slice costs are independent of batch
    composition, so results are bit-identical to the uncompacted path).
    Returns (params, best) as full-batch arrays.
    """
    import os
    import time as _time
    dbg = os.environ.get("FETALRECON_S2V_DEBUG") == "1"
    t_round = _time.perf_counter()
    sweeps = 0
    psf_table, sid, recon_w2i, ofs_l, tgt, tgt_mean = args
    sel = None                   # np row indices of the working set
    cur_bucket = n
    cur_args = args
    cur = (params, jnp.ones((n,), bool), best)
    full_params = full_best = None  # np full-batch copies (on compaction)
    p = params
    b = best
    for _ in range(cfg.iterations):
        sweeps += 1
        p, a, b, _ = _sweep_once(*statics, *cur_args, *cur, step)
        am = np.asarray(a)[:n if sel is None else len(sel)]
        k = int(am.sum())
        if k == 0:
            break
        bucket = _bucket_size(k, n)
        if bucket < cur_bucket:
            # scatter the working sub-state back into the full copies,
            # then rebuild the working set from the active rows (padded
            # to `bucket` with inactive duplicates of row 0)
            if sel is None:
                # np.asarray of a jax array is a read-only view — copy
                full_params = np.array(p)
                full_best = np.array(b)
            else:
                full_params[sel] = np.asarray(p)[:len(sel)]
                full_best[sel] = np.asarray(b)[:len(sel)]
            prev_rows = np.arange(n) if sel is None else sel
            rows = prev_rows[np.nonzero(am)[0]]
            pad = bucket - len(rows)
            rows_p = np.concatenate([rows, np.repeat(rows[:1], pad)]) \
                if pad else rows
            rows_j = jnp.asarray(rows_p, jnp.int32)
            sub_tgt, sub_mean, sub_ofs = _compact_rows(
                bucket, rows_j, tgt, tgt_mean, ofs_l)
            sub_sid = None if sid is None else jnp.take(sid, rows_j)
            cur_args = (psf_table, sub_sid, recon_w2i, sub_ofs, sub_tgt,
                        sub_mean)
            sub_a = np.zeros(bucket, bool)
            sub_a[:len(rows)] = True
            cur = (jnp.asarray(full_params[rows_p]),
                   jnp.asarray(sub_a), jnp.asarray(full_best[rows_p]))
            sel = rows
            cur_bucket = bucket
        else:
            cur = (p, a, b)
    if dbg:
        print(f"    s2v round: tgt {tuple(tgt.shape)} step "
              f"{float(step):.3g} sweeps {sweeps} final_bucket "
              f"{cur_bucket} wall {_time.perf_counter() - t_round:.2f}s",
              flush=True)
    if sel is None:
        return p, b
    full_params[sel] = np.asarray(p)[:len(sel)]
    full_best[sel] = np.asarray(b)[:len(sel)]
    return jnp.asarray(full_params), jnp.asarray(full_best)


def register_slices_to_volume(cfg: SliceRegConfig, recon, recon_w2i,
                              transforms, mo, ofs_i2w, targets, recon_dx,
                              psf_table=None, vol_shape=None, sid=None):
    """Full batched registration.

    recon: [z,y,x] current volume; recon_w2i: (4,4);
    transforms: (N,4,4) current slice transforms T;
    mo: (N,4,4) origin offset matrices (translation by resampled-slice
        origin); ofs_i2w: (N,4,4) origin-zeroed resampled-slice i2w;
    targets: (N,H,W) resampled slices (-1 padded);
    psf_table/vol_shape/sid (optional): per-stack convolved-volume
        shingle for PSF-matched generation (generate_slices_psf).

    Returns ((N,4,4) updated transforms, (N,) final similarity
    = _slices_regCertainty).
    """
    t_opt = jnp.einsum("nij,njk->nik", transforms, mo,
                       precision=jax.lax.Precision.HIGHEST)
    params = matrix_to_params_jax(t_opt)
    n = targets.shape[0]
    sim = jnp.zeros((n,), jnp.float32)
    sigmas = cfg.blur_sigmas(float(recon_dx))

    # all generation goes through ONE corner-major shingle table: a
    # single width-8 take per sample instead of sample_linear's 8
    # separate element takes (numerically identical)
    import os as _os0
    import time as _time0
    _t0 = _time0.perf_counter()
    dtype = str(getattr(cfg, "table_dtype", "bf16"))
    if psf_table is None:
        psf_table = _make_reg_table(recon, dtype)
        vol_shape = tuple(recon.shape)
        sid = None
    elif dtype == "bf16":
        psf_table = psf_table.astype(jnp.bfloat16)
    if _os0.environ.get("FETALRECON_S2V_DEBUG") == "1":
        psf_table.block_until_ready()
        print(f"    s2v prep: table {_time0.perf_counter() - _t0:.2f}s",
              flush=True)

    # STEPPED driver (host loop of jitted sweeps) outside traces with
    # the coord optimizer: the host loop EARLY-EXITS a step round as
    # soon as no slice improved — semantically identical to the
    # fixed-length scan (inactive sweeps are no-ops) but skips their
    # wasted cost evals, and it compacts the active set between sweeps.
    stepped = (not isinstance(recon_w2i, jax.core.Tracer)
               and not isinstance(targets, jax.core.Tracer)
               and not isinstance(params, jax.core.Tracer)
               and getattr(cfg, "optimizer", "coord") == "coord")

    import os as _os
    import time as _time
    _dbg = _os.environ.get("FETALRECON_S2V_DEBUG") == "1"

    def _mark(tag, t0):
        if _dbg:
            print(f"    s2v prep: {tag} {_time.perf_counter() - t0:.2f}s",
                  flush=True)
        return _time.perf_counter()

    for level in range(cfg.levels - 1, -1, -1):
        sigma_pix = sigmas[level] / float(recon_dx)
        _t = _time.perf_counter()
        f = _level_factor(cfg, targets.shape[1:], level)
        tgt, ofs_l, tgt_mean = _level_arrays(f, float(sigma_pix),
                                             targets, ofs_i2w)
        gen_sigma = sigma_pix / f if f > 1 else sigma_pix
        sub_level = 0 if (f > 1 or getattr(cfg, "pyramid", True)) \
            else level
        if _dbg:
            tgt.block_until_ready()
        _t = _mark(f"level {level} data", _t)
        step0_level = cfg.step0 * (2.0 ** level)
        if stepped:
            statics = (cfg, sub_level, float(gen_sigma), vol_shape)
            args = (psf_table, sid, recon_w2i, ofs_l, tgt, tgt_mean)
            for sr in range(cfg.steps):
                step = jnp.float32(step0_level / 2.0 ** sr)
                # `best` is recomputed at every step round (NOT carried
                # from the previous round's sweeps): the sweep program
                # and the cost program may round differently in the
                # last ulp, and carrying the sweep-computed value was
                # measured to flip accept decisions vs the scanned
                # optimize_level_coord path (test_g2_registration_
                # matches) — exact stepped/scanned equivalence is worth
                # the ~3% extra eval
                best = _cost_once(*statics, *args, params)
                if _dbg and sr == 0:
                    best.block_until_ready()
                    _t = _mark(f"level {level} cost_once", _t)
                params, best = _stepped_round(
                    cfg, statics, args, params, best, step, n)
            sim = best
            continue
        cost = make_cost_fn(cfg, recon, recon_w2i, ofs_l, tgt, tgt_mean,
                            tgt.shape[1:], sub_level, gen_sigma,
                            psf_table=psf_table, vol_shape=vol_shape,
                            sid=sid)
        ocfg = OptimizerConfig(steps=cfg.steps, iterations=cfg.iterations,
                               epsilon=cfg.epsilon,
                               max_linesearch=cfg.max_linesearch)
        opt = optimize_level_coord \
            if getattr(cfg, "optimizer", "coord") in ("coord",
                                                      "coord-scan") \
            else optimize_level
        params, sim = opt(ocfg, cost, params, step0_level)
    t_new = params_to_matrix(params)
    mo_inv = jnp.linalg.inv(mo)
    out = jnp.einsum("nij,njk->nik", t_new, mo_inv,
                     precision=jax.lax.Precision.HIGHEST)
    return out, sim


def build_psf_tables(fast, recon):
    """(8, S*R) corner-major shingle of the normalized per-stack PSF
    blur (K_s * recon) / (K_s * 1) — the generate_slices_psf source.
    Rebuilt per registration round (the recon changed)."""
    from ..ops import psf_fast as pf
    ones = jnp.ones_like(recon)
    tabs = []
    for terms in fast.terms:
        num = pf.conv_separable(recon, terms)
        den = pf.conv_separable(ones, terms)
        tabs.append(pf.make_shingle(
            [jnp.where(den > 1e-6, num / jnp.maximum(den, 1e-6), 0.0)]))
    return jnp.concatenate(tabs, axis=1)


register_slices_to_volume_jit = jax.jit(
    register_slices_to_volume, static_argnames=("cfg",))
