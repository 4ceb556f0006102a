"""Rigid 3D-3D volumetric registration (multi-resolution pyramid, CC/NMI).

Reimplements the IRTK registration stack used by the reference for
stack-to-template and package-to-volume alignment:
- irtkImageRegistration::Run (irtkImageRegistration.cc:414-520): per level
  blur + resample both images, then gradient-descent with step halving;
- irtkImageRigidRegistrationWithPadding::GuessParameterThickSlices /
  ...NMI / GuessParameterSliceToVolume
  (irtkImageRigidRegistrationWithPadding.cc:110-404): 3 levels, 64 bins,
  CC (or NMI) metric, blur sigma = inplane/2 * 2^l, in-plane resolution
  doubled per level (z kept), 20 iterations x 4 steps, step 2 * 2^l;
- similarity on the overlap: target raster voxels != padding whose
  transformed position samples the source without padding
  (irtkImageRigidRegistrationWithPadding::Evaluate);
- CC = (Sxy - Sx Sy/n) / sqrt((Sxx - Sx^2/n)(Syy - Sy^2/n)) (the
  irtkCrossCorrelationSimilarityMetric accumulator form);
- NMI = (H(target) + H(source)) / H(target, source) from a 64x64 joint
  histogram of intensities rescaled per level.

The optimizer itself is the shared batched engine (optimizer.py) — a batch
of independent targets (stacks, packages) registers in lock-step.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import ImageAttributes, rigid_matrix_jax
from ..core.image import Image
from ..ops.gaussian import gaussian_blur_padded
from ..ops.sampling import resample_to_grid, sample_linear_padded
from .optimizer import OptimizerConfig, optimize_level
from .slice2vol import matrix_to_params_jax


@dataclasses.dataclass(frozen=True)
class VolRegConfig:
    levels: int = 3
    bins: int = 64
    metric: str = "cc"           # "cc" | "nmi"
    iterations: int = 20
    steps: int = 4
    step0: float = 2.0           # _LengthOfSteps[l] = 2 * 2^l
    epsilon: float = 1e-4
    max_linesearch: int = 16
    blur_z: bool = False         # thick-slice presets keep z resolution
    source_iso: bool = False     # SliceToVolume preset: source resampled
                                 # isotropic and doubled per level in z too
    # optimizer: "coord" (per-DOF sweeps, the round-4 default) or
    # "coord+gd" — coord then a normalized-gradient line-search POLISH
    # per level (the reference's irtkGradientDescentOptimizer scheme).
    # Round-5 measurement (tools/diag_package3.py): coord alone stalls
    # at per-DOF local optima on package registration (a rotation error
    # with compensating translation needs a COUPLED move); the gd polish
    # escapes them at small cost.
    optimizer: str = "coord"
    gd_steps: int = 2            # polish step-halving rounds
    gd_iterations: int = 8       # polish iterations per round


def guess_padding(data: np.ndarray) -> float:
    """Corner-based padding guess
    (irtkImageRigidRegistrationWithPadding.cc:380-403): if all 8 corners
    share one value, that value is padding; else -32768 (MIN_GREY)."""
    corners = [data[z, y, x] for z in (0, -1) for y in (0, -1)
               for x in (0, -1)]
    if all(c == corners[0] for c in corners):
        return float(corners[0])
    return -32768.0


def _pyramid_level(img: Image, level: int, padding: float,
                   blur_z: bool, iso: bool = False) -> Image:
    """Blur + resample one level (irtkImageRegistration::Initialize(level)).

    Level 0 uses blur sigma = inplane/2 and resolution = (inplane, inplane,
    dz); each further level doubles blur and in-plane resolution.  With
    iso=True (GuessParameterSliceToVolume source preset) the level-0
    resolution is min(dx, dy, dz) isotropic and z doubles per level too.
    """
    a = img.attr
    size = min(a.dx, a.dy, a.dz) if iso else min(a.dx, a.dy)
    sigma = (size / 2.0) * (2.0 ** level)
    res = size * (2.0 ** level)
    data = jnp.asarray(img.data)
    data = gaussian_blur_padded(data, sigma,
                                (a.dx, a.dy, a.dz if blur_z else 1e30),
                                padding=padding)
    dst = a.with_spacing(res, res, res if iso else a.dz)
    out = resample_to_grid(data, jnp.asarray(a.w2i(), jnp.float32),
                           dst.shape_zyx, jnp.asarray(dst.i2w(), jnp.float32),
                           interp="linear", source_padding=padding)
    return Image(np.asarray(out), dst)


def _cc_metric(t, s, ok):
    n = jnp.sum(ok, axis=tuple(range(1, t.ndim)))
    tv = jnp.where(ok, t, 0.0)
    sv = jnp.where(ok, s, 0.0)
    sx = jnp.sum(tv, axis=tuple(range(1, t.ndim)))
    sy = jnp.sum(sv, axis=tuple(range(1, t.ndim)))
    sxy = jnp.sum(tv * sv, axis=tuple(range(1, t.ndim)))
    sxx = jnp.sum(tv * tv, axis=tuple(range(1, t.ndim)))
    syy = jnp.sum(sv * sv, axis=tuple(range(1, t.ndim)))
    nn = jnp.maximum(n, 1)
    num = sxy - sx * sy / nn
    den = (sxx - sx * sx / nn) * (syy - sy * sy / nn)
    return jnp.where(den > 0, num / jnp.sqrt(jnp.maximum(den, 1e-30)), 0.0)


def _nmi_metric(t_bin, s_bin, ok, bins: int):
    """NMI from a joint histogram of pre-binned intensities.

    t_bin/s_bin: int32 bin indices; ok: valid-pair mask.
    """
    batch = t_bin.shape[0]
    flatt = t_bin.reshape(batch, -1)
    flats = s_bin.reshape(batch, -1)
    okf = ok.reshape(batch, -1)
    lin = jnp.where(okf, flatt * bins + flats, bins * bins)

    def hist_one(linrow):
        h = jnp.zeros((bins * bins + 1,), jnp.float32)
        h = h.at[linrow].add(1.0)
        return h[:bins * bins].reshape(bins, bins)

    joint = jax.vmap(hist_one)(lin)
    n = jnp.maximum(jnp.sum(joint, axis=(1, 2)), 1.0)
    p = joint / n[:, None, None]
    px = jnp.sum(p, axis=2)
    py = jnp.sum(p, axis=1)

    def ent(q, axes):
        return -jnp.sum(jnp.where(q > 0, q * jnp.log(jnp.maximum(q, 1e-30)),
                                  0.0), axis=axes)

    hx = ent(px, (1,))
    hy = ent(py, (1,))
    hxy = ent(p, (1, 2))
    return jnp.where(hxy > 0, (hx + hy) / jnp.maximum(hxy, 1e-30), 0.0)


def _rescale_for_bins(data, padding, bins):
    """Rescale valid intensities to [0, bins-1] (irtkImageRegistration
    Initialize rescales to _NumberOfBins)."""
    ok = data > padding
    lo = jnp.min(jnp.where(ok, data, jnp.inf))
    hi = jnp.max(jnp.where(ok, data, -jnp.inf))
    rng = jnp.maximum(hi - lo, 1e-6)
    scaled = (data - lo) / rng * (bins - 1)
    return jnp.where(ok, scaled, -1.0)


def _vol_cost_body(metric, bins, tdata, sdata, tgt_i2w, src_w2i, tpad,
                   spad, params):
    """Similarity of source(T(x)) vs target over the target raster."""
    zs, ys, xs = tdata.shape
    gx = jnp.arange(xs, dtype=jnp.float32)
    gy = jnp.arange(ys, dtype=jnp.float32)
    gz = jnp.arange(zs, dtype=jnp.float32)
    t = rigid_matrix_jax(params)
    m = jnp.einsum("ij,njk,kl->nil", src_w2i, t, tgt_i2w,
                   precision=jax.lax.Precision.HIGHEST)
    pts = (m[:, None, None, None, :3, 0] * gx[None, None, None, :, None]
           + m[:, None, None, None, :3, 1] * gy[None, None, :, None, None]
           + m[:, None, None, None, :3, 2] * gz[None, :, None, None, None]
           + m[:, None, None, None, :3, 3])
    sv = jax.vmap(lambda p: sample_linear_padded(sdata, p,
                                                 padding=spad))(pts)
    tb = jnp.broadcast_to(tdata[None], sv.shape)
    ok = (tb > tpad) & (sv > spad)
    if metric == "nmi":
        tbin = jnp.clip(tb, 0, bins - 1).astype(jnp.int32)
        sbin = jnp.clip(sv, 0, bins - 1).astype(jnp.int32)
        return _nmi_metric(tbin, sbin, ok, bins)
    return _cc_metric(tb, sv, ok)


@partial(jax.jit, static_argnames=("metric", "bins"))
def _vol_cost_jit(metric, bins, tdata, sdata, tgt_i2w, src_w2i, tpad,
                  spad, params):
    return _vol_cost_body(metric, bins, tdata, sdata, tgt_i2w, src_w2i,
                          tpad, spad, params)


@partial(jax.jit, static_argnames=("metric", "bins", "epsilon"))
def _vol_sweep_jit(metric, bins, epsilon, tdata, sdata, tgt_i2w, src_w2i,
                   tpad, spad, params, active, best, step):
    from .optimizer import coord_sweep

    def cost(p):
        return _vol_cost_body(metric, bins, tdata, sdata, tgt_i2w,
                              src_w2i, tpad, spad, p)

    params, active, best = coord_sweep(cost, params, active, best, step,
                                       epsilon)
    return params, active, best, jnp.any(active)


def _vol_cost_body_b(metric, bins, shared_src, tdata, sdata, tgt_i2w,
                     src_w2i, tpad, spad, params):
    """BATCHED pair similarity: M independent (target, source) problems in
    lock-step (the analog of ParallelStackRegistrations,
    irtkReconstructionGPU.cc:849-938 — the reference fans the problems
    over TBB threads; here they are one vmapped program).

    tdata: (M, z, y, x) targets padded to a common shape with each pair's
    own padding value (padded voxels drop out of the `ok` mask exactly
    like genuine padding); sdata: (M, ...) sources, or (1, ...) with
    shared_src=True (package registration: every package registers
    against the SAME reconstruction — broadcasting avoids materializing M
    copies); tgt_i2w/src_w2i: (M, 4, 4); tpad/spad: (M,); params: (M, 6).
    """
    zs, ys, xs = tdata.shape[1:]
    gx = jnp.arange(xs, dtype=jnp.float32)
    gy = jnp.arange(ys, dtype=jnp.float32)
    gz = jnp.arange(zs, dtype=jnp.float32)
    t = rigid_matrix_jax(params)
    m = jnp.einsum("nij,njk,nkl->nil", src_w2i, t, tgt_i2w,
                   precision=jax.lax.Precision.HIGHEST)
    pts = (m[:, None, None, None, :3, 0] * gx[None, None, None, :, None]
           + m[:, None, None, None, :3, 1] * gy[None, None, :, None, None]
           + m[:, None, None, None, :3, 2] * gz[None, :, None, None, None]
           + m[:, None, None, None, :3, 3])
    if shared_src:
        sv = jax.vmap(sample_linear_padded, in_axes=(None, 0, 0))(
            sdata[0], pts, spad)
    else:
        sv = jax.vmap(sample_linear_padded, in_axes=(0, 0, 0))(
            sdata, pts, spad)
    ok = ((tdata > tpad[:, None, None, None])
          & (sv > spad[:, None, None, None]))
    if metric == "nmi":
        tbin = jnp.clip(tdata, 0, bins - 1).astype(jnp.int32)
        sbin = jnp.clip(sv, 0, bins - 1).astype(jnp.int32)
        return _nmi_metric(tbin, sbin, ok, bins)
    return _cc_metric(tdata, sv, ok)


@partial(jax.jit, static_argnames=("metric", "bins", "shared_src"))
def _vol_cost_b_jit(metric, bins, shared_src, tdata, sdata, tgt_i2w,
                    src_w2i, tpad, spad, params):
    return _vol_cost_body_b(metric, bins, shared_src, tdata, sdata,
                            tgt_i2w, src_w2i, tpad, spad, params)


@partial(jax.jit, static_argnames=("metric", "bins", "shared_src",
                                   "epsilon"))
def _vol_sweep_b_jit(metric, bins, shared_src, epsilon, tdata, sdata,
                     tgt_i2w, src_w2i, tpad, spad, params, active, best,
                     step):
    from .optimizer import coord_sweep

    def cost(p):
        return _vol_cost_body_b(metric, bins, shared_src, tdata, sdata,
                                tgt_i2w, src_w2i, tpad, spad, p)

    params, active, best = coord_sweep(cost, params, active, best, step,
                                       epsilon)
    return params, active, best, jnp.any(active)


@partial(jax.jit, static_argnames=("metric", "bins", "shared_src",
                                   "steps", "iterations", "epsilon",
                                   "max_linesearch"))
def _vol_gd_b_jit(metric, bins, shared_src, steps, iterations, epsilon,
                  max_linesearch, tdata, sdata, tgt_i2w, src_w2i, tpad,
                  spad, params, step0):
    """Batched gradient-descent polish: the reference's
    irtkGradientDescentOptimizer scheme (normalized 6-vector central
    difference + greedy line search) run as one fixed-length scanned
    program from the coord result."""
    from .optimizer import OptimizerConfig, optimize_level

    def cost(p):
        return _vol_cost_body_b(metric, bins, shared_src, tdata, sdata,
                                tgt_i2w, src_w2i, tpad, spad, p)

    ocfg = OptimizerConfig(steps=steps, iterations=iterations,
                           epsilon=epsilon,
                           max_linesearch=max_linesearch)
    return optimize_level(ocfg, cost, params, step0)


def _pad_batch(vols: List[np.ndarray], pads: List[float]) -> np.ndarray:
    """Stack differently-shaped volumes into (M, z, y, x), padding each
    at the high end with ITS OWN padding value (pad voxels then behave
    exactly like genuine padding: sample_linear_padded drops pad-valued
    corners and the `ok` masks exclude pad-valued raster voxels)."""
    zs = max(v.shape[0] for v in vols)
    ys = max(v.shape[1] for v in vols)
    xs = max(v.shape[2] for v in vols)
    out = np.empty((len(vols), zs, ys, xs), np.float32)
    for i, (v, p) in enumerate(zip(vols, pads)):
        out[i] = p
        out[i, :v.shape[0], :v.shape[1], :v.shape[2]] = v
    return out


def register_volumes_batched(cfg: VolRegConfig, targets: List[Image],
                             sources: List[Image],
                             init_matrices: Optional[np.ndarray] = None,
                             target_paddings: Optional[List[float]] = None,
                             source_paddings: Optional[List[float]] = None):
    """Register M independent rigid pairs in LOCK-STEP: pair i finds T_i
    with targets[i](x) ~ sources[i](T_i(x)).

    The serial `register_volumes` runs the stepped sweep schedule for ONE
    pair at a time, so stacks/packages multiply wall-clock linearly; this
    runs every pair through the same batched coord-descent sweeps the
    slice registration uses (each jitted sweep advances all M problems;
    converged pairs deactivate individually, the host loop exits a step
    round when ALL are done).  Matches ParallelStackRegistrations
    (irtkReconstructionGPU.cc:849-938) and the package fan-out
    (irtkReconstructionGPU.cc:5096-5190).

    sources may be the SAME Image object for every pair (package mode) —
    detected and broadcast instead of copied.

    Numerics note: each pair's cost is computed over its own grid exactly
    as in the serial path (padding excludes the batch fill), but batched
    reductions may round differently at the last ulp, so accept decisions
    can differ on razor-thin improvements; quality is equivalent (tested
    in tests/test_volume_batched.py).

    Returns ((M, 4, 4) matrices, (M,) final similarity).
    """
    m_pairs = len(targets)
    assert len(sources) == m_pairs
    tps = [guess_padding(t.data) if target_paddings is None
           or target_paddings[i] is None else target_paddings[i]
           for i, t in enumerate(targets)]
    sps = [guess_padding(s.data) if source_paddings is None
           or source_paddings[i] is None else source_paddings[i]
           for i, s in enumerate(sources)]
    shared_src = all(s is sources[0] for s in sources)

    # ResetOrigin per pair
    mos = np.tile(np.eye(4), (m_pairs, 1, 1))
    targets0 = []
    for i, tgt in enumerate(targets):
        a = tgt.attr.copy()
        mos[i, :3, 3] = [a.xorigin, a.yorigin, a.zorigin]
        a.xorigin = a.yorigin = a.zorigin = 0.0
        targets0.append(Image(tgt.data, a))

    init = np.tile(np.eye(4), (m_pairs, 1, 1)) if init_matrices is None \
        else np.asarray(init_matrices)
    params = matrix_to_params_jax(jnp.asarray(
        np.einsum("nij,njk->nik", init, mos), jnp.float32))

    shared_tgt = all(t is targets[0] for t in targets)
    sim = jnp.zeros((m_pairs,), jnp.float32)
    for level in range(cfg.levels - 1, -1, -1):
        if shared_tgt:
            tl0 = _pyramid_level(targets0[0], level, tps[0], cfg.blur_z)
            tls = [tl0] * m_pairs
        else:
            tls = [_pyramid_level(t, level, tp, cfg.blur_z)
                   for t, tp in zip(targets0, tps)]
        if shared_src:
            sls = [_pyramid_level(sources[0], level, sps[0], cfg.blur_z,
                                  iso=cfg.source_iso)]
        else:
            sls = [_pyramid_level(s, level, sp, cfg.blur_z,
                                  iso=cfg.source_iso)
                   for s, sp in zip(sources, sps)]
        # per-pair degenerate-level guard (see register_volumes): pairs
        # whose coarse target keeps almost no valid voxels sit this level
        # out (their params frozen via the active mask)
        level_ok = np.asarray(
            [int(np.sum(np.asarray(tl.data) > tp)) >= 200
             for tl, tp in zip(tls, tps)])
        if not level_ok.any():
            continue
        tdatas = [jnp.asarray(tl.data) for tl in tls]
        sdatas = [jnp.asarray(sl.data) for sl in sls]
        if cfg.metric == "nmi":
            tdatas = [_rescale_for_bins(d, tp, cfg.bins)
                      for d, tp in zip(tdatas, tps)]
            sdatas = [_rescale_for_bins(d, sp, cfg.bins)
                      for d, sp in zip(sdatas, sps)]
            tpad = [-1.0] * m_pairs
            spad = [-1.0] * m_pairs
        else:
            tpad, spad = list(tps), list(sps)
        tdata = jnp.asarray(_pad_batch(
            [np.asarray(d) for d in tdatas], tpad))
        sdata = jnp.asarray(_pad_batch(
            [np.asarray(d) for d in sdatas],
            spad[:1] if shared_src else spad))
        tgt_i2w = jnp.asarray(np.stack(
            [tl.attr.i2w() for tl in tls]), jnp.float32)
        if shared_src:
            src_w2i = jnp.asarray(np.tile(
                sls[0].attr.w2i()[None], (m_pairs, 1, 1)), jnp.float32)
        else:
            src_w2i = jnp.asarray(np.stack(
                [sl.attr.w2i() for sl in sls]), jnp.float32)
        tpad_a = jnp.asarray(tpad, jnp.float32)
        spad_a = jnp.asarray(spad, jnp.float32)
        ok_a = jnp.asarray(level_ok)

        for sr in range(cfg.steps):
            step = jnp.float32(cfg.step0 * (2.0 ** level) / (2.0 ** sr))
            best = _vol_cost_b_jit(cfg.metric, cfg.bins, shared_src,
                                   tdata, sdata, tgt_i2w, src_w2i,
                                   tpad_a, spad_a, params)
            active = ok_a
            for _ in range(cfg.iterations):
                params, active, best, any_active = _vol_sweep_b_jit(
                    cfg.metric, cfg.bins, shared_src, cfg.epsilon,
                    tdata, sdata, tgt_i2w, src_w2i, tpad_a, spad_a,
                    params, active, best, step)
                if not bool(any_active):
                    break
        if cfg.optimizer.endswith("gd"):
            p_gd, best_gd = _vol_gd_b_jit(
                cfg.metric, cfg.bins, shared_src, cfg.gd_steps,
                cfg.gd_iterations, cfg.epsilon, cfg.max_linesearch,
                tdata, sdata, tgt_i2w, src_w2i, tpad_a, spad_a, params,
                jnp.float32(cfg.step0 * (2.0 ** level) / 2.0))
            take = ok_a & (best_gd >= best)
            params = jnp.where(take[:, None], p_gd, params)
            best = jnp.where(take, best_gd, best)
        sim = jnp.where(ok_a, best, sim)

    t_new = np.asarray(rigid_matrix_jax(params)).astype(np.float64)
    out = np.einsum("nij,njk->nik", t_new,
                    np.linalg.inv(mos))
    return out, np.asarray(sim)


def register_volumes(cfg: VolRegConfig, target: Image, source: Image,
                     init_matrix: Optional[np.ndarray] = None,
                     target_padding: Optional[float] = None,
                     source_padding: Optional[float] = None):
    """Register source to target: find rigid T with target(x) ~
    source(T(x)) (IRTK convention: T maps target world -> source world).

    Returns (4x4 matrix, final similarity).
    """
    tp = guess_padding(target.data) if target_padding is None \
        else target_padding
    sp = guess_padding(source.data) if source_padding is None \
        else source_padding

    # ResetOrigin trick (StackRegistrations, irtkReconstructionGPU.cc:987):
    # optimize with the target origin folded into the transform.
    t_attr = target.attr.copy()
    ox, oy, oz = t_attr.xorigin, t_attr.yorigin, t_attr.zorigin
    t_attr.xorigin = t_attr.yorigin = t_attr.zorigin = 0.0
    mo = np.eye(4)
    mo[:3, 3] = [ox, oy, oz]
    target0 = Image(target.data, t_attr)

    init = np.eye(4) if init_matrix is None else np.asarray(init_matrix)
    params = matrix_to_params_jax(
        jnp.asarray((init @ mo)[None], jnp.float32))

    sim = jnp.zeros((1,), jnp.float32)
    for level in range(cfg.levels - 1, -1, -1):
        tl = _pyramid_level(target0, level, tp, cfg.blur_z)
        sl = _pyramid_level(source, level, sp, cfg.blur_z,
                            iso=cfg.source_iso)
        # degenerate-level guard: a coarse level whose (possibly
        # mask-zeroed) target keeps only a handful of valid voxels gives a
        # meaningless similarity and lets the 2*2^level-mm step schedule
        # walk arbitrarily far (observed: 21 mm divergence on a small test
        # phantom).  The reference never hits this because its clinical
        # stacks are >= 72^2 x 21 voxels at the coarsest level; skip such
        # levels instead of optimizing noise.
        if int(np.sum(np.asarray(tl.data) > tp)) < 200:
            continue
        tdata = jnp.asarray(tl.data)
        sdata = jnp.asarray(sl.data)
        if cfg.metric == "nmi":
            tdata = _rescale_for_bins(tdata, tp, cfg.bins)
            sdata = _rescale_for_bins(sdata, sp, cfg.bins)
            tpad, spad = -1.0, -1.0
        else:
            tpad, spad = tp, sp
        tgt_i2w = jnp.asarray(tl.attr.i2w(), jnp.float32)
        src_w2i = jnp.asarray(sl.attr.w2i(), jnp.float32)
        zs, ys, xs = tl.attr.shape_zyx
        gx = jnp.arange(xs, dtype=jnp.float32)
        gy = jnp.arange(ys, dtype=jnp.float32)
        gz = jnp.arange(zs, dtype=jnp.float32)

        # STEPPED execution (round 4): module-level jitted sweeps with
        # every array as an ARGUMENT.  The former per-call jax.jit(cost)
        # CLOSED OVER the level volumes — each dataset produced a
        # different HLO (data baked in as constants), so nothing ever
        # hit the persistent compile cache and stack registration
        # recompiled its whole schedule every run.  With data as
        # arguments the programs cache by SHAPE, and the host loop
        # early-exits converged step rounds.
        for sr in range(cfg.steps):
            step = jnp.float32(cfg.step0 * (2.0 ** level) / (2.0 ** sr))
            best = _vol_cost_jit(cfg.metric, cfg.bins, tdata, sdata,
                                 tgt_i2w, src_w2i,
                                 jnp.float32(tpad), jnp.float32(spad),
                                 params)
            active = jnp.ones((1,), bool)
            for _ in range(cfg.iterations):
                params, active, best, any_active = _vol_sweep_jit(
                    cfg.metric, cfg.bins, cfg.epsilon, tdata, sdata,
                    tgt_i2w, src_w2i, jnp.float32(tpad),
                    jnp.float32(spad), params, active, best, step)
                if not bool(any_active):
                    break
        if cfg.optimizer.endswith("gd"):
            p_gd, best_gd = _vol_gd_b_jit(
                cfg.metric, cfg.bins, False, cfg.gd_steps,
                cfg.gd_iterations, cfg.epsilon, cfg.max_linesearch,
                tdata[None], sdata[None], tgt_i2w[None], src_w2i[None],
                jnp.full((1,), tpad, jnp.float32),
                jnp.full((1,), spad, jnp.float32), params,
                jnp.float32(cfg.step0 * (2.0 ** level) / 2.0))
            take = best_gd >= best
            params = jnp.where(take[:, None], p_gd, params)
            best = jnp.where(take, best_gd, best)
        sim = best

    t_new = np.asarray(rigid_matrix_jax(params))[0].astype(np.float64)
    out = t_new @ np.linalg.inv(mo)
    return out, float(sim[0])
