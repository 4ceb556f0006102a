"""SVR EM/SR core: the jitted per-iteration compute graph.

Orchestrates the PSF engine + EM robust statistics + super-resolution into
the reference's inner loop (reconstruction.cc:817-1237 / SURVEY.md §3.1):

  GaussianReconstruction -> SimulateSlices -> InitializeRobustStatistics ->
  EStep -> { [Bias, Scale,] Superresolution+Regularize, [NormaliseBias,]
             SimulateSlices, MStep, EStep } * rec_iterations

Everything here is functional over jnp arrays; registration lives in
register/ and only feeds new transforms into `slice_forward_matrices`.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import ImageAttributes
from ..em import robust, bias as bias_mod
from ..ops import psf as psf_ops
from ..ops import psf_fast as psf_fast
from ..sr import superresolution as sr
from .state import EMState, SimState, SliceBatch


@dataclasses.dataclass(frozen=True)
class SVRContext:
    """Static (compile-time) reconstruction configuration.

    engine selection: fast=None -> the exact (reference-faithful) offset
    engine (ops/psf.py); fast=FastPSF -> the conv+trilinear engine
    (ops/psf_fast.py), compared against the exact engine in
    tests/test_psf_fast.py.
    """
    vol_shape: Tuple[int, int, int]      # [z, y, x]
    vol_spacing: Tuple[float, float, float]  # (dx, dy, dz) mm
    offsets: np.ndarray                  # (K, 3) PSF support offsets
    slice_spacing_xy: Tuple[float, float]
    sigma_bias: float = 12.0
    global_bias_correction: bool = False
    disable_bias: bool = False
    adaptive: bool = False
    delta: float = 150.0
    low_intensity_cutoff: float = 0.01
    fast: "psf_fast.FastPSF" = None      # static by identity

    def __post_init__(self):
        object.__setattr__(self, "offsets",
                           np.ascontiguousarray(self.offsets, np.int32))

    def __hash__(self):
        return hash((self.vol_shape, self.vol_spacing,
                     self.offsets.tobytes(), self.slice_spacing_xy,
                     self.sigma_bias, self.global_bias_correction,
                     self.disable_bias, self.adaptive, self.delta,
                     self.low_intensity_cutoff, id(self.fast)))

    def __eq__(self, other):
        return isinstance(other, SVRContext) and hash(self) == hash(other)


def slice_forward_matrices(recon_w2i, transforms, slice_i2w):
    """fwd_s = reconW2I @ T_s @ sliceI2W for the whole batch.

    recon_w2i: (4,4); transforms: (N,4,4); slice_i2w: (N,4,4).
    """
    return jnp.einsum("ij,njk,nkl->nil",
                      jnp.asarray(recon_w2i, jnp.float32),
                      jnp.asarray(transforms, jnp.float32),
                      jnp.asarray(slice_i2w, jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("ctx",))
def build_geometry(ctx: SVRContext, recon_w2i, transforms, slice_i2w,
                   slice_dims, valid, mask_flat=None, stack_id=None):
    """Recompute geometry + PSF sums after a transform update
    (replaces the reference's CoeffInit / on-the-fly pass 1).

    mask_flat/stack_id are only used by the fast engine (cached
    conv(mask); per-slice kernel selection)."""
    fwd = slice_forward_matrices(recon_w2i, transforms, slice_i2w)
    if ctx.fast is not None:
        geom = psf_fast.make_fast_geom(ctx.fast, fwd, valid, ctx.vol_shape,
                                       mask_flat, stack_id=stack_id)
        return geom, geom.sume
    geom = psf_ops.make_slice_geom(fwd, slice_dims, valid)
    sume = psf_ops.psf_sums(geom, ctx.offsets, ctx.vol_shape)
    return geom, sume


@partial(jax.jit, static_argnames=("ctx", "axis_name"))
def gaussian_reconstruction(ctx: SVRContext, geom, sume, slices, valid,
                            bias, scale, mask_flat, axis_name=None):
    """Initial PSF-weighted average volume
    (gaussianReconstructionKernel3D_tex + equalizeVol).

    axis_name: slice-sharded mesh axis (inside shard_map) — scatter
    outputs are per-shard partial volumes, combined by psum.
    Returns (recon [z,y,x], vol_weights [z,y,x], voxel_count (N,)).
    """
    psum = (lambda v: jax.lax.psum(v, axis_name)) if axis_name else \
        (lambda v: v)
    if ctx.disable_bias:
        s = slices * scale[:, None, None]
    else:
        s = robust.corrected_slice(slices, bias, scale)
    gate = valid & (sume > 0.0)
    p_val = jnp.where(gate, s, 0.0)
    p_one = jnp.where(gate, 1.0, 0.0)
    mask_vol = mask_flat.reshape(ctx.vol_shape)
    if ctx.fast is not None:
        num, wts = psf_fast.fast_scatter2(ctx.fast, geom, p_val, p_one,
                                          mask_vol, ctx.vol_shape)
        num, wts = psum(num), psum(wts)
        recon = sr.equalize(num, wts)
        _, _, inside = psf_fast.fast_simulate(ctx.fast, geom, num,
                                              mask_vol, ctx.vol_shape)
        return recon, wts, jnp.sum(inside, axis=(1, 2))
    num, wts = psf_ops.psf_scatter(geom, ctx.offsets, sume, [p_val, p_one],
                                   mask_flat, ctx.vol_shape)
    num = psum(num.reshape(ctx.vol_shape))
    wts = psum(wts.reshape(ctx.vol_shape))
    recon = sr.equalize(num, wts)
    # per-slice voxel count: pixels that scattered at least one voxel
    # (sliceVoxel_count, cuda2.cu:291-294) — detected via the gather path
    _, _, inside = psf_ops.psf_gather(geom, ctx.offsets, sume,
                                      num.reshape(-1), mask_flat,
                                      ctx.vol_shape)
    voxel_count = jnp.sum(inside, axis=(1, 2))
    return recon, wts, voxel_count


@partial(jax.jit, static_argnames=("ctx",))
def simulate(ctx: SVRContext, geom, sume, recon, mask_flat):
    """Forward-project the current volume (SimulateSlices)."""
    if ctx.fast is not None:
        sim, simw, inside = psf_fast.fast_simulate(
            ctx.fast, geom, recon, mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        sim, simw, inside = psf_ops.psf_gather(geom, ctx.offsets, sume,
                                               recon.reshape(-1),
                                               mask_flat, ctx.vol_shape)
    slice_inside = jnp.any(inside, axis=(1, 2))
    return SimState(sim=sim, simw=simw, inside=inside,
                    slice_inside=slice_inside)


def init_em_state(n_slices: int, valid) -> EMState:
    """InitializeEMValues (.cc:2955): weights 1 on valid pixels, bias 0,
    scales 1, slice weights 1; robust-stat scalars at reference defaults."""
    return EMState(
        weights=jnp.where(valid, 1.0, 0.0).astype(jnp.float32),
        bias=jnp.zeros(valid.shape, jnp.float32),
        scale=jnp.ones((n_slices,), jnp.float32),
        slice_weight=jnp.ones((n_slices,), jnp.float32),
        sigma2=jnp.asarray(0.0, jnp.float32),
        m=jnp.asarray(0.0, jnp.float32),
        mix=jnp.asarray(0.9, jnp.float32),
        mix_s=jnp.asarray(0.9, jnp.float32))


@partial(jax.jit, static_argnames=("ctx", "axis_name"))
def initialize_robust_statistics(ctx: SVRContext, slices, valid, sim_state,
                                 em: EMState, max_intensity, min_intensity,
                                 excluded, axis_name=None):
    """InitializeRobustStatistics (.cc:3022-3069) + slice-inside zeroing."""
    sigma2, _ = robust.init_robust_stats(slices, valid, sim_state.sim,
                                         sim_state.simw, sim_state.inside,
                                         axis_name=axis_name)
    m = 1.0 / (2.1 * max_intensity - 1.9 * min_intensity)
    slice_weight = jnp.where(sim_state.slice_inside & ~excluded,
                             em.slice_weight, 0.0)
    return em._replace(sigma2=sigma2.astype(jnp.float32),
                       m=m.astype(jnp.float32),
                       mix=jnp.asarray(0.9, jnp.float32),
                       mix_s=jnp.asarray(0.9, jnp.float32),
                       slice_weight=slice_weight)


@partial(jax.jit, static_argnames=("ctx", "axis_name"))
def estep(ctx: SVRContext, slices, valid, sume, sim_state, em: EMState,
          excluded, axis_name=None):
    """Voxel + slice E-step (EStepGPU, .cc:3184-3440).

    excluded: (N,) bool — force-excluded or small slices; scale-based
    exclusion (scale < 0.2 or > 5) is applied here too.
    """
    weights, potential = robust.voxel_estep(
        slices, valid & (sume > 0), em.bias, em.scale, sim_state.sim,
        sim_state.simw, em.sigma2, em.m, em.mix)
    bad_scale = (em.scale < 0.2) | (em.scale > 5.0)
    potential = jnp.where(excluded | bad_scale, -1.0, potential)
    slice_weight, stats = robust.slice_estep(potential, em.slice_weight,
                                             em.mix_s, axis_name=axis_name)
    return em._replace(weights=weights, slice_weight=slice_weight,
                       mix_s=stats["mix_s"]), potential


@partial(jax.jit, static_argnames=("ctx", "iteration", "axis_name"))
def mstep(ctx: SVRContext, slices, valid, sume, sim_state, em: EMState,
          iteration: int, axis_name=None):
    sigma2, mix, m = robust.mstep(
        slices, valid & (sume > 0), em.bias, em.scale, em.weights,
        sim_state.sim, sim_state.simw, iteration, em.mix,
        axis_name=axis_name)
    return em._replace(sigma2=sigma2.astype(jnp.float32),
                       mix=mix.astype(jnp.float32), m=m.astype(jnp.float32))


@partial(jax.jit, static_argnames=("ctx",))
def scale_step(ctx: SVRContext, slices, valid, sume, sim_state, em: EMState):
    scale = robust.scale_step(slices, valid & (sume > 0), em.bias,
                              em.weights, sim_state.sim, sim_state.simw)
    return em._replace(scale=scale)


@partial(jax.jit, static_argnames=("ctx",))
def bias_step(ctx: SVRContext, slices, valid, sume, sim_state, em: EMState):
    b = bias_mod.bias_step(slices, valid & (sume > 0), em.bias, em.scale,
                           em.weights, sim_state.sim, sim_state.simw,
                           ctx.sigma_bias, ctx.slice_spacing_xy,
                           ctx.global_bias_correction)
    return em._replace(bias=b)


@partial(jax.jit, static_argnames=("ctx",))
def superresolution_step(ctx: SVRContext, geom, sume, slices, valid,
                         em: EMState, sim_state, recon, mask_flat,
                         alpha, lambda_, min_intensity, max_intensity):
    """One SR update: scatter residuals, addon step, regularization."""
    if ctx.fast is not None:
        if ctx.disable_bias:
            s = slices * em.scale[:, None, None]
        else:
            s = robust.corrected_slice(slices, em.bias, em.scale)
        resid = jnp.where(sim_state.sim > 0.0, s - sim_state.sim, 0.0)
        wfac = em.weights * em.slice_weight[:, None, None]
        gate = valid & (sume > 0.0)
        addon, cmap = psf_fast.fast_scatter2(
            ctx.fast, geom, jnp.where(gate, resid * wfac, 0.0),
            jnp.where(gate, wfac, 0.0), mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        addon, cmap = sr.sr_accumulate(
            geom, ctx.offsets, sume, slices, valid, em.bias, em.scale,
            em.weights, em.slice_weight, sim_state.sim, mask_flat,
            ctx.vol_shape, ctx.disable_bias)
    original = recon
    recon, cmap = sr.apply_addon(recon, addon, cmap, alpha, min_intensity,
                                 max_intensity, ctx.adaptive)
    recon = sr.adaptive_regularization(recon, original, cmap, alpha,
                                       lambda_, ctx.delta)
    if ctx.global_bias_correction:
        recon = bias_mod.bias_correct_volume(
            recon, original, mask_flat.reshape(ctx.vol_shape),
            min_intensity, max_intensity, ctx.low_intensity_cutoff,
            ctx.sigma_bias, ctx.vol_spacing)
    return recon, cmap


@partial(jax.jit, static_argnames=("ctx", "axis_name"))
def normalise_bias_step(ctx: SVRContext, geom, sume, valid, em: EMState,
                        recon, vol_weights, mask, mask_flat,
                        axis_name=None):
    if ctx.fast is not None:
        logs = jnp.log(jnp.maximum(em.scale, 1e-30))
        b = jnp.where(valid & (em.scale[:, None, None] > 0),
                      em.bias - logs[:, None, None], em.bias)
        payload = jnp.where(valid & (sume > 0), b, 0.0)
        vol_bias, _ = psf_fast.fast_scatter2(
            ctx.fast, geom, payload, jnp.zeros_like(payload),
            mask_flat.reshape(ctx.vol_shape), ctx.vol_shape)
        if axis_name is not None:
            vol_bias = jax.lax.psum(vol_bias, axis_name)
        ok = vol_weights > 0
        vol_bias = jnp.where(ok, vol_bias / jnp.where(ok, vol_weights,
                                                      1.0), 0.0)
        from ..ops.gaussian import gaussian_blur
        m = (mask != 0).astype(recon.dtype)
        vol_bias = jnp.where(mask != 0, vol_bias, 0.0)
        vol_bias = gaussian_blur(vol_bias, ctx.sigma_bias, ctx.vol_spacing)
        m_blur = gaussian_blur(m, ctx.sigma_bias, ctx.vol_spacing)
        vol_bias = jnp.where(m_blur != 0,
                             vol_bias / jnp.where(m_blur != 0, m_blur,
                                                  1.0), 0.0)
        return jnp.where(recon != -1.0, recon / jnp.exp(-vol_bias), recon)
    recon, _ = bias_mod.normalise_bias(
        geom, ctx.offsets, sume, valid, em.bias, em.scale, recon,
        vol_weights, mask, mask_flat, ctx.vol_shape, ctx.sigma_bias,
        ctx.vol_spacing)
    return recon


@partial(jax.jit, static_argnames=("ctx", "do_bias", "do_scale",
                                   "do_normalise_bias", "axis_name"),
         donate_argnums=(5, 6, 7))
def inner_iteration(ctx: SVRContext, geom, sume, slices, valid,
                    em: EMState, sim_state: SimState, recon, vol_weights,
                    mask, mask_flat, excluded, alpha, lam, min_intensity,
                    max_intensity, sr_iteration,
                    do_bias: bool = False, do_scale: bool = True,
                    do_normalise_bias: bool = False, axis_name=None):
    """One fused inner SR/EM iteration (reconstruction.cc:1013-1110):
    [bias], [scale], superresolution+regularize, [normalise bias],
    simulate, M-step, E-step — a single XLA program with donated EM/sim/
    recon buffers.

    axis_name: slice-sharded mesh axis (when traced inside shard_map) —
    scatter outputs become per-shard partial volumes combined by psum,
    and the EM scalar reductions psum their partials; everything
    volume-space (regularization, volume bias) runs replicated.  This is
    the SPMD form of the reference's reduce-to-root + broadcast
    (reconstruction_cuda2.cu:2225-2239, 2368-2373)."""
    gated = valid & (sume > 0)
    if do_bias:
        b = bias_mod.bias_step(slices, gated, em.bias, em.scale,
                               em.weights, sim_state.sim, sim_state.simw,
                               ctx.sigma_bias, ctx.slice_spacing_xy,
                               ctx.global_bias_correction)
        em = em._replace(bias=b)
    if do_scale:
        em = em._replace(scale=robust.scale_step(
            slices, gated, em.bias, em.weights, sim_state.sim,
            sim_state.simw))

    # --- superresolution + regularization
    if ctx.fast is not None:
        if ctx.disable_bias:
            s = slices * em.scale[:, None, None]
        else:
            s = robust.corrected_slice(slices, em.bias, em.scale)
        resid = jnp.where(sim_state.sim > 0.0, s - sim_state.sim, 0.0)
        wfac = em.weights * em.slice_weight[:, None, None]
        addon, cmap = psf_fast.fast_scatter2(
            ctx.fast, geom, jnp.where(gated, resid * wfac, 0.0),
            jnp.where(gated, wfac, 0.0), mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        addon, cmap = sr.sr_accumulate(
            geom, ctx.offsets, sume, slices, valid, em.bias, em.scale,
            em.weights, em.slice_weight, sim_state.sim, mask_flat,
            ctx.vol_shape, ctx.disable_bias)
    if axis_name is not None:
        addon = jax.lax.psum(addon, axis_name)
        cmap = jax.lax.psum(cmap, axis_name)
    original = recon
    recon, cmap = sr.apply_addon(recon, addon, cmap, alpha, min_intensity,
                                 max_intensity, ctx.adaptive)
    recon = sr.adaptive_regularization(recon, original, cmap, alpha, lam,
                                       ctx.delta)
    if ctx.global_bias_correction:
        # BiasCorrectVolume vs the pre-update volume
        # (irtkReconstructionGPU.cc:4107-4108)
        recon = bias_mod.bias_correct_volume(
            recon, original, mask, min_intensity, max_intensity,
            ctx.low_intensity_cutoff, ctx.sigma_bias, ctx.vol_spacing)
    if do_normalise_bias:
        recon = normalise_bias_step.__wrapped__(
            ctx, geom, sume, valid, em, recon, vol_weights, mask,
            mask_flat, axis_name=axis_name)

    # --- simulate + M/E steps
    if ctx.fast is not None:
        sim, simw, inside = psf_fast.fast_simulate(
            ctx.fast, geom, recon, mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        sim, simw, inside = psf_ops.psf_gather(
            geom, ctx.offsets, sume, recon.reshape(-1), mask_flat,
            ctx.vol_shape)
    sim_state = SimState(sim=sim, simw=simw, inside=inside,
                         slice_inside=jnp.any(inside, axis=(1, 2)))
    sigma2, mix, m = robust.mstep(
        slices, gated, em.bias, em.scale, em.weights, sim_state.sim,
        sim_state.simw, sr_iteration, em.mix, axis_name=axis_name)
    em = em._replace(sigma2=sigma2.astype(jnp.float32),
                     mix=mix.astype(jnp.float32), m=m.astype(jnp.float32))
    weights, potential = robust.voxel_estep(
        slices, gated, em.bias, em.scale, sim_state.sim, sim_state.simw,
        em.sigma2, em.m, em.mix)
    bad_scale = (em.scale < 0.2) | (em.scale > 5.0)
    potential = jnp.where(excluded | bad_scale, -1.0, potential)
    slice_weight, stats = robust.slice_estep(potential, em.slice_weight,
                                             em.mix_s, axis_name=axis_name)
    em = em._replace(weights=weights, slice_weight=slice_weight,
                     mix_s=stats["mix_s"])
    return em, sim_state, recon
