"""2-D mesh execution: slice-DP x volume z-slab sharding composed.

A large share of the inner SR/EM iteration is VOLUME-space work
(scatter accumulate, adjoint convs, regularizer, simulate convs) that the
1-D slice-DP mode replicates on every device, which caps its scaling
efficiency.  This module shards BOTH:

    mesh = Mesh(devices.reshape(S, V), ("slices", "vol_z"))

- the slice batch is sharded over the `slices` axis (as in
  parallel/sharded.py): per-slice arrays, EM state, geometry xp/sume/den;
- ALL volume-space state — recon, mask, addon/cmap, vol weights, the
  per-stack conv(1)/conv(mask) slabs at build — is sharded into z-slabs
  over the `vol_z` axis (as in parallel/volume_sharded.py), REPLICATED
  across the `slices` rows;
- scatter: each device ownership-scatters its LOCAL slice shard into its
  LOCAL z-slab, then one psum over `slices` completes the slab
  accumulator (the conv adjoint runs on the local partial first, so the
  psum moves only the 2 payload slabs);
- gather (simulate / sume / den): slab-local partial trilinear sums,
  psum over `vol_z` -> per-pixel values for the local slice shard;
- the separable convolutions / regularizer / NormaliseBias blur exchange
  z-halos with ppermute over `vol_z` (multi-hop for wide kernels);
- EM scalar reductions psum over `slices` (every vol_z column computes
  identical statistics).

This is a composition the reference's multi-GPU runtime
never had (it replicated the volume per GPU and reduced to device 0,
reconstruction_cuda2.cu:2225-2239); equality with the single-device fast
engine is asserted on 4x2 and 2x4 CPU meshes in tests/test_mesh2d.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..em import robust, bias as bias_mod
from ..ops import psf_fast as pf
from ..pipeline import svr_core
from ..pipeline.state import EMState, SimState
from ..sr import superresolution as sr
from . import volume_sharded as vs

AXIS_S = "slices"
AXIS_V = "vol_z"


def make_mesh2d(n_slices_axis: int, n_vol_axis: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    devs = np.asarray(devices)[:n_slices_axis * n_vol_axis]
    return Mesh(devs.reshape(n_slices_axis, n_vol_axis), (AXIS_S, AXIS_V))


def grid_shape(n_devices: int):
    """Default (slices, vol_z) factorization: near-square, slices-major
    (slice-DP shards the larger fraction of the work at SVR scale)."""
    v = 1
    for cand in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            v = cand
            break
    return n_devices // v, v


def _smap(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


# PartitionSpecs: per-slice arrays shard over AXIS_S; volume slabs over
# AXIS_V (leading z axis); scalars replicated.
SLICE = P(AXIS_S)
SLAB = P(AXIS_V)
GEOM_SPEC = vs.VSGeom(xp=SLICE, valid=SLICE, sume=SLICE, sid=SLICE,
                      den=SLICE)
EM_SPEC = EMState(weights=SLICE, bias=SLICE, scale=SLICE,
                  slice_weight=SLICE, sigma2=P(), m=P(), mix=P(), mix_s=P())
SIM_SPEC = SimState(sim=SLICE, simw=SLICE, inside=SLICE,
                    slice_inside=SLICE)


def _ctx_check(ctx):
    if ctx.fast is None:
        raise NotImplementedError("the 2D mesh requires the fast engine")


def g2_build_geometry_fn(ctx, mesh: Mesh):
    """f(recon_w2i, transforms, slice_i2w, valid, mask_slab, stack_id)
    -> VSGeom with xp/valid/sume/sid/den sharded over `slices`.

    The conv(1)/conv(mask) slabs are computed once per vol_z column
    (identical across slices rows) and reduced into the per-pixel sume /
    den of the LOCAL slice shard by the psum("vol_z") gather."""
    _ctx_check(ctx)

    def body(recon_w2i, transforms, slice_i2w, valid, mask_slab,
             stack_id):
        fwd = svr_core.slice_forward_matrices(recon_w2i, transforms,
                                              slice_i2w)
        return vs.vs_build_geometry(ctx.fast, fwd, valid, ctx.vol_shape,
                                    mask_slab, stack_id, AXIS_V)

    return jax.jit(_smap(
        body, mesh,
        in_specs=(P(), SLICE, SLICE, SLICE, SLAB, SLICE),
        out_specs=GEOM_SPEC))


def _g2_scatter(ctx, geom, pay_a, pay_b, mask_slab):
    """Slab scatter of the LOCAL slice shard + psum over `slices`."""
    a, b = vs.vs_fast_scatter2(ctx.fast, geom, pay_a, pay_b, mask_slab,
                               ctx.vol_shape, AXIS_V)
    ab = jax.lax.psum(jnp.stack([a, b]), AXIS_S)
    return ab[0], ab[1]


def g2_gaussian_reconstruction_fn(ctx, mesh: Mesh):
    """f(slices, valid, geom, bias, scale, mask_slab)
    -> (recon_slab, vol_weights_slab, voxel_count (N,))."""
    _ctx_check(ctx)

    def body(slices, valid, geom, bias, scale, mask_slab):
        s = slices * scale[:, None, None] if ctx.disable_bias else \
            robust.corrected_slice(slices, bias, scale)
        gate = valid & (geom.sume > 0.0)
        num, wts = _g2_scatter(ctx, geom, jnp.where(gate, s, 0.0),
                               jnp.where(gate, 1.0, 0.0), mask_slab)
        recon = sr.equalize(num, wts)
        _, _, inside = vs.vs_fast_simulate(ctx.fast, geom, num, mask_slab,
                                           ctx.vol_shape, AXIS_V)
        return recon, wts, jnp.sum(inside, axis=(1, 2))

    return jax.jit(_smap(
        body, mesh,
        in_specs=(SLICE, SLICE, GEOM_SPEC, SLICE, SLICE, SLAB),
        out_specs=(SLAB, SLAB, SLICE)))


def g2_simulate_fn(ctx, mesh: Mesh):
    _ctx_check(ctx)

    def body(geom, recon_slab, mask_slab):
        sim, simw, inside = vs.vs_fast_simulate(
            ctx.fast, geom, recon_slab, mask_slab, ctx.vol_shape, AXIS_V)
        return SimState(sim=sim, simw=simw, inside=inside,
                        slice_inside=jnp.any(inside, axis=(1, 2)))

    return jax.jit(_smap(
        body, mesh,
        in_specs=(GEOM_SPEC, SLAB, SLAB),
        out_specs=SIM_SPEC))


def g2_initialize_robust_statistics_fn(ctx, mesh: Mesh):
    body = partial(svr_core.initialize_robust_statistics.__wrapped__, ctx,
                   axis_name=AXIS_S)
    return jax.jit(_smap(
        body, mesh,
        in_specs=(SLICE, SLICE, SIM_SPEC, EM_SPEC, P(), P(), SLICE),
        out_specs=EM_SPEC))


def g2_estep_fn(ctx, mesh: Mesh):
    body = partial(svr_core.estep.__wrapped__, ctx, axis_name=AXIS_S)
    return jax.jit(_smap(
        body, mesh,
        in_specs=(SLICE, SLICE, SLICE, SIM_SPEC, EM_SPEC, SLICE),
        out_specs=(EM_SPEC, SLICE)))


def g2_register_slices_fn(reg_cfg, mesh: Mesh, recon_dx: float,
                          ctx=None):
    """Slice-to-volume registration on the 2D mesh: the z-slab-sharded
    volume is all-gathered over `vol_z` (16 MB-class, once per outer
    iteration — negligible against the registration compute), then each
    device registers its LOCAL slice shard against the full volume
    (PSF-matched tables built in-body when reg_cfg.psf_matched)."""
    from ..register import slice2vol as s2v

    psf = (ctx is not None and ctx.fast is not None
           and getattr(reg_cfg, "psf_matched", False))

    def body(recon_slab, recon_w2i, transforms, mo, ofs_i2w, targets,
             stack_id):
        recon = jax.lax.all_gather(recon_slab, AXIS_V, axis=0,
                                   tiled=True)
        if psf:
            tab = s2v.build_psf_tables(ctx.fast, recon)
            return s2v.register_slices_to_volume(
                reg_cfg, recon, recon_w2i, transforms, mo, ofs_i2w,
                targets, recon_dx, psf_table=tab,
                vol_shape=tuple(ctx.vol_shape), sid=stack_id)
        return s2v.register_slices_to_volume(
            reg_cfg, recon, recon_w2i, transforms, mo, ofs_i2w, targets,
            recon_dx)

    return jax.jit(_smap(
        body, mesh,
        in_specs=(SLAB, P(), SLICE, SLICE, SLICE, SLICE, SLICE),
        out_specs=(SLICE, SLICE)))


def g2_inner_iteration_fn(ctx, mesh: Mesh, do_bias=False, do_scale=True,
                          do_normalise_bias=False):
    """Fused inner SR/EM iteration on the 2D mesh.

    f(geom, slices, valid, em, sim_state, recon_slab, vol_weights_slab,
    mask_slab, excluded, alpha, lam, min_i, max_i, sr_iteration)
    -> (em, sim_state, recon_slab)."""
    _ctx_check(ctx)

    def body(geom, slices, valid, em, sim_state, recon_slab,
             vol_weights_slab, mask_slab, excluded, alpha, lam, min_i,
             max_i, sr_iteration):
        gated = valid & (geom.sume > 0)
        if do_bias:
            em = em._replace(bias=bias_mod.bias_step(
                slices, gated, em.bias, em.scale, em.weights,
                sim_state.sim, sim_state.simw, ctx.sigma_bias,
                ctx.slice_spacing_xy, ctx.global_bias_correction))
        if do_scale:
            em = em._replace(scale=robust.scale_step(
                slices, gated, em.bias, em.weights, sim_state.sim,
                sim_state.simw))
        s = slices * em.scale[:, None, None] if ctx.disable_bias else \
            robust.corrected_slice(slices, em.bias, em.scale)
        resid = jnp.where(sim_state.sim > 0.0, s - sim_state.sim, 0.0)
        wfac = em.weights * em.slice_weight[:, None, None]
        addon, cmap = _g2_scatter(
            ctx, geom, jnp.where(gated, resid * wfac, 0.0),
            jnp.where(gated, wfac, 0.0), mask_slab)
        original = recon_slab
        recon_slab, cmap = sr.apply_addon(recon_slab, addon, cmap, alpha,
                                          min_i, max_i, ctx.adaptive)
        recon_slab = vs.vs_adaptive_regularization(
            recon_slab, original, cmap, alpha, lam, ctx.delta, AXIS_V)
        if do_normalise_bias:
            recon_slab = _g2_normalise_bias(ctx, geom, valid, em,
                                            recon_slab, vol_weights_slab,
                                            mask_slab)
        sim, simw, inside = vs.vs_fast_simulate(
            ctx.fast, geom, recon_slab, mask_slab, ctx.vol_shape, AXIS_V)
        sim_state = SimState(sim=sim, simw=simw, inside=inside,
                             slice_inside=jnp.any(inside, axis=(1, 2)))
        sigma2, mix, m = robust.mstep(
            slices, gated, em.bias, em.scale, em.weights, sim_state.sim,
            sim_state.simw, sr_iteration, em.mix, axis_name=AXIS_S)
        em = em._replace(sigma2=sigma2.astype(jnp.float32),
                         mix=mix.astype(jnp.float32),
                         m=m.astype(jnp.float32))
        weights, potential = robust.voxel_estep(
            slices, gated, em.bias, em.scale, sim_state.sim,
            sim_state.simw, em.sigma2, em.m, em.mix)
        bad = (em.scale < 0.2) | (em.scale > 5.0)
        potential = jnp.where(excluded | bad, -1.0, potential)
        slice_weight, stats = robust.slice_estep(
            potential, em.slice_weight, em.mix_s, axis_name=AXIS_S)
        em = em._replace(weights=weights, slice_weight=slice_weight,
                         mix_s=stats["mix_s"])
        return em, sim_state, recon_slab

    return jax.jit(_smap(
        body, mesh,
        in_specs=(GEOM_SPEC, SLICE, SLICE, EM_SPEC, SIM_SPEC, SLAB, SLAB,
                  SLAB, SLICE, P(), P(), P(), P(), P()),
        out_specs=(EM_SPEC, SIM_SPEC, SLAB)))


def _g2_normalise_bias(ctx, geom, valid, em, recon_slab,
                       vol_weights_slab, mask_slab):
    """NormaliseBias on the 2D mesh: slice-shard scatter psum'd over
    `slices`, slab blur with vol_z halos (vs_gaussian_blur)."""
    logs = jnp.log(jnp.maximum(em.scale, 1e-30))
    b = jnp.where(valid & (em.scale[:, None, None] > 0),
                  em.bias - logs[:, None, None], em.bias)
    payload = jnp.where(valid & (geom.sume > 0), b, 0.0)
    vol_bias, _ = _g2_scatter(ctx, geom, payload,
                              jnp.zeros_like(payload), mask_slab)
    ok = vol_weights_slab > 0
    vol_bias = jnp.where(ok, vol_bias / jnp.where(ok, vol_weights_slab,
                                                  1.0), 0.0)
    m = (mask_slab != 0).astype(recon_slab.dtype)
    vol_bias = jnp.where(mask_slab != 0, vol_bias, 0.0)
    vol_bias = vs.vs_gaussian_blur(vol_bias, ctx.sigma_bias,
                                   ctx.vol_spacing, AXIS_V)
    m_blur = vs.vs_gaussian_blur(m, ctx.sigma_bias, ctx.vol_spacing,
                                 AXIS_V)
    vol_bias = jnp.where(m_blur != 0,
                         vol_bias / jnp.where(m_blur != 0, m_blur, 1.0),
                         0.0)
    return jnp.where(recon_slab != -1.0,
                     recon_slab / jnp.exp(-vol_bias), recon_slab)
