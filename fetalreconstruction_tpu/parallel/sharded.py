"""Multi-device SPMD execution: slices sharded over a device mesh.

Replacement for the reference's multi-GPU runtime
(GPUWorker.{h,cpp} + the peer-memcpy/thrust reduce-broadcast layer,
reconstruction_cuda2.cu:1408-1460, 2225-2239, 2368-2373 / SURVEY.md §2.4):

- the reference assigns contiguous slice ranges to GPUs, replicates the
  volume per device, reduces addon/cmap/volume-weights to device 0 with
  peer cudaMemcpy + thrust::plus, regularizes on device 0 and broadcasts;
- here the slice batch is sharded over the `slices` mesh axis with
  shard_map, the volume is replicated, scatter outputs and EM scalar
  partials are combined with jax.lax.psum, and regularization runs
  replicated (identical on every device — no broadcast needed).

Both PSF engines are supported: the exact offset-scan engine (ops/psf.py)
and the production fast conv+trilinear engine (ops/psf_fast.py, whose
FastGeom tables are per-slice/stack-id addressed precisely so the slice
axis shards — every per-slice op is elementwise in `sid`, the per-stack
shingle tables are replicated).

The compute bodies are NOT duplicated here: svr_core's jitted functions
take an `axis_name` argument and insert the psums themselves; this module
only provides the shard_map plumbing (mesh, specs, padding).

All functions accept an already-padded slice count divisible by the mesh
size (pad with fully-invalid slices; they contribute nothing).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import psf as psf_ops
from ..ops import psf_fast
from ..pipeline import svr_core
from ..pipeline.state import EMState, SimState

AXIS = "slices"


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def pad_slices_for_mesh(n_slices: int, n_devices: int) -> int:
    """Slice count padded up to a multiple of the mesh size."""
    return ((n_slices + n_devices - 1) // n_devices) * n_devices


def slice_sharding(mesh: Mesh):
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    """Place (N, ...) arrays with the leading axis sharded over `slices`."""
    s = slice_sharding(mesh)
    return tuple(jax.device_put(a, s) for a in arrays)


def place_global(mesh: Mesh, spec, a):
    """Place a host-global array onto `mesh` with PartitionSpec `spec`,
    working in BOTH single- and multi-process runs.

    Single-process: plain jax.device_put.  Multi-process (the reference's
    multi-node DCN tier, SURVEY §2.4): jax.device_put cannot target
    non-addressable devices, so each process contributes only the shards
    it owns via jax.make_array_from_callback — every process holds the
    same host-global value (the pipeline builds its inputs identically
    on all processes, like the reference's per-node file loads).
    """
    sh = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(a, sh)
    arr = np.asarray(a)
    return jax.make_array_from_callback(arr.shape, sh,
                                        lambda idx: arr[idx])


def geom_spec(ctx: svr_core.SVRContext):
    """PartitionSpec pytree for the engine's geometry structure."""
    if ctx.fast is not None:
        return psf_fast.FastGeom(xp=P(AXIS), valid=P(AXIS), sume=P(AXIS),
                                 sid=P(AXIS), den=P(AXIS))
    return psf_ops.SliceGeom(centre=P(AXIS), frac=P(AXIS), a3=P(AXIS),
                             slice_dim=P(AXIS), valid=P(AXIS))


EM_SPEC = EMState(weights=P(AXIS), bias=P(AXIS), scale=P(AXIS),
                  slice_weight=P(AXIS), sigma2=P(), m=P(), mix=P(),
                  mix_s=P())
SIM_SPEC = SimState(sim=P(AXIS), simw=P(AXIS), inside=P(AXIS),
                    slice_inside=P(AXIS))


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def sharded_inner_iteration(ctx: svr_core.SVRContext, mesh: Mesh,
                            do_bias: bool = False, do_scale: bool = True,
                            do_normalise_bias: bool = False,
                            donate: bool = True):
    """Build the jitted multi-device fused inner SR/EM iteration — the
    shard_map form of svr_core.inner_iteration (axis_name=AXIS inserts
    the psum collectives).

    Returns f(geom, sume, slices, valid, em, sim_state, recon,
    vol_weights, mask, mask_flat, excluded, alpha, lam, min_i, max_i,
    sr_iteration) -> (em, sim_state, recon)."""
    body = partial(svr_core.inner_iteration.__wrapped__, ctx,
                   do_bias=do_bias, do_scale=do_scale,
                   do_normalise_bias=do_normalise_bias, axis_name=AXIS)
    sm = _shard_map(
        body, mesh,
        in_specs=(geom_spec(ctx), P(AXIS), P(AXIS), P(AXIS), EM_SPEC,
                  SIM_SPEC, P(), P(), P(), P(), P(AXIS), P(), P(), P(),
                  P(), P()),
        out_specs=(EM_SPEC, SIM_SPEC, P()))
    return jax.jit(sm, donate_argnums=(4, 5, 6) if donate else ())


def sharded_em_sr_iteration(ctx: svr_core.SVRContext, mesh: Mesh):
    """Compatibility wrapper with the round-1 call signature.

    Returns f(slices, valid, geom, sume, em, sim_state, recon,
    vol_weights, mask, mask_flat, excluded, alpha, lam, min_i, max_i,
    sr_iteration) -> (recon, em, sim_state).

    One call = one inner SR iteration: [bias] scale -> SR scatter (psum)
    -> regularize (replicated) -> simulate -> M-step (psum) -> E-step
    (psum).
    """
    inner = sharded_inner_iteration(ctx, mesh,
                                    do_bias=not ctx.disable_bias,
                                    do_scale=True,
                                    do_normalise_bias=False,
                                    donate=False)

    def f(slices, valid, geom, sume, em, sim_state, recon, vol_weights,
          mask, mask_flat, excluded, alpha, lam, min_i, max_i,
          sr_iteration):
        em, sim_state, recon = inner(geom, sume, slices, valid, em,
                                     sim_state, recon, vol_weights, mask,
                                     mask_flat, excluded, alpha, lam,
                                     min_i, max_i, sr_iteration)
        return recon, em, sim_state

    return f


def sharded_gaussian_reconstruction(ctx: svr_core.SVRContext, mesh: Mesh):
    """Multi-device initial reconstruction: local PSF scatter + psum.

    Returns f(slices, valid, geom, sume, bias, scale, mask_flat)
    -> (recon, vol_weights, voxel_count)."""
    body = partial(svr_core.gaussian_reconstruction.__wrapped__, ctx,
                   axis_name=AXIS)

    def step(slices, valid, geom, sume, bias, scale, mask_flat):
        return body(geom, sume, slices, valid, bias, scale, mask_flat)

    sm = _shard_map(
        step, mesh,
        in_specs=(P(AXIS), P(AXIS), geom_spec(ctx), P(AXIS), P(AXIS),
                  P(AXIS), P()),
        out_specs=(P(), P(), P(AXIS)))
    return jax.jit(sm)


def sharded_simulate(ctx: svr_core.SVRContext, mesh: Mesh):
    """Forward projection under the mesh (purely local: the volume is
    replicated, every device gathers its own slices)."""
    body = partial(svr_core.simulate.__wrapped__, ctx)
    sm = _shard_map(
        body, mesh,
        in_specs=(geom_spec(ctx), P(AXIS), P(), P()),
        out_specs=SIM_SPEC)
    return jax.jit(sm)


def sharded_initialize_robust_statistics(ctx: svr_core.SVRContext,
                                         mesh: Mesh):
    """InitializeRobustStatistics with psum'd global error variance."""
    body = partial(svr_core.initialize_robust_statistics.__wrapped__, ctx,
                   axis_name=AXIS)
    sm = _shard_map(
        body, mesh,
        in_specs=(P(AXIS), P(AXIS), SIM_SPEC, EM_SPEC, P(), P(), P(AXIS)),
        out_specs=EM_SPEC)
    return jax.jit(sm)


def sharded_estep(ctx: svr_core.SVRContext, mesh: Mesh):
    """Voxel + slice E-step with psum'd slice-mixture statistics."""
    body = partial(svr_core.estep.__wrapped__, ctx, axis_name=AXIS)
    sm = _shard_map(
        body, mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), SIM_SPEC, EM_SPEC, P(AXIS)),
        out_specs=(EM_SPEC, P(AXIS)))
    return jax.jit(sm)


def sharded_register_slices(reg_cfg, mesh: Mesh, recon_dx: float,
                            ctx: Optional[svr_core.SVRContext] = None):
    """Slice-to-volume registration under the mesh: the #1 hot loop
    (registerMultipleSlicesToVolume, reconstruction_cuda2.cu:4001-4147)
    sharded over slices — each device optimizes its own slice range against
    the replicated volume; no collectives are needed (per-slice problems
    are independent; the reference's multi-GPU path partitions exactly the
    same way via dev_slice_range_offset).

    With ctx (fast engine) and reg_cfg.psf_matched, the PSF-matched
    tables are built from the replicated recon inside the body.

    Returns f(recon, recon_w2i, transforms, mo, ofs_i2w, targets,
    stack_id) -> (new_transforms (N,4,4), similarity (N,))."""
    from ..register import slice2vol as s2v

    psf = (ctx is not None and ctx.fast is not None
           and getattr(reg_cfg, "psf_matched", False))

    def step(recon, recon_w2i, transforms, mo, ofs_i2w, targets,
             stack_id):
        if psf:
            tab = s2v.build_psf_tables(ctx.fast, recon)
            return s2v.register_slices_to_volume(
                reg_cfg, recon, recon_w2i, transforms, mo, ofs_i2w,
                targets, recon_dx, psf_table=tab,
                vol_shape=tuple(ctx.vol_shape), sid=stack_id)
        return s2v.register_slices_to_volume(
            reg_cfg, recon, recon_w2i, transforms, mo, ofs_i2w, targets,
            recon_dx)

    sm = _shard_map(
        step, mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS)))
    return jax.jit(sm)


def sharded_build_geometry(ctx: svr_core.SVRContext, mesh: Mesh):
    """Geometry rebuild under the mesh.

    Per-slice matrices/tables shard; the fast engine's per-stack conv
    volumes (shingle tables) are volume-space and computed replicated.
    Returns f(recon_w2i, transforms, slice_i2w, slice_dims, valid,
    mask_flat, stack_id) -> (geom, sume)."""

    def step(recon_w2i, transforms, slice_i2w, slice_dims, valid,
             mask_flat, stack_id):
        return svr_core.build_geometry.__wrapped__(
            ctx, recon_w2i, transforms, slice_i2w, slice_dims, valid,
            mask_flat, stack_id)

    sm = _shard_map(
        step, mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(AXIS)),
        out_specs=(geom_spec(ctx), P(AXIS)))
    return jax.jit(sm)
