"""Volume-sharded execution: recon grid z-slabs over a `vol_z` mesh axis.

SURVEY §5's large-area mode (the reference's analog of context-parallel
halo exchange).  The slice-DP mode (parallel/sharded.py) replicates the
volume per device — fine for SVR-scale grids, but the LARGE-AREA PVR config
(0.75 mm, 8 stacks, 64x64 patches) strains the replicated-memory budget
not through the volume itself (~67 MB) but through the per-stack conv
tables and scatter accumulators (one volume per stack and payload).  This
module shards all volume-space state — recon, mask, addon/cmap, per-stack
conv(mask)/conv(1) tables, scatter accumulators — into z-slabs, with
slices/patches REPLICATED:

- trilinear gather/scatter need NO halo: every trilinear corner voxel
  lands wholly in one slab, so gathers are ownership-masked partial sums
  combined with jax.lax.psum, and scatters are ownership-masked local
  adds (the analog of the reference's atomicAdd across its per-GPU
  volume copies, reconstruction_cuda2.cu:262-295);
- the separable PSF convolutions exchange a kernel-radius z-halo via
  jax.lax.ppermute (zero-filled at the global edges, matching the
  engines' zero-padded convolution);
- the 13-direction adaptive regularization exchanges a 2-voxel halo
  (direction reach 1, two chained shifts); the zero-filled cmap halo
  makes the extended-slab bounds checks agree exactly with the
  replicated operator (every boundary term is gated by neighbour
  cmap > 0).

Equality vs the replicated fast engine is asserted in
tests/test_volume_sharded.py on the 8-device CPU mesh.

NormaliseBias runs slab-wise too (vs_normalise_bias): its sigma_bias
blur reaches ~4*sigma/dz z-rows (~50 at 12 mm / 1 mm) — often more than
a slab — which the MULTI-HOP halo exchange covers; the boundary
renormalization halo-exchanges a ones-volume so edge weights match the
replicated operator exactly.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import psf_fast as pf
from ..pipeline import svr_core
from ..pipeline.state import EMState, SimState
from ..sr import superresolution as sr
from ..em import robust

AXIS_V = "vol_z"


def make_vol_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS_V,))


def pad_attr_z(attr, n_dev: int):
    """Extend attr's z (at the high end) to a multiple of n_dev, keeping
    every existing voxel's world position (origin shifts by half the
    added extent along the z axis)."""
    extra = (-attr.z) % n_dev
    if extra == 0:
        return attr.copy(), 0
    new = attr.copy()
    new.z = attr.z + extra
    zax = np.asarray(attr.zaxis, np.float64)
    shift = zax * (extra * attr.dz / 2.0)
    new.xorigin = attr.xorigin + float(shift[0])
    new.yorigin = attr.yorigin + float(shift[1])
    new.zorigin = attr.zorigin + float(shift[2])
    return new, extra


class VSGeom(NamedTuple):
    """Volume-sharded fast-engine geometry (all leaves jnp arrays).

    xp/valid/sume/sid/den are REPLICATED (identical on every device):
    the per-stack conv(1)/conv(mask) z-slabs are gathered ONCE at build
    into sume and the simulate denominator den (both geometry constants
    — mask and xp only change with a transform update), then dropped;
    simulate only rebuilds/gathers the conv(vol*mask) numerator."""
    xp: jax.Array
    valid: jax.Array
    sume: jax.Array
    sid: jax.Array
    den: jax.Array


def _halo_exchange_z(slab, h: int, axis_name: str):
    """(..., Lz, ys, xs) -> (..., h + Lz + h, ys, xs): h rows of halo from
    each z-neighbour via ppermute, MULTI-HOP when h exceeds the slab
    thickness (a wide PSF on thin slabs reaches across several devices).
    Devices at the global edges receive zeros — matching the engines'
    zero-padded convolution boundary."""
    if h == 0:
        return slab
    ax = slab.ndim - 3
    n = jax.lax.axis_size(axis_name)
    lz = slab.shape[ax]
    if n == 1:
        pad = [(0, 0)] * slab.ndim
        pad[ax] = (h, h)
        return jnp.pad(slab, pad)
    hops = -(-h // lz)                     # neighbours needed per side

    def take_z(arr, lo, hi):
        idx = [slice(None)] * arr.ndim
        idx[ax] = slice(lo, hi)
        return arr[tuple(idx)]

    lo_parts, hi_parts = [], []
    for k in range(hops, 0, -1):
        fwd = [(i, i + k) for i in range(n - k)]
        bwd = [(i + k, i) for i in range(n - k)]
        lo_parts.append(jax.lax.ppermute(slab, axis_name, fwd))
        hi_parts.append(jax.lax.ppermute(slab, axis_name, bwd))
    below = jnp.concatenate(lo_parts, axis=ax) if hops > 1 else \
        lo_parts[0]
    above = jnp.concatenate(hi_parts[::-1], axis=ax) if hops > 1 else \
        hi_parts[0]
    below = take_z(below, hops * lz - h, hops * lz)
    above = take_z(above, 0, h)
    return jnp.concatenate([below, slab, above], axis=ax)


def _conv_terms_radius(terms) -> int:
    """Max one-sided reach of the z taps.  With EVEN kernel sizes the tap
    at (k-1)//2 is treated as centre, so the reach is asymmetric: up to
    k-1-(k-1)//2 on one side (4 for k=8) — take the larger side for both
    halos (covers the flipped adjoint too)."""
    if not terms:
        return 0
    return max(len(t[0]) - 1 - (len(t[0]) - 1) // 2 for t in terms)


def vs_conv_separable(slab, terms, axis_name: str, flip: bool = False):
    """conv_separable with the z-axis running over a halo-extended slab.

    Exactly equal to the replicated conv: in-plane passes are local, the
    z pass sees neighbour values (zeros at the global edges)."""
    h = _conv_terms_radius(terms)
    ext = _halo_exchange_z(slab, h, axis_name)
    # conv_separable operates on the last 3 axes; its zero padding at the
    # halo-extended ends matches the replicated operator
    out = pf.conv_separable(ext, terms, flip=flip)
    if h:
        out = out[..., h:-h, :, :] if out.ndim == 4 else out[h:-h]
    return out


def _vs_gather(tables_slab, xp, sid, vol_shape, axis_name: str):
    """Ownership-masked trilinear gather + psum.

    tables_slab: (P, S, Lz, ys, xs) stacked per-stack conv volumes (P
    payload volumes).  Returns P arrays shaped xp.shape[:-1], identical
    to the replicated shingle_gather."""
    zs, ys, xs = vol_shape
    p_, s_, lz = tables_slab.shape[0], tables_slab.shape[1], \
        tables_slab.shape[2]
    z0 = jax.lax.axis_index(axis_name).astype(jnp.int32) * lz
    ui, vi, wi, wts = pf._corner_weights(xp)
    nd = wi.ndim - sid.ndim
    sid_b = sid.astype(jnp.int32).reshape(sid.shape + (1,) * nd)
    flat = tables_slab.reshape(p_, -1)
    outs = [jnp.zeros(wi.shape, jnp.float32) for _ in range(p_)]
    for c in range(8):
        cw, cv, cu = (c >> 2) & 1, (c >> 1) & 1, c & 1
        zc, yc, xc = wi + cw, vi + cv, ui + cu
        own = ((zc >= z0) & (zc < z0 + lz) & (zc >= 0) & (zc < zs)
               & (yc >= 0) & (yc < ys) & (xc >= 0) & (xc < xs))
        lin = ((sid_b * lz + (zc - z0)) * ys + yc) * xs + xc
        lin = jnp.clip(lin, 0, s_ * lz * ys * xs - 1)
        w = jnp.where(own, wts[..., c], 0.0)
        for p in range(p_):
            outs[p] = outs[p] + w * jnp.take(flat[p], lin.reshape(-1),
                                             axis=0).reshape(wi.shape)
    return [jax.lax.psum(o, axis_name) for o in outs]


def vs_build_geometry(fast: pf.FastPSF, fwd, valid, vol_shape, mask_slab,
                      stack_id, axis_name: str) -> VSGeom:
    """Volume-sharded analog of make_fast_geom: per-stack conv(1) and
    conv(mask) z-slabs + the replicated per-pixel sume gather."""
    n, h, w = valid.shape
    sid = jnp.asarray(stack_id, jnp.int32)
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    xp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, None, None]
          + fwd[:, None, None, :3, 3])
    ones = jnp.ones(mask_slab.shape, jnp.float32)
    m = mask_slab.reshape(mask_slab.shape)
    ones_slab = jnp.stack([vs_conv_separable(ones, t, axis_name)
                           for t in fast.terms])
    cmask_slab = jnp.stack([vs_conv_separable(m, t, axis_name)
                            for t in fast.terms])
    sume, den = _vs_gather(jnp.stack([ones_slab, cmask_slab]), xp, sid,
                           vol_shape, axis_name)
    sume = jnp.where(valid & (sume > 0.5), sume, 0.0)
    return VSGeom(xp=xp, valid=valid, sume=sume, sid=sid, den=den)


def vs_fast_simulate(fast: pf.FastPSF, geom: VSGeom, vol_slab, mask_slab,
                     vol_shape, axis_name: str):
    """sim/simw/inside — replicated outputs from slab-sharded volumes.

    The denominator comes pre-gathered from geom.den (a geometry
    constant); only the conv(vol*mask) numerator is gathered per call."""
    vm = vol_slab * mask_slab
    num_slab = jnp.stack([vs_conv_separable(vm, t, axis_name)
                          for t in fast.terms])
    (num,) = _vs_gather(num_slab[None], geom.xp, geom.sid, vol_shape,
                        axis_name)
    den = geom.den
    sim = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    gate = (geom.sume > 0.0) & geom.valid
    inside = gate & (den > 0)
    simw = jnp.where(inside,
                     den / jnp.where(geom.sume > 0, geom.sume, 1.0), 0.0)
    sim = jnp.where(inside, sim, 0.0)
    return sim, simw, inside


def vs_fast_scatter2(fast: pf.FastPSF, geom: VSGeom, pay_a, pay_b,
                     mask_slab, vol_shape, axis_name: str):
    """Transpose accumulation into z-slabs via the dense 8-corner splat
    (psf_fast.splat2), then the per-stack adjoint convolutions with halo
    exchange.

    Slab assignment is by the pixel's FLOOR voxel: the whole 2x2x2
    trilinear window spans local z [wl, wl+1], so the slab scatters into
    a LOCAL volume of height lz+1 (one top halo plane) and the halo plane
    is ppermute'd forward and added to the next slab's first plane.
    Equality with the replicated engine (incl. masks extending to the
    volume borders) is asserted in tests/test_volume_sharded.py."""
    zs, ys, xs = vol_shape
    lz = mask_slab.shape[0]
    s_ = len(fast.terms)
    idx = jax.lax.axis_index(axis_name).astype(jnp.int32)
    n_dev = jax.lax.axis_size(axis_name)
    z0 = idx * lz
    inv = jnp.where(geom.sume > 0,
                    1.0 / jnp.where(geom.sume > 0, geom.sume, 1.0), 0.0)
    # ownership by floor voxel; the -1 global halo floor belongs to slab 0
    w_floor = jnp.floor(geom.xp[..., 2]).astype(jnp.int32)
    lo = jnp.where(idx == 0, -1, 0)
    own = (w_floor - z0 >= lo) & (w_floor - z0 <= lz - 1)
    a = jnp.where(own, pay_a * inv, 0.0)
    b = jnp.where(own, pay_b * inv, 0.0)
    xp_loc = geom.xp - jnp.asarray([0.0, 0.0, 1.0]) * z0.astype(jnp.float32)
    acc = pf.splat2(xp_loc, a, b, (lz + 1, ys, xs), sid=geom.sid,
                    n_stacks=s_)                 # (S, 2, lz+1, ys, xs)
    # top halo plane -> next slab's first plane (device 0 receives zeros)
    halo = acc[:, :, lz]
    recv = jax.lax.ppermute(halo, axis_name,
                            [(i, i + 1) for i in range(n_dev - 1)])
    acc = acc[:, :, :lz].at[:, :, 0].add(recv)
    out = jnp.zeros((2, lz, ys, xs), jnp.float32)
    for s, terms in enumerate(fast.terms):
        out = out + vs_conv_separable(acc[s], terms, axis_name, flip=True)
    m = (mask_slab != 0).astype(jnp.float32)
    return out[0] * m, out[1] * m


def vs_gaussian_blur(slab, sigma_mm: float, spacing_xyz, axis_name: str):
    """ops.gaussian.gaussian_blur on z-slabs: in-plane passes are local;
    the z pass halo-exchanges BOTH the data and a ones-volume so the
    boundary renormalization divides by the GLOBAL in-bounds weight sum
    (zero-filled halos at the true volume edges reproduce the replicated
    operator exactly)."""
    from ..ops.gaussian import gaussian_kernel1d, _blur_axis
    dx, dy, dz = (float(spacing_xyz[0]), float(spacing_xyz[1]),
                  float(spacing_xyz[2]))
    out = _blur_axis(slab, gaussian_kernel1d(sigma_mm / dx), axis=2)
    out = _blur_axis(out, gaussian_kernel1d(sigma_mm / dy), axis=1)
    kz = gaussian_kernel1d(sigma_mm / dz)
    r = (len(kz) - 1) // 2
    if r == 0:
        return out
    ext = _halo_exchange_z(out, r, axis_name)
    ext1 = _halo_exchange_z(jnp.ones_like(slab), r, axis_name)
    num = pf._conv1d_axis(ext, kz, axis=0)[r:-r]
    den = pf._conv1d_axis(ext1, kz, axis=0)[r:-r]
    return num / den


def vs_normalise_bias(ctx, geom: VSGeom, valid, em, recon_slab,
                      vol_weights_slab, mask_slab, axis_name: str):
    """NormaliseBias on z-slabs (svr_core.normalise_bias_step fast path):
    scatter the per-slice log-bias through the PSF, divide by volume
    weights, mask, blur (halo z-pass), divide by the blurred mask, exp."""
    logs = jnp.log(jnp.maximum(em.scale, 1e-30))
    b = jnp.where(valid & (em.scale[:, None, None] > 0),
                  em.bias - logs[:, None, None], em.bias)
    payload = jnp.where(valid & (geom.sume > 0), b, 0.0)
    vol_bias, _ = vs_fast_scatter2(ctx.fast, geom, payload,
                                   jnp.zeros_like(payload), mask_slab,
                                   ctx.vol_shape, axis_name)
    ok = vol_weights_slab > 0
    vol_bias = jnp.where(ok, vol_bias / jnp.where(ok, vol_weights_slab,
                                                  1.0), 0.0)
    m = (mask_slab != 0).astype(recon_slab.dtype)
    vol_bias = jnp.where(mask_slab != 0, vol_bias, 0.0)
    vol_bias = vs_gaussian_blur(vol_bias, ctx.sigma_bias,
                                ctx.vol_spacing, axis_name)
    m_blur = vs_gaussian_blur(m, ctx.sigma_bias, ctx.vol_spacing,
                              axis_name)
    vol_bias = jnp.where(m_blur != 0,
                         vol_bias / jnp.where(m_blur != 0, m_blur, 1.0),
                         0.0)
    return jnp.where(recon_slab != -1.0,
                     recon_slab / jnp.exp(-vol_bias), recon_slab)


def vs_adaptive_regularization(recon_slab, original_slab, cmap_slab,
                               alpha, lam, delta, axis_name: str):
    """13-direction regularization on 2-voxel halo-extended slabs.

    Exactly equal to the replicated operator: every extended-bounds
    discrepancy at a halo edge is gated by the zero-filled cmap halo."""
    ext_r = _halo_exchange_z(recon_slab, 2, axis_name)
    ext_o = _halo_exchange_z(original_slab, 2, axis_name)
    ext_c = _halo_exchange_z(cmap_slab, 2, axis_name)
    out = sr.adaptive_regularization(ext_r, ext_o, ext_c, alpha, lam,
                                     delta)
    return out[2:-2]


def _vs_ctx_check(ctx: svr_core.SVRContext):
    if ctx.fast is None:
        raise NotImplementedError("volume sharding requires the fast "
                                  "engine (ctx.fast)")


GEOM_SPEC = VSGeom(xp=P(), valid=P(), sume=P(), sid=P(), den=P())


def _smap(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


SLAB = P(AXIS_V)


def vs_build_geometry_fn(ctx, mesh: Mesh):
    """f(recon_w2i, transforms, slice_i2w, valid, mask_slab, stack_id)
    -> VSGeom (xp/valid/sume/sid replicated, tables slab-sharded)."""
    _vs_ctx_check(ctx)

    def body(recon_w2i, transforms, slice_i2w, valid, mask_slab,
             stack_id):
        fwd = svr_core.slice_forward_matrices(recon_w2i, transforms,
                                              slice_i2w)
        return vs_build_geometry(ctx.fast, fwd, valid, ctx.vol_shape,
                                 mask_slab, stack_id, AXIS_V)

    return jax.jit(_smap(
        body, mesh,
        in_specs=(P(), P(), P(), P(), SLAB, P()),
        out_specs=GEOM_SPEC))


def vs_gaussian_reconstruction_fn(ctx, mesh: Mesh):
    _vs_ctx_check(ctx)

    def body(slices, valid, geom, bias, scale, mask_slab):
        s = slices * scale[:, None, None] if ctx.disable_bias else \
            robust.corrected_slice(slices, bias, scale)
        gate = valid & (geom.sume > 0.0)
        num, wts = vs_fast_scatter2(
            ctx.fast, geom, jnp.where(gate, s, 0.0),
            jnp.where(gate, 1.0, 0.0), mask_slab, ctx.vol_shape, AXIS_V)
        recon = sr.equalize(num, wts)
        _, _, inside = vs_fast_simulate(ctx.fast, geom, num, mask_slab,
                                        ctx.vol_shape, AXIS_V)
        return recon, wts, jnp.sum(inside, axis=(1, 2))

    return jax.jit(_smap(
        body, mesh,
        in_specs=(P(), P(), GEOM_SPEC, P(), P(), SLAB),
        out_specs=(SLAB, SLAB, P())))


def vs_simulate_fn(ctx, mesh: Mesh):
    _vs_ctx_check(ctx)

    def body(geom, recon_slab, mask_slab):
        sim, simw, inside = vs_fast_simulate(ctx.fast, geom, recon_slab,
                                             mask_slab, ctx.vol_shape,
                                             AXIS_V)
        return SimState(sim=sim, simw=simw, inside=inside,
                        slice_inside=jnp.any(inside, axis=(1, 2)))

    return jax.jit(_smap(
        body, mesh,
        in_specs=(GEOM_SPEC, SLAB, SLAB),
        out_specs=SimState(sim=P(), simw=P(), inside=P(),
                           slice_inside=P())))


def vs_inner_iteration_fn(ctx, mesh: Mesh, do_bias=False, do_scale=True,
                          do_normalise_bias=False):
    """Volume-sharded fused inner SR/EM iteration.

    Slices are replicated (every device computes identical EM state);
    scatter/regularize/simulate/NormaliseBias run on z-slabs with
    psum/ppermute.  f(geom, slices, valid, em, sim_state, recon_slab,
    vol_weights_slab, mask_slab, excluded, alpha, lam, min_i, max_i,
    sr_iteration) -> (em, sim_state, recon_slab)."""
    _vs_ctx_check(ctx)
    from ..em import bias as bias_mod

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
        addon, cmap = vs_fast_scatter2(
            ctx.fast, geom, jnp.where(gated, resid * wfac, 0.0),
            jnp.where(gated, wfac, 0.0), mask_slab, ctx.vol_shape,
            AXIS_V)
        original = recon_slab
        recon_slab, cmap = sr.apply_addon(recon_slab, addon, cmap, alpha,
                                          min_i, max_i, ctx.adaptive)
        recon_slab = vs_adaptive_regularization(recon_slab, original,
                                                cmap, alpha, lam,
                                                ctx.delta, AXIS_V)
        if do_normalise_bias:
            recon_slab = vs_normalise_bias(ctx, geom, valid, em,
                                           recon_slab, vol_weights_slab,
                                           mask_slab, AXIS_V)
        sim, simw, inside = vs_fast_simulate(ctx.fast, geom, recon_slab,
                                             mask_slab, ctx.vol_shape,
                                             AXIS_V)
        sim_state = SimState(sim=sim, simw=simw, inside=inside,
                             slice_inside=jnp.any(inside, axis=(1, 2)))
        sigma2, mix, m = robust.mstep(
            slices, gated, em.bias, em.scale, em.weights, sim_state.sim,
            sim_state.simw, sr_iteration, em.mix)
        em = em._replace(sigma2=sigma2.astype(jnp.float32),
                         mix=mix.astype(jnp.float32),
                         m=m.astype(jnp.float32))
        weights, potential = robust.voxel_estep(
            slices, gated, em.bias, em.scale, sim_state.sim,
            sim_state.simw, em.sigma2, em.m, em.mix)
        bad = (em.scale < 0.2) | (em.scale > 5.0)
        potential = jnp.where(excluded | bad, -1.0, potential)
        slice_weight, stats = robust.slice_estep(potential,
                                                 em.slice_weight,
                                                 em.mix_s)
        em = em._replace(weights=weights, slice_weight=slice_weight,
                         mix_s=stats["mix_s"])
        return em, sim_state, recon_slab

    em_spec = EMState(weights=P(), bias=P(), scale=P(), slice_weight=P(),
                      sigma2=P(), m=P(), mix=P(), mix_s=P())
    sim_spec = SimState(sim=P(), simw=P(), inside=P(), slice_inside=P())
    return jax.jit(_smap(
        body, mesh,
        in_specs=(GEOM_SPEC, P(), P(), em_spec, sim_spec, SLAB, SLAB,
                  SLAB, P(), P(), P(), P(), P(), P()),
        out_specs=(em_spec, sim_spec, SLAB)))
