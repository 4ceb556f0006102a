"""PSF projection engine: slice<->volume transfer through the sinc-Gauss PSF.

JAX reimplementation of the reference's three hot CUDA kernels
(reconstruction_cuda2.cu):
- gaussianReconstructionKernel3D_tex (:176)  -> psf_scatter / gaussian_recon
- simulateSlicesKernel3D_tex       (:298)  -> psf_gather  / simulate_slices
- SuperresolutionKernel3D_tex      (:408)  -> psf_scatter (addon + cmap)

Math (verified against getPSFParamsPrecomp, reconstruction_cuda2.cu:164-175):
for slice pixel p = (px, py, 0) of slice s with
    F_s    = reconW2I @ T_s @ sliceI2W        (slice index -> volume index)
    A_s    = F_s^{-1}                          (combInvTrans in the reference)
the PSF weight of integer volume voxel  v = round(F_s p) + o  is

    w(s, p, o) = calcPSF( sliceDim ⊙ (A3_s · (o - frac_{s,p})) )

with frac = F_s p - round(F_s p) ∈ [-0.5, 0.5]^3 and A3 the linear part of
A_s (the reference's PSF-image-centre term d_PSFI2W @ centre is exactly 0).
calcPSF (reconstruction_cuda2.cu:112-131, USE_SINC_PSF=1):

    ax = v.x * dim.x / 2.3548 ;  ay = v.y * dim.y / 2.3548
    r  = pi * sqrt(ax^2 + ay^2)
    w  = (sin r / r)^2 * exp(-v.z^2 / (2 (dim.z/2.3548)^2))   [Bartlett sinc]

Per-pixel normalization `sume` sums w over IN-BOUNDS voxels (no mask check,
pass 1 of the reconstruction kernel); pixels with sume <= 0.5 are dropped
entirely.  Scatter/gather then use w/sume restricted to in-bounds AND
in-mask voxels.

Deviation from the reference (documented): the CUDA kernels skip a
contribution when it differs from the previous x-neighbour by < PSF_EPSILON
(1e-5) — a warp-efficiency trick that drops only near-zero tail duplicates.
We instead keep all terms of the (statically pruned) support; contributions
are identical to within the epsilon the reference itself discards.

Everything is structured as a static scan over the K^3 integer offset list:
per offset one fused elementwise pass over all (N, H, W) slice pixels plus
one XLA gather (simulate) or scatter-add (reconstruct/SR).  On a GPU the
scatter-add sums with atomics in no fixed order, so results agree with a
sequential sum to float rounding, not bitwise.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PSF_CONST = 2.3548  # FWHM -> sigma conversion used throughout the reference


class SliceGeom(NamedTuple):
    """Per-(slice,pixel) geometry, recomputed after each registration update.

    centre: (N, H, W, 3) int32   round(F_s p) volume voxel of each pixel
    frac:   (N, H, W, 3) f32     F_s p - centre
    a3:     (N, 3, 3)    f32     linear part of F_s^{-1}
    slice_dim: (N, 3)    f32     (dx, dy, thickness) of each slice in mm
    valid:  (N, H, W)    bool    pixel != padding
    """
    centre: jax.Array
    frac: jax.Array
    a3: jax.Array
    slice_dim: jax.Array
    valid: jax.Array


def make_slice_geom(fwd: jax.Array, slice_dim: jax.Array,
                    valid: jax.Array) -> SliceGeom:
    """Build SliceGeom from forward matrices.

    fwd: (N, 4, 4) f32 = reconW2I @ T_s @ sliceI2W.
    """
    n, h, w = valid.shape
    a3 = jnp.linalg.inv(fwd[:, :3, :3])
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    # vpos[n, y, x, :] = F[:, :2] @ (px, py) + F[:, 3]
    vp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, None, None]
          + fwd[:, None, None, :3, 3])
    centre = jnp.floor(vp + 0.5)  # CUDA roundf (half away from zero, vp>=0)
    frac = vp - centre
    return SliceGeom(centre=centre.astype(jnp.int32), frac=frac,
                     a3=a3.astype(jnp.float32),
                     slice_dim=slice_dim.astype(jnp.float32),
                     valid=valid)


def calc_psf(mm: jax.Array, slice_dim: jax.Array) -> jax.Array:
    """Bartlett sinc^2 in-plane x Gaussian through-plane PSF.

    mm: (..., 3) offsets in slice-frame mm; slice_dim broadcastable (..., 3).
    Matches calcPSF (reconstruction_cuda2.cu:112-131).
    """
    sigmaz = slice_dim[..., 2] / PSF_CONST
    ax = mm[..., 0] * slice_dim[..., 0] / PSF_CONST
    ay = mm[..., 1] * slice_dim[..., 1] / PSF_CONST
    r = jnp.pi * jnp.sqrt(ax * ax + ay * ay)
    si = jnp.where(r > 1e-6, jnp.sin(r) / jnp.where(r > 1e-6, r, 1.0), 1.0)
    gz = jnp.exp(-(mm[..., 2] ** 2) / (2.0 * sigmaz * sigmaz))
    return si * si * gz


def reference_support(slice_dims: np.ndarray, recon_dx: float,
                     quality_factor: float, max_support: int = 16) -> int:
    """The reference's PSF support size formula
    (reconstruction_cuda2.cu:225-231, non-infinite branch), maxed over
    slices and clamped to MAX_PSF_SUPPORT."""
    size_inv = 2.0 * quality_factor / recon_dx
    dims = np.atleast_2d(np.asarray(slice_dims, dtype=np.float64))
    best = 3
    for d in dims:
        xd = round(d[0] * size_inv)
        yd = round(d[1] * size_inv)
        zd = round(d[2] * size_inv)
        dim = int(np.floor(np.ceil(np.sqrt(float(xd * xd + yd * yd + zd * zd))
                                   / quality_factor) * 0.5) * 2 + 3)
        best = max(best, dim)
    return min(best, max_support)


def make_offsets(support: int) -> np.ndarray:
    """Integer offset cube, matching the reference's loop
    (o = idx - centre, centre = (dim-1)//2, idx in [0, dim))."""
    centre = (support - 1) // 2
    r = np.arange(support) - centre
    oz, oy, ox = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([ox.ravel(), oy.ravel(), oz.ravel()],
                    axis=-1).astype(np.int32)


def prune_offsets(offsets: np.ndarray, a3: np.ndarray, slice_dim: np.ndarray,
                  eps: float = 1e-5) -> np.ndarray:
    """Statically drop offsets whose maximum achievable PSF weight is below
    eps for EVERY slice (eps defaults to the reference's PSF_EPSILON,
    reconstruction_cuda2.cuh:72 — the same magnitude its dedup skip drops).

    The bound accounts for the ±0.5 frac slack: per offset we take the
    closest-possible mm position, bound sinc^2 by min(1, 1/(pi r)^2) (its
    envelope beyond the first zero) and multiply by the through-plane
    Gaussian.  a3: (N,3,3) host copy; slice_dim: (N,3).
    """
    keep = np.zeros(len(offsets), dtype=bool)
    a3 = np.atleast_3d(np.asarray(a3, dtype=np.float64))
    slice_dim = np.atleast_2d(np.asarray(slice_dim, dtype=np.float64))
    for a, d in zip(a3, slice_dim):
        o = offsets.astype(np.float64)  # (K,3)
        mm = np.einsum("ij,kj->ki", a, o) * d[None, :]
        slack = np.abs(a) @ (0.5 * np.ones(3)) * d  # per-axis mm slack
        mmin = np.maximum(np.abs(mm) - slack[None, :], 0.0)
        ax = mmin[:, 0] * d[0] / PSF_CONST
        ay = mmin[:, 1] * d[1] / PSF_CONST
        rr = np.pi * np.sqrt(ax ** 2 + ay ** 2)  # sinc argument
        sinc_env = np.where(rr > 1.0, 1.0 / (rr * rr), 1.0)
        sigz = d[2] / PSF_CONST
        gz = np.exp(-mmin[:, 2] ** 2 / (2.0 * sigz * sigz))
        keep |= (sinc_env * gz) >= eps
    return offsets[keep]


def _offset_weight(geom: SliceGeom, off: jax.Array) -> jax.Array:
    """PSF weight (N,H,W) for one integer offset (3,)."""
    rel = off.astype(jnp.float32)[None, None, None, :] - geom.frac
    mm = jnp.einsum("nij,nhwj->nhwi", geom.a3, rel,
                    precision=jax.lax.Precision.HIGHEST) * \
        geom.slice_dim[:, None, None, :]
    return calc_psf(mm, geom.slice_dim[:, None, None, :])


def _lin_index(vox: jax.Array, shape_zyx: Tuple[int, int, int]):
    """(..., 3) int voxel (x,y,z) -> linear index into [z,y,x].ravel();
    -1 (dropped by scatter mode='drop' / masked in gather) if out of bounds."""
    zs, ys, xs = shape_zyx
    x, y, z = vox[..., 0], vox[..., 1], vox[..., 2]
    inb = ((x >= 0) & (x < xs) & (y >= 0) & (y < ys) & (z >= 0) & (z < zs))
    lin = z * (ys * xs) + y * xs + x
    return jnp.where(inb, lin, -1), inb


def psf_sums(geom: SliceGeom, offsets: np.ndarray,
             vol_shape: Tuple[int, int, int]) -> jax.Array:
    """Per-pixel PSF normalization `sume` (pass 1 of
    gaussianReconstructionKernel3D_tex): sum of w over in-bounds voxels;
    zeroed where <= 0.5 or the pixel is padding."""
    offs = jnp.asarray(offsets)

    def body(acc, off):
        w = _offset_weight(geom, off)
        _, inb = _lin_index(geom.centre + off[None, None, None, :], vol_shape)
        return acc + jnp.where(inb, w, 0.0), None

    acc0 = jnp.zeros(geom.valid.shape, jnp.float32)
    sume, _ = jax.lax.scan(body, acc0, offs)
    return jnp.where(geom.valid & (sume > 0.5), sume, 0.0)


def psf_scatter(geom: SliceGeom, offsets: np.ndarray, sume: jax.Array,
                payloads: Sequence[jax.Array],
                mask_flat: jax.Array,
                vol_shape: Tuple[int, int, int]) -> Tuple[jax.Array, ...]:
    """Transpose-PSF accumulation: out_k[v] += (w/sume) * payload_k[p].

    Only voxels in-bounds and with mask != 0 receive contributions
    (reconstruction_cuda2.cu:270-289, 508-519).  Returns flattened volumes.
    Payload entries must already be zero at invalid pixels.
    """
    offs = jnp.asarray(offsets)
    nvox = vol_shape[0] * vol_shape[1] * vol_shape[2]
    gate = sume > 0.0
    inv_sume = jnp.where(gate, 1.0 / jnp.where(gate, sume, 1.0), 0.0)
    pl = jnp.stack([p.reshape(-1) for p in payloads])  # (P, npix)

    def body(acc, off):
        w = _offset_weight(geom, off) * inv_sume
        lin, inb = _lin_index(geom.centre + off[None, None, None, :],
                              vol_shape)
        linf = lin.reshape(-1)
        m = jnp.where(linf >= 0,
                      jnp.take(mask_flat, jnp.clip(linf, 0), axis=0), 0.0)
        wv = (w.reshape(-1) * m)
        contrib = pl * wv[None, :]
        acc = acc.at[:, linf].add(jnp.where(linf[None, :] >= 0, contrib, 0.0),
                                  mode="drop")
        return acc, None

    acc0 = jnp.zeros((len(payloads), nvox), jnp.float32)
    out, _ = jax.lax.scan(body, acc0, offs)
    return tuple(out[i] for i in range(len(payloads)))


def psf_gather(geom: SliceGeom, offsets: np.ndarray, sume: jax.Array,
               vol_flat: jax.Array, mask_flat: jax.Array,
               vol_shape: Tuple[int, int, int]):
    """Forward projection (simulateSlicesKernel3D_tex): per pixel
    num = sum (w/sume)*vol[v], den = sum (w/sume) over in-bounds+mask voxels.

    Returns (sim, sim_weight, inside): sim = num/den where den > 0 (else 0),
    sim_weight = den, inside = any in-mask voxel touched.
    """
    offs = jnp.asarray(offsets)
    gate = sume > 0.0
    inv_sume = jnp.where(gate, 1.0 / jnp.where(gate, sume, 1.0), 0.0)

    def body(carry, off):
        num, den, inside = carry
        w = _offset_weight(geom, off) * inv_sume
        lin, inb = _lin_index(geom.centre + off[None, None, None, :],
                              vol_shape)
        linc = jnp.clip(lin, 0)
        m = jnp.where(lin >= 0, jnp.take(mask_flat, linc.reshape(-1),
                                         axis=0).reshape(lin.shape), 0.0)
        v = jnp.where(lin >= 0, jnp.take(vol_flat, linc.reshape(-1),
                                         axis=0).reshape(lin.shape), 0.0)
        use = (m != 0)
        num = num + jnp.where(use, w * v, 0.0)
        den = den + jnp.where(use, w, 0.0)
        inside = inside | use
        return (num, den, inside), None

    zero = jnp.zeros(geom.valid.shape, jnp.float32)
    (num, den, inside), _ = jax.lax.scan(
        body, (zero, zero, jnp.zeros_like(geom.valid)), offs)
    ok = (den > 0) & gate & geom.valid
    sim = jnp.where(ok, num / jnp.where(den > 0, den, 1.0), 0.0)
    simw = jnp.where(ok, den, 0.0)
    return sim, simw, inside & ok
