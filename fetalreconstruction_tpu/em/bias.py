"""Per-slice bias field estimation and volume bias normalization.

Reimplements:
- ParallelBias (irtkReconstructionGPU.cc:3796-3902): weighted log-residual
  field per slice, Gaussian-blurred (sigma = _sigma_bias, default 12 mm),
  zero-mean normalized;
- ParallelNormaliseBias + NormaliseBias (.cc:4578-4740): scatter per-slice
  bias (minus log scale) into the volume via the PSF, divide by volume
  weights, mask, blur, divide by blurred mask, exp-correct the volume.

Like the reference GPU path (Reconstruction::CorrectBias "assuming globally
constant pixel size"), the blur kernel uses one in-plane spacing for the
whole batch.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops import psf as psf_ops
from ..ops.gaussian import gaussian_blur, gaussian_kernel1d, _blur_axis
from .robust import corrected_slice


def bias_step(slices, valid, bias, scale, weights, sim, simw,
              sigma_bias_mm, spacing_xy, global_bias_correction=False):
    """One bias-field update for all slices. Returns new bias (N,H,W)."""
    s = corrected_slice(slices, bias, scale)
    conf = valid & (simw > 0.99)
    wb0 = jnp.where(conf, weights * s, 0.0)
    ok = conf & (sim > 1.0) & (s > 1.0)
    wres0 = jnp.where(ok, jnp.log(jnp.maximum(s, 1e-6)
                                  / jnp.maximum(sim, 1e-6)) * wb0, 0.0)
    # 2D in-plane Gaussian blur of both fields (slices are 2D images)
    wres = gaussian_blur(wres0, sigma_bias_mm, spacing_xy)
    wb = gaussian_blur(wb0, sigma_bias_mm, spacing_xy)
    new_bias = bias + jnp.where(valid & (wb > 0),
                                wres / jnp.where(wb > 0, wb, 1.0), 0.0)
    if not global_bias_correction:
        num = jnp.sum(valid, axis=(1, 2))
        mean = jnp.sum(jnp.where(valid, new_bias, 0.0), axis=(1, 2)) \
            / jnp.maximum(num, 1)
        new_bias = jnp.where(valid & (num[:, None, None] > 0),
                             new_bias - mean[:, None, None], new_bias)
    return new_bias


def bias_correct_volume(recon, original, mask, min_intensity, max_intensity,
                        low_intensity_cutoff, sigma_bias_mm, vol_spacing):
    """Remove the low-frequency residual between the updated volume and the
    previous-iteration volume (BiasCorrectVolume,
    irtkReconstructionGPU.cc:4430-4501; called from the CPU Superresolution
    at 4107-4108 when global bias correction is on).

    residual = log(recon/original) where mask==1 and both exceed
    low_intensity_cutoff * max_intensity; Gaussian-blur residual and the
    weight image, divide, exp -> multiplicative bias field; divide the
    volume by it inside the mask and clamp to [0.9 min, 1.1 max].
    """
    cutoff = low_intensity_cutoff * max_intensity
    ok = (mask == 1) & (original > cutoff) & (recon > cutoff)
    residual = jnp.where(ok, jnp.log(jnp.maximum(recon, 1e-30)
                                     / jnp.maximum(original, 1e-30)), 0.0)
    weights = jnp.where(ok, 1.0, 0.0)
    residual = gaussian_blur(residual, sigma_bias_mm, vol_spacing)
    weights = gaussian_blur(weights, sigma_bias_mm, vol_spacing)
    field = jnp.exp(jnp.where(weights != 0,
                              residual / jnp.where(weights != 0, weights,
                                                   1.0), 0.0))
    corrected = jnp.clip(recon / field, 0.9 * min_intensity,
                         1.1 * max_intensity)
    return jnp.where(mask == 1, corrected, recon)


def normalise_bias(geom, offsets, sume, slices_valid, bias, scale,
                   recon, vol_weights, mask, mask_flat, vol_shape,
                   sigma_bias_mm, vol_spacing, axis_name=None):
    """Remove average slice bias from the volume (NormaliseBias).

    axis_name: slice-sharded mesh axis — the scatter output is a partial
    volume per shard, combined by psum (the all-reduce replacing the
    reference's peer-memcpy reduce, reconstruction_cuda2.cu:2225-2239).
    Returns the corrected volume.
    """
    import jax
    logs = jnp.log(jnp.maximum(scale, 1e-30))
    b = jnp.where(slices_valid & (scale[:, None, None] > 0),
                  bias - logs[:, None, None], bias)
    payload = jnp.where(slices_valid, b, 0.0)
    (vol_bias_flat,) = psf_ops.psf_scatter(geom, offsets, sume, [payload],
                                           mask_flat, vol_shape)
    vol_bias = vol_bias_flat.reshape(vol_shape)
    if axis_name is not None:
        vol_bias = jax.lax.psum(vol_bias, axis_name)
    ok = vol_weights > 0
    vol_bias = jnp.where(ok, vol_bias / jnp.where(ok, vol_weights, 1.0), 0.0)
    # mask, blur bias and mask, divide
    vol_bias = jnp.where(mask != 0, vol_bias, 0.0)
    m = (mask != 0).astype(recon.dtype)
    vol_bias = gaussian_blur(vol_bias, sigma_bias_mm, vol_spacing)
    m_blur = gaussian_blur(m, sigma_bias_mm, vol_spacing)
    vol_bias = jnp.where(m_blur != 0,
                         vol_bias / jnp.where(m_blur != 0, m_blur, 1.0), 0.0)
    return jnp.where(recon != -1.0, recon / jnp.exp(-vol_bias), recon), \
        vol_bias
