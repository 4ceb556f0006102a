"""Separable Gaussian blurring (JAX), matching IRTK's filter semantics.

Reference: IRTKSimple2/image++/src/irtkGaussianBlurring.cc (kernel radius
round(4*sigma/voxelsize), sampled Gaussian, boundary renormalization via
irtkConvolution_1D with SetNormalization(true)) and
irtkGaussianBlurringWithPadding.cc (convolve only over non-padding values,
renormalize by the in-mask kernel mass; padded voxels stay padded).

Implemented as explicit shift-and-accumulate (static unroll over kernel
taps) — XLA fuses these into a few elementwise kernels, with no
convolution-layout overhead for the small kernels used here.
"""
from __future__ import annotations

import jax
from functools import partial as _partial

import jax.numpy as jnp
import numpy as np


def gaussian_kernel1d(sigma_vox: float) -> np.ndarray:
    """Sampled, normalized 1D Gaussian with radius round(4*sigma) (>=0)."""
    r = int(round(4.0 * sigma_vox))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-xs * xs / (2.0 * sigma_vox * sigma_vox)) if sigma_vox > 0 \
        else np.array([1.0])
    k = k / k.sum()
    return k.astype(np.float32)


def _blur_axis(data, kernel: np.ndarray, axis: int):
    """Correlate along one axis with boundary renormalization."""
    r = (len(kernel) - 1) // 2
    if r == 0:
        return data
    out = jnp.zeros_like(data)
    wsum = jnp.zeros_like(data)
    n = data.shape[axis]
    ones = jnp.ones_like(data)
    for tap in range(len(kernel)):
        shift = tap - r
        w = float(kernel[tap])
        # value at index i comes from index i+shift
        lo = max(shift, 0)
        hi = min(n + shift, n)
        if hi <= lo:          # kernel wider than the axis: tap off the edge
            continue
        src = jnp.take(data, jnp.arange(lo, hi), axis=axis)
        dst_lo = lo - shift
        pad_before = [(0, 0)] * data.ndim
        pad_before[axis] = (dst_lo, n - dst_lo - (hi - lo))
        out = out + w * jnp.pad(src, pad_before)
        msk = jnp.take(ones, jnp.arange(lo, hi), axis=axis)
        wsum = wsum + w * jnp.pad(msk, pad_before)
    return out / wsum


def gaussian_blur(data, sigma_mm: float, spacing_xyz):
    """Hashable-coercing wrapper (callers pass ndarray spacings)."""
    return _gaussian_blur_jit(data, float(sigma_mm),
                              tuple(float(s) for s in spacing_xyz))


@_partial(jax.jit, static_argnames=("sigma_mm", "spacing_xyz"))
def _gaussian_blur_jit(data, sigma_mm: float, spacing_xyz):
    """Blur a [z,y,x] (or [..., y, x] 2D batch) array.

    sigma_mm is in millimetres; spacing_xyz = (dx, dy, dz) in mm.
    For 2D batches pass data of shape (..., Y, X) and only dx, dy are used.
    """
    dx, dy = float(spacing_xyz[0]), float(spacing_xyz[1])
    out = data
    kx = gaussian_kernel1d(sigma_mm / dx)
    ky = gaussian_kernel1d(sigma_mm / dy)
    out = _blur_axis(out, kx, axis=out.ndim - 1)
    out = _blur_axis(out, ky, axis=out.ndim - 2)
    if data.ndim >= 3 and len(spacing_xyz) >= 3 and data.shape[-3] > 1:
        dz = float(spacing_xyz[2])
        kz = gaussian_kernel1d(sigma_mm / dz)
        out = _blur_axis(out, kz, axis=out.ndim - 3)
    return out


def _blur_axis_masked(data, mask, kernel: np.ndarray, axis: int):
    r = (len(kernel) - 1) // 2
    if r == 0:
        return data * mask, mask
    n = data.shape[axis]
    out = jnp.zeros_like(data)
    wsum = jnp.zeros_like(data)
    masked = data * mask
    for tap in range(len(kernel)):
        shift = tap - r
        w = float(kernel[tap])
        lo = max(shift, 0)
        hi = min(n + shift, n)
        if hi <= lo:
            continue
        src = jnp.take(masked, jnp.arange(lo, hi), axis=axis)
        msk = jnp.take(mask, jnp.arange(lo, hi), axis=axis)
        dst_lo = lo - shift
        pad = [(0, 0)] * data.ndim
        pad[axis] = (dst_lo, n - dst_lo - (hi - lo))
        out = out + w * jnp.pad(src, pad)
        wsum = wsum + w * jnp.pad(msk, pad)
    return out, wsum


def gaussian_blur_padded(data, sigma_mm: float, spacing_xyz,
                         padding: float = -1.0):
    """Hashable-coercing wrapper."""
    return _gaussian_blur_padded_jit(data, float(sigma_mm),
                                     tuple(float(s) for s in spacing_xyz),
                                     float(padding))


@_partial(jax.jit, static_argnames=("sigma_mm", "spacing_xyz", "padding"))
def _gaussian_blur_padded_jit(data, sigma_mm: float, spacing_xyz,
                         padding=-1.0):
    """Padding-aware blur: voxels == padding are excluded and stay padded
    (irtkGaussianBlurringWithPadding semantics, applied separably)."""
    mask = (data > padding).astype(data.dtype)
    dx, dy = float(spacing_xyz[0]), float(spacing_xyz[1])
    num, den = _blur_axis_masked(data, mask, gaussian_kernel1d(sigma_mm / dx),
                                 axis=data.ndim - 1)
    cur = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    num, den = _blur_axis_masked(cur, mask, gaussian_kernel1d(sigma_mm / dy),
                                 axis=data.ndim - 2)
    cur = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    if data.ndim >= 3 and len(spacing_xyz) >= 3 and data.shape[-3] > 1:
        dz = float(spacing_xyz[2])
        num, den = _blur_axis_masked(cur, mask,
                                     gaussian_kernel1d(sigma_mm / dz),
                                     axis=data.ndim - 3)
        cur = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    return jnp.where(mask > 0, cur, padding)
