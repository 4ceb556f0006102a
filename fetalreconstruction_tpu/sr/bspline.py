"""Multi-level B-spline scattered-data reconstruction (alternative path).

Reimplements the capability of irtkBSplineReconstruction
(irtkBSplineReconstruction.cc, header API at :76): fit a smooth volume to
the scattered motion-corrected slice samples by multilevel cubic B-spline
approximation (the Lee/Wolberg/Shin BA/MBA algorithm the IRTK code
implements):

- level 0 fits a coarse control lattice to the scattered (position, value)
  samples with the closed-form weighted-BA update
  phi_c = sum_p w_c(p)^2 v_p / sum_p w_c(p)^2 distributed over the 4^3
  support;
- each finer level halves the control spacing and fits the residuals;
- the final volume is the sum of the level evaluations on the recon grid.

Not on the main SVR path (same as the reference); used for smooth
initialization or as a standalone reconstruction mode.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _bspline_w(t):
    """Cubic B-spline basis values for offsets -1..2 given fraction t."""
    t2 = t * t
    t3 = t2 * t
    return (
        (1 - t) ** 3 / 6.0,
        (3 * t3 - 6 * t2 + 4) / 6.0,
        (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0,
        t3 / 6.0,
    )


def _fit_level(pts, vals, grid_shape, spacing):
    """One BA fit: scattered pts (M,3 in voxel coords) -> control lattice.

    Control lattice covers the grid with the given control spacing
    (in voxels); returns (ctrl, lattice_shape)."""
    zs, ys, xs = grid_shape
    nx = int(np.ceil(xs / spacing)) + 3
    ny = int(np.ceil(ys / spacing)) + 3
    nz = int(np.ceil(zs / spacing)) + 3
    u = pts[:, 0] / spacing
    v = pts[:, 1] / spacing
    w = pts[:, 2] / spacing
    iu = jnp.floor(u).astype(jnp.int32)
    iv = jnp.floor(v).astype(jnp.int32)
    iw = jnp.floor(w).astype(jnp.int32)
    fu, fv, fw = u - iu, v - iv, w - iw
    bu = _bspline_w(fu)
    bv = _bspline_w(fv)
    bw = _bspline_w(fw)
    num = jnp.zeros((nz, ny, nx), jnp.float32).reshape(-1)
    den = jnp.zeros((nz, ny, nx), jnp.float32).reshape(-1)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                wt = bu[a] * bv[b] * bw[c]
                cx = iu + a
                cy = iv + b
                cz = iw + c
                inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
                       & (cz >= 0) & (cz < nz))
                lin = jnp.where(inb, cz * ny * nx + cy * nx + cx, -1)
                w2 = wt * wt
                num = num.at[lin].add(jnp.where(inb, w2 * wt * vals, 0.0),
                                      mode="drop")
                den = den.at[lin].add(jnp.where(inb, w2 * wt, 0.0),
                                      mode="drop")
    ctrl = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    return ctrl.reshape(nz, ny, nx)


def _eval_level(ctrl, grid_shape, spacing):
    """Evaluate the control lattice on the full voxel grid (separable)."""
    zs, ys, xs = grid_shape
    nz, ny, nx = ctrl.shape

    def axis_matrix(n_vox, n_ctrl):
        rows = np.zeros((n_vox, n_ctrl), np.float32)
        for i in range(n_vox):
            u = i / spacing
            iu = int(np.floor(u))
            t = u - iu
            for a, wv in enumerate(_bspline_w(np.float64(t))):
                c = iu + a
                if 0 <= c < n_ctrl:
                    rows[i, c] = float(wv)
        return jnp.asarray(rows)

    mx = axis_matrix(xs, nx)
    my = axis_matrix(ys, ny)
    mz = axis_matrix(zs, nz)
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("xc,zyc->zyx", mx, ctrl, precision=hi)
    out = jnp.einsum("yc,zcx->zyx", my, out, precision=hi)
    out = jnp.einsum("zc,cyx->zyx", mz, out, precision=hi)
    return out


def _eval_at_points(ctrl, pts, spacing):
    nz, ny, nx = ctrl.shape
    u = pts[:, 0] / spacing
    v = pts[:, 1] / spacing
    w = pts[:, 2] / spacing
    iu = jnp.floor(u).astype(jnp.int32)
    iv = jnp.floor(v).astype(jnp.int32)
    iw = jnp.floor(w).astype(jnp.int32)
    bu = _bspline_w(u - iu)
    bv = _bspline_w(v - iv)
    bw = _bspline_w(w - iw)
    flat = ctrl.reshape(-1)
    out = jnp.zeros(pts.shape[0], jnp.float32)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                cx = jnp.clip(iu + a, 0, nx - 1)
                cy = jnp.clip(iv + b, 0, ny - 1)
                cz = jnp.clip(iw + c, 0, nz - 1)
                inb = ((iu + a >= 0) & (iu + a < nx) & (iv + b >= 0)
                       & (iv + b < ny) & (iw + c >= 0) & (iw + c < nz))
                val = jnp.take(flat, cz * ny * nx + cy * nx + cx, axis=0)
                out = out + jnp.where(inb, bu[a] * bv[b] * bw[c] * val, 0.0)
    return out


def bspline_reconstruct(points, values, grid_shape: Tuple[int, int, int],
                        levels: int = 4, initial_spacing: float = 0.0):
    """Fit a smooth volume to scattered samples.

    points: (M, 3) continuous voxel coordinates (x, y, z) on the recon
    grid; values: (M,).  Returns a [z,y,x] volume.
    """
    zs, ys, xs = grid_shape
    if initial_spacing <= 0:
        initial_spacing = max(xs, ys, zs) / 4.0
    points = jnp.asarray(points, jnp.float32)
    resid = jnp.asarray(values, jnp.float32)
    out = jnp.zeros(grid_shape, jnp.float32)
    spacing = float(initial_spacing)
    for _ in range(levels):
        ctrl = _fit_level(points, resid, grid_shape, spacing)
        out = out + _eval_level(ctrl, grid_shape, spacing)
        resid = resid - _eval_at_points(ctrl, points, spacing)
        spacing = max(spacing / 2.0, 1.0)
    return out
