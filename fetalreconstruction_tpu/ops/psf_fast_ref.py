"""NumPy float64 reference of the fast PSF engine (ops/psf_fast.py).

A plain transcription of the same operators, independent of the jitted
code: trilinear gather and splat by explicit per-corner indexing
(np.bincount for the splat), and the separable convolutions by
scipy.ndimage.correlate1d.  Everything runs on the host in float64.  The
tests check the engine against it on the CPU, and chip_smoke.py checks
the device kernels against it at canonical widths.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def _corners(xp):
    """Yield (z, y, x, weight) for the 8 trilinear corners of (..., 3)
    (x, y, z) positions, in the engine's (cw, cv, cu) order."""
    xp = np.asarray(xp, np.float64)
    x, y, z = xp[..., 0], xp[..., 1], xp[..., 2]
    u, v, w = np.floor(x), np.floor(y), np.floor(z)
    du, dv, dw = x - u, y - v, z - w
    ui, vi, wi = u.astype(np.int64), v.astype(np.int64), w.astype(np.int64)
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                wt = ((du if cu else 1 - du) * (dv if cv else 1 - dv)
                      * (dw if cw else 1 - dw))
                yield wi + cw, vi + cv, ui + cu, wt


def _stack_index(sid, shape):
    """Per-pixel stack index broadcast from per-slice (N,) sid."""
    if sid is None:
        return np.zeros(shape, np.int64)
    sid = np.asarray(sid, np.int64)
    return np.broadcast_to(sid.reshape(sid.shape + (1,) * (len(shape) - 1)),
                           shape)


def splat2(xp, pay_a, pay_b, vol_shape, sid=None, n_stacks=1):
    """8-corner trilinear splat of two payloads -> (S, 2, z, y, x)."""
    zs, ys, xs = vol_shape
    nvox = zs * ys * xs
    pa = np.asarray(pay_a, np.float64)
    pb = np.asarray(pay_b, np.float64)
    s = _stack_index(sid, pa.shape)
    out = np.zeros((2, n_stacks * nvox))
    for zc, yc, xc, wt in _corners(xp):
        inb = ((zc >= 0) & (zc < zs) & (yc >= 0) & (yc < ys)
               & (xc >= 0) & (xc < xs))
        lin = (s * nvox + (zc * ys + yc) * xs + xc)[inb]
        out[0] += np.bincount(lin, (wt * pa)[inb], n_stacks * nvox)
        out[1] += np.bincount(lin, (wt * pb)[inb], n_stacks * nvox)
    return out.reshape(2, n_stacks, zs, ys, xs).transpose(1, 0, 2, 3, 4)


def gather(vols, xp, sid=None):
    """Trilinear sample of per-stack volumes (S, z, y, x) at (..., 3);
    zero outside the volume."""
    vols = np.asarray(vols, np.float64)
    _, zs, ys, xs = vols.shape
    s = _stack_index(sid, np.shape(xp)[:-1])
    out = np.zeros(s.shape)
    for zc, yc, xc, wt in _corners(xp):
        inb = ((zc >= 0) & (zc < zs) & (yc >= 0) & (yc < ys)
               & (xc >= 0) & (xc < xs))
        val = vols[s, np.clip(zc, 0, zs - 1), np.clip(yc, 0, ys - 1),
                   np.clip(xc, 0, xs - 1)]
        out += np.where(inb, wt * val, 0.0)
    return out


def conv1d(arr, taps, axis, adjoint=False):
    """Zero-padded 1-D pass with the engine's centre convention (tap
    (k-1)//2 is centre): out[i] = sum_t taps[t] arr[i + t - r], or its
    adjoint out[j] = sum_t taps[t] arr[j - t + r]."""
    taps = np.asarray(taps, np.float64)
    if adjoint:
        return ndimage.correlate1d(arr, taps[::-1], axis=axis,
                                   mode="constant", cval=0.0, origin=0)
    origin = -1 if len(taps) % 2 == 0 else 0
    return ndimage.correlate1d(arr, taps, axis=axis, mode="constant",
                               cval=0.0, origin=origin)


def conv_separable(vol, terms, flip=False):
    """Sum of separable triads over the last three axes of vol."""
    vol = np.asarray(vol, np.float64)
    nd = vol.ndim
    out = np.zeros_like(vol)
    for kz, ky, kx, c in terms:
        t = conv1d(vol, kx, nd - 1, flip)
        t = conv1d(t, ky, nd - 2, flip)
        t = conv1d(t, kz, nd - 3, flip)
        out += c * t
    return out


def scatter2(terms_per_stack, xp, sid, sume, pay_a, pay_b, mask,
             vol_shape):
    """Reference of psf_fast.fast_scatter2: mask . sum_s K_s^T *
    splat(payload / sume), for two payloads."""
    sume = np.asarray(sume, np.float64)
    inv = np.where(sume > 0, 1.0 / np.where(sume > 0, sume, 1.0), 0.0)
    dense = splat2(xp, np.asarray(pay_a, np.float64) * inv,
                   np.asarray(pay_b, np.float64) * inv, vol_shape, sid,
                   len(terms_per_stack))
    out = np.zeros((2,) + tuple(vol_shape))
    for s, terms in enumerate(terms_per_stack):
        out += conv_separable(dense[s], terms, flip=True)
    m = (np.asarray(mask) != 0)
    return out[0] * m, out[1] * m


def simulate(terms_per_stack, xp, sid, sume, den, valid, vol, mask):
    """Reference of psf_fast.fast_simulate given the same geometry
    (sume, den, valid): returns (sim, simw, inside)."""
    vm = np.asarray(vol, np.float64) * np.asarray(mask, np.float64)
    num = gather(np.stack([conv_separable(vm, t) for t in terms_per_stack]),
                 xp, sid)
    den = np.asarray(den, np.float64)
    sume = np.asarray(sume, np.float64)
    inside = (sume > 0) & np.asarray(valid) & (den > 0)
    sim = np.where(inside, num / np.where(den > 0, den, 1.0), 0.0)
    simw = np.where(inside, den / np.where(sume > 0, sume, 1.0), 0.0)
    return sim, simw, inside
