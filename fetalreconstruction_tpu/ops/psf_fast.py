"""Fast PSF engine: per-stack separable convolution + trilinear sampling.

The exact engine (ops/psf.py) anchors the PSF at integer volume voxels
around round(F p) — a faithful transcription of the reference CUDA
kernels, but its transpose needs ~K^3 x n_pixels scatter-adds (6e9 for
the canonical run).  This module is the reformulation used for
production runs:

    sim[p]  = (K_s * (vol . mask))(F_s p) / (K_s * mask)(F_s p)
    addon   = mask . (K_s * splat(payload / sume))
    sume[p] = (K_s * 1_volume)(F_s p)

where K_s is the PSF rasterized ON THE VOLUME GRID in the orientation of
stack s (K_s[o] = calcPSF(A3_s o . sliceDim)), `*` is volume convolution
(zero-padded), and sampling/splatting is trilinear at the CONTINUOUS
position F_s p.  This is algebraically the reference model with two
deliberate deviations (documented, validated against the exact engine in
tests):

1. continuous PSF anchoring instead of rounding to the nearest voxel
   (sub-voxel quantization removed — physically MORE correct);
2. one PSF orientation per STACK (the identity-motion A3 of its slices'
   common geometry) instead of per slice; per-slice motion still enters
   exactly through the sampling positions F_s p.  Slice-level rotations of
   a few degrees rotate the smooth PSF kernel negligibly.

K_s is decomposed into a sum of separable rank-1 triads (two-stage SVD,
energy cutoff), so each convolution is a handful of shifted
multiply-add passes; the only scatter left is the 8-corner trilinear
splat (~28M updates for the canonical run) with addon/cmap sharing one
index set in a single two-column scatter.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .psf import PSF_CONST, calc_psf


class FastGeom(NamedTuple):
    """Per-pixel continuous sampling geometry.

    xp:    (N, H, W, 3) f32  continuous volume position F_s p (x, y, z)
    valid: (N, H, W)   bool
    sume:  (N, H, W)   f32   PSF normalization (conv(1))(xp), 0-gated
    sid:   (N,)        i32   stack index per slice — selects the per-stack
           kernel/table; replaces the round-1 per-stack lo:hi slicing so
           the slice axis shards cleanly (every per-slice op is elementwise
           in sid; all per-STACK work is volume-space and replicated)
    den:   (N, H, W)   f32   cached (conv(mask))(xp) — mask AND xp are
           constant between geometry rebuilds, so the simulate
           denominator is gathered ONCE here instead of per call; an
           (N, H, W) per-slice array that shards over the slice axis
    """
    xp: jax.Array
    valid: jax.Array
    sume: jax.Array
    sid: jax.Array
    den: jax.Array


def stack_kernel(a3: np.ndarray, slice_dim: np.ndarray,
                 support: int) -> np.ndarray:
    """Rasterize the PSF on the volume grid for one stack orientation.

    a3: (3,3) linear part of F^{-1} for the stack's identity-motion
    geometry; slice_dim: (3,).  Returns [z,y,x]-ordered (K,K,K) kernel.
    """
    centre = (support - 1) // 2
    r = np.arange(support) - centre
    oz, oy, ox = np.meshgrid(r, r, r, indexing="ij")
    o = np.stack([ox, oy, oz], axis=-1).astype(np.float64)  # (K,K,K,3)
    mm = np.einsum("ij,abcj->abci", a3, o) * slice_dim[None, None, None, :]
    k = np.asarray(calc_psf(jnp.asarray(mm, jnp.float32),
                            jnp.asarray(slice_dim, jnp.float32)))
    return k.astype(np.float32)


def separable_decompose(kernel: np.ndarray, tol: float = 1e-3,
                        max_terms: int = 8):
    """Decompose (K,K,K) kernel into rank-1 triads via two-stage SVD.

    Returns list of (kz, ky, kx, coeff) with
    kernel ~= sum coeff * kz x ky x kx.
    """
    kz, ky, kx = kernel.shape
    m1 = kernel.reshape(kz, ky * kx)
    u, s, vt = np.linalg.svd(m1, full_matrices=False)
    total = np.sqrt((s ** 2).sum())
    terms = []
    for i in range(len(s)):
        if s[i] < tol * total or len(terms) >= max_terms:
            break
        m2 = vt[i].reshape(ky, kx)
        u2, s2, vt2 = np.linalg.svd(m2, full_matrices=False)
        t2 = np.sqrt((s2 ** 2).sum())
        for j in range(len(s2)):
            if s2[j] < tol * t2 or len(terms) >= max_terms:
                break
            terms.append((u[:, i].astype(np.float32),
                          u2[:, j].astype(np.float32),
                          vt2[j].astype(np.float32),
                          float(s[i] * s2[j])))
    return terms


def _conv1d_axis(arr, taps: np.ndarray, axis: int):
    """Zero-padded 1D correlation: out[i] = sum_t taps[t] arr[i + t - r]."""
    k = len(taps)
    r = (k - 1) // 2
    n = arr.shape[axis]
    out = jnp.zeros_like(arr)
    for t in range(k):
        shift = t - r
        w = float(taps[t])
        if w == 0.0:
            continue
        lo = max(shift, 0)
        hi = min(n + shift, n)
        if hi <= lo:
            continue
        src = jax.lax.slice_in_dim(arr, lo, hi, axis=axis)
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (lo - shift, n - (lo - shift) - (hi - lo))
        out = out + w * jnp.pad(src, pad)
    return out


def _conv1d_axis_adj(arr, taps: np.ndarray, axis: int):
    """Exact adjoint of _conv1d_axis: out[j] = sum_t taps[t] arr[j - t + r]."""
    k = len(taps)
    r = (k - 1) // 2
    n = arr.shape[axis]
    out = jnp.zeros_like(arr)
    for t in range(k):
        shift = r - t
        w = float(taps[t])
        if w == 0.0:
            continue
        lo = max(shift, 0)
        hi = min(n + shift, n)
        if hi <= lo:
            continue
        src = jax.lax.slice_in_dim(arr, lo, hi, axis=axis)
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (lo - shift, n - (lo - shift) - (hi - lo))
        out = out + w * jnp.pad(src, pad)
    return out


def conv_separable(vol, terms, flip: bool = False):
    """Apply sum of separable triads to a (..., z, y, x) volume.

    The FULL kernel is centrally symmetric (psf(-mm) = psf(mm)) so the
    summed operator equals its own adjoint, but the individual SVD triads
    are not per-axis symmetric: the adjoint pass must use per-axis-flipped
    taps (flip=True), which reconstitutes the centrally-flipped == original
    kernel term-by-term consistently.

    NOTE on even support: with an even kernel size the tap at index
    (k-1)//2 is treated as centre, so flipping also shifts by one — both
    passes must agree on the convention, which flip=True provides.

    Each 1-D pass is a chain of shifted multiply-adds (one per non-zero
    tap), which XLA fuses into a few elementwise kernels."""
    out = jnp.zeros_like(vol)
    nd = vol.ndim
    for kzv, kyv, kxv, c in terms:
        if flip:
            t = _conv1d_axis_adj(vol, kxv, axis=nd - 1)
            t = _conv1d_axis_adj(t, kyv, axis=nd - 2)
            t = _conv1d_axis_adj(t, kzv, axis=nd - 3)
        else:
            t = _conv1d_axis(vol, kxv, axis=nd - 1)
            t = _conv1d_axis(t, kyv, axis=nd - 2)
            t = _conv1d_axis(t, kzv, axis=nd - 3)
        out = out + c * t
    return out


def make_shingle(vols):
    """Stack volumes into a CORNER-MAJOR shingled table for fast gathers.

    vols: sequence of P [z,y,x] arrays (same shape).  Returns
    (8*P, (zs+1)(ys+1)(xs+1)) f32: row p*8+c holds, flattened over the
    one-voxel-front-halo grid (position index = ((z+1)(ys+1) + y+1)
    (xs+1) + x+1, so floor index -1 is valid), corner c of volume p's
    2x2x2 window starting at that voxel; zero outside the volume.

    Corner-major keeps the minor dimension long, and one axis-1 jnp.take
    fetches all 8P corner values per sample.
    """
    cols = []
    for vol in vols:
        for cw in (0, 1):
            for cv in (0, 1):
                for cu in (0, 1):
                    # window value at padded-row voxel (z,y,x) = vol[z+cw,
                    # y+cv, x+cu]; rows start at voxel -1 per axis.
                    sh = jnp.pad(vol, ((1 - cw, cw), (1 - cv, cv),
                                       (1 - cu, cu)))
                    cols.append(sh.reshape(-1))
    return jnp.stack(cols, axis=0)


def _corner_weights(xp):
    """floor indices + per-corner trilinear weights for (...,3) positions.

    Returns (ui, vi, wi, wts) with wts shaped (..., 8) ordered to match
    make_shingle's corner order ((cw, cv, cu) lexicographic).
    """
    x, y, z = xp[..., 0], xp[..., 1], xp[..., 2]
    u = jnp.floor(x); v = jnp.floor(y); w = jnp.floor(z)
    du = x - u; dv = y - v; dw = z - w
    wts = []
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                wts.append((du if cu else 1 - du) * (dv if cv else 1 - dv)
                           * (dw if cw else 1 - dw))
    return (u.astype(jnp.int32), v.astype(jnp.int32), w.astype(jnp.int32),
            jnp.stack(wts, axis=-1))


def shingle_rows(vol_shape) -> int:
    """Rows per volume in a make_shingle table."""
    zs, ys, xs = vol_shape
    return (zs + 1) * (ys + 1) * (xs + 1)


def shingle_gather(shingle, xp, vol_shape, n_vols=1, sid=None):
    """Trilinear sample from a make_shingle table at (..., 3) (x,y,z).

    shingle: (8*n_vols, S*R) corner-major table (column-stacked per
    stack when sid is given — each sample reads column s*R + lin of its
    own stack's span).  Returns a tuple of n_vols arrays shaped
    xp.shape[:-1].  Exactly equivalent to per-corner masked takes
    (partial sums at the volume boundary included — the halo positions
    carry the correct mixed in/out-of-bounds windows).
    """
    zs, ys, xs = vol_shape
    R = shingle_rows(vol_shape)
    ui, vi, wi, wts = _corner_weights(xp)
    inb = ((ui >= -1) & (ui < xs) & (vi >= -1) & (vi < ys)
           & (wi >= -1) & (wi < zs))
    lin = ((wi + 1) * (ys + 1) + (vi + 1)) * (xs + 1) + (ui + 1)
    lin = jnp.clip(lin, 0, R - 1)
    if sid is not None:
        nd = lin.ndim - 1  # broadcast (N,) over the trailing (H, W) dims
        lin = lin + sid.astype(jnp.int32).reshape(
            sid.shape + (1,) * nd) * R
    cols = jnp.take(shingle, lin.reshape(-1), axis=1)  # (8*n_vols, Npix)
    outs = []
    for p in range(n_vols):
        acc = jnp.zeros(lin.shape, jnp.float32)
        for c in range(8):
            acc = acc + cols[8 * p + c].reshape(lin.shape) * wts[..., c]
        outs.append(jnp.where(inb, acc, 0.0))
    return tuple(outs)


def trilinear_gather(vol, xp):
    """Trilinear sample [z,y,x] volume at (..., 3) continuous (x,y,z);
    zero outside.  One-shot convenience wrapper over shingle_gather; hot
    callers build the shingle once and reuse it."""
    (out,) = shingle_gather(make_shingle([vol]), xp, vol.shape, 1)
    return out


def splat2(xp, pay_a, pay_b, vol_shape, sid=None, n_stacks=1):
    """Adjoint of shingle_gather for two payloads, per stack.

    Every pixel adds weight * payload to each of its 8 trilinear corner
    voxels; corners outside the volume are dropped.  One scatter-add of
    (value_a, value_b) rows into a dense (n_stacks * zs * ys * xs, 2)
    accumulator covers all stacks (row offset sid * zs * ys * xs), so the
    pixel axis shards over a mesh.  The summation order of the scatter is
    unspecified, so results agree with a sequential sum to float rounding.

    Returns (n_stacks, 2, zs, ys, xs) f32.
    """
    zs, ys, xs = vol_shape
    nvox = zs * ys * xs
    ui, vi, wi, wts = _corner_weights(xp)
    base = 0
    if sid is not None:
        nd = ui.ndim - 1
        base = sid.astype(jnp.int32).reshape(sid.shape + (1,) * nd) * nvox
    rows = []
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                zc, yc, xc = wi + cw, vi + cv, ui + cu
                inb = ((zc >= 0) & (zc < zs) & (yc >= 0) & (yc < ys)
                       & (xc >= 0) & (xc < xs))
                lin = base + (zc * ys + yc) * xs + xc
                rows.append(jnp.where(inb, lin, n_stacks * nvox))
    rows = jnp.stack(rows, axis=-1).reshape(-1)
    # wts is ordered (cw, cv, cu) like rows; payload axis last -> (..., 8, 2)
    upd = jnp.stack([wts * pay_a[..., None], wts * pay_b[..., None]],
                    axis=-1).reshape(-1, 2)
    acc = jnp.zeros((n_stacks * nvox, 2), jnp.float32)
    acc = acc.at[rows].add(upd, mode="drop")
    return jnp.moveaxis(acc.reshape(n_stacks, zs, ys, xs, 2), -1, 1)


def trilinear_splat2(xp, pay_a, pay_b, vol_shape):
    """Adjoint of trilinear_gather (shingle_gather) for TWO payloads."""
    out = splat2(xp, pay_a, pay_b, vol_shape)
    return out[0, 0], out[0, 1]


# ---------------------------------------------------------------------------
# engine construction
# ---------------------------------------------------------------------------

class FastPSF:
    """Per-run fast-engine state: per-stack separable kernels + slice
    grouping.  Host-side object; all members are static arrays/lists so the
    jitted functions close over them."""

    def __init__(self, stack_a3: np.ndarray, stack_dims: np.ndarray,
                 stack_slice_ranges: Sequence[Tuple[int, int]],
                 support: int, tol: float = 1e-3):
        self.support = support
        self.ranges = list(stack_slice_ranges)
        self.terms = []
        for a3, dims in zip(stack_a3, stack_dims):
            k = stack_kernel(np.asarray(a3, np.float64),
                             np.asarray(dims, np.float64), support)
            self.terms.append(separable_decompose(k, tol))

    @classmethod
    def from_batch(cls, batch, recon_w2i: np.ndarray, support: int,
                   tol: float = 1e-3):
        """Build from a SliceBatch using each stack's identity-motion
        geometry (first slice of the stack)."""
        ranges = []
        a3s, dims = [], []
        idx = np.asarray(batch.stack_index)
        for s in np.unique(idx):
            members = np.nonzero(idx == s)[0]
            ranges.append((int(members[0]), int(members[-1]) + 1))
            fwd = np.asarray(recon_w2i) @ batch.i2w[members[0]]
            a3s.append(np.linalg.inv(fwd[:3, :3]))
            dims.append(batch.dims[members[0]])
        return cls(np.asarray(a3s), np.asarray(dims), ranges, support, tol)


def default_stack_id(fast: FastPSF, n: int) -> np.ndarray:
    """(n,) stack index from the FastPSF slice ranges; rows past the last
    range (mesh padding) inherit the last stack id."""
    sid = np.full((n,), len(fast.ranges) - 1, np.int32)
    for s, (lo, hi) in enumerate(fast.ranges):
        sid[lo:min(hi, n)] = s
    return sid


def make_fast_geom(fast: FastPSF, fwd, valid, vol_shape, mask=None,
                   stack_id=None):
    """Continuous per-pixel positions + sume (conv(1))(xp) + cached
    per-stack conv(mask) tables.

    fwd: (N,4,4) = reconW2I @ T_s @ sliceI2W; mask: [z,y,x] (ones if None);
    stack_id: (N,) i32 (derived from fast.ranges if omitted).  Every
    per-slice operation is elementwise in stack_id, so the slice axis
    shards over a mesh; the per-stack convolutions are volume-space and
    run replicated.
    """
    n, h, w = valid.shape
    if stack_id is None:
        stack_id = jnp.asarray(default_stack_id(fast, n))
    sid = jnp.asarray(stack_id, jnp.int32)
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    xp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, None, None]
          + fwd[:, None, None, :3, 3])
    ones = jnp.ones(vol_shape, jnp.float32)
    if mask is None:
        mask = ones
    mask = mask.reshape(vol_shape)
    # per-stack conv(1) and conv(mask) volumes, column-stacked into ONE
    # fused corner-major table (16, S*R) and gathered once: both sume
    # and the simulate denominator den are geometry constants (the
    # tables themselves are NOT kept — simulate only rebuilds/gathers
    # the conv(vol*mask) numerator per call)
    tab = jnp.concatenate(
        [jnp.concatenate([make_shingle([conv_separable(ones, t)])
                          for t in fast.terms], axis=1),
         jnp.concatenate([make_shingle([conv_separable(mask, t)])
                          for t in fast.terms], axis=1)], axis=0)
    sume, den = shingle_gather(tab, xp, vol_shape, 2, sid=sid)
    sume = jnp.where(valid & (sume > 0.5), sume, 0.0)
    return FastGeom(xp=xp, valid=valid, sume=sume, sid=sid, den=den)


def fast_simulate(fast: FastPSF, geom: FastGeom, vol, mask, vol_shape):
    """sim, simw, inside — fast analog of psf_gather.

    The denominator (conv(mask))(xp) comes pre-GATHERED from the
    geometry cache (geom.den: mask and xp are constant between geometry
    rebuilds), so the per-call work is only the conv(vol*mask) numerator
    table and one 8-row gather."""
    vm = vol * mask
    num_tab = jnp.concatenate(
        [make_shingle([conv_separable(vm, t)]) for t in fast.terms],
        axis=1)
    (num,) = shingle_gather(num_tab, geom.xp, vol_shape, 1, sid=geom.sid)
    den = geom.den
    sim = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    gate = (geom.sume > 0.0) & geom.valid
    inside = gate & (den > 0)
    simw = jnp.where(inside,
                     den / jnp.where(geom.sume > 0, geom.sume, 1.0),
                     0.0)
    sim = jnp.where(inside, sim, 0.0)
    return sim, simw, inside


def fast_scatter2(fast: FastPSF, geom: FastGeom, pay_a, pay_b, mask,
                  vol_shape):
    """Transpose accumulation of two payloads (e.g. addon + cmap).

    out_k = mask . sum_stacks K_s * splat(payload_k / sume).
    Payloads must be zero at invalid pixels.  ONE stack-offset scatter
    covers all stacks (shardable over slices); the per-stack adjoint
    convolution then runs on the dense volumes.
    """
    inv = jnp.where(geom.sume > 0, 1.0 / jnp.where(geom.sume > 0,
                                                   geom.sume, 1.0), 0.0)
    a = pay_a * inv
    b = pay_b * inv
    dense = splat2(geom.xp, a, b, vol_shape, sid=geom.sid,
                   n_stacks=len(fast.terms))
    out = jnp.zeros((2,) + tuple(vol_shape), jnp.float32)
    for s, terms in enumerate(fast.terms):
        # batch both payload fields through one adjoint conv pass
        out = out + conv_separable(dense[s], terms, flip=True)
    m = (mask != 0).astype(jnp.float32)
    return out[0] * m, out[1] * m
