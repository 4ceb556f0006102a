"""Fast PSF engine vs the exact (reference-faithful) engine.

The fast engine replaces NN-anchored offsets with continuous trilinear
anchoring and per-stack kernels — results must agree closely with the
exact engine on realistic geometry, and its forward/adjoint pair must be
consistent (<u, A v> == <A^T u, v>).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from fetalreconstruction_tpu.core.geometry import ImageAttributes
from fetalreconstruction_tpu.ops import psf as psf_exact
from fetalreconstruction_tpu.ops import psf_fast as pf
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu.pipeline import svr_core

from phantom import make_ground_truth, simulate_stacks


@pytest.fixture(scope="module")
def setup():
    # reference-like geometry: PSF in-plane width ~1.2 recon voxels
    gt = make_ground_truth(n=32, spacing=1.25)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=1.6, dz=2.5)
    batch = create_slices(stacks, [5.0, 5.0])
    ra = gt.attr
    support = psf_exact.reference_support(batch.dims, ra.dx, 1.0, 12)
    offsets = psf_exact.make_offsets(support)
    n = batch.n_slices
    fwd = np.einsum("ij,njk->nik", ra.w2i(), batch.i2w).astype(np.float32)
    valid = jnp.asarray(batch.data != -1.0)
    geom = psf_exact.make_slice_geom(jnp.asarray(fwd),
                                     jnp.asarray(batch.dims), valid)
    sume = psf_exact.psf_sums(geom, offsets, ra.shape_zyx)
    fast = pf.FastPSF.from_batch(batch, ra.w2i(), support)
    fgeom = pf.make_fast_geom(fast, jnp.asarray(fwd), valid, ra.shape_zyx)
    mask = jnp.ones(ra.shape_zyx, jnp.float32)
    return dict(gt=gt, batch=batch, ra=ra, offsets=offsets, geom=geom,
                sume=sume, fast=fast, fgeom=fgeom, mask=mask, valid=valid)


def test_kernel_decomposition_accuracy(setup):
    fast = setup["fast"]
    for (a3, dims), terms in zip(
            [(None, None)] * len(fast.terms), fast.terms):
        assert 1 <= len(terms) <= 8
    # reconstruct kernel from triads and compare
    batch = setup["batch"]
    ra = setup["ra"]
    fwd = ra.w2i() @ batch.i2w[0]
    a3 = np.linalg.inv(fwd[:3, :3])
    k = pf.stack_kernel(a3, batch.dims[0].astype(np.float64), fast.support)
    rec = np.zeros_like(k)
    for kz, ky, kx, c in fast.terms[0]:
        rec += c * np.einsum("i,j,k->ijk", kz, ky, kx)
    rel = np.abs(rec - k).max() / k.max()
    assert rel < 5e-3, f"separable decomposition error {rel}"


def test_sume_same_scale(setup):
    """Raw sume differs between engines by design: the exact engine's
    NN-anchored lattice sum aliases with the sub-voxel position (which its
    per-pixel normalization then divides out), while the fast engine's
    conv(1) is alias-free.  They must still agree in SCALE."""
    s_fast = np.asarray(setup["fgeom"].sume)
    s_exact = np.asarray(setup["sume"])
    both = (s_fast > 0) & (s_exact > 0)
    assert both.mean() > 0.5
    ratio = np.median(s_exact[both]) / np.median(s_fast[both])
    assert 0.6 < ratio < 1.6, f"sume scale ratio {ratio}"


def test_simulate_matches_exact(setup):
    s = setup
    vol = jnp.asarray(s["gt"].data)
    sim_e, simw_e, in_e = psf_exact.psf_gather(
        s["geom"], s["offsets"], s["sume"], vol.reshape(-1),
        s["mask"].reshape(-1), s["ra"].shape_zyx)
    sim_f, simw_f, in_f = pf.fast_simulate(
        s["fast"], s["fgeom"], vol, s["mask"], s["ra"].shape_zyx)
    both = np.asarray(in_e) & np.asarray(in_f)
    assert both.mean() > 0.4
    a = np.asarray(sim_f)[both]
    b = np.asarray(sim_e)[both]
    scale = np.abs(b).mean()
    rel = np.abs(a - b).mean() / scale
    assert rel < 0.03, f"fast-vs-exact simulate deviation {rel}"


def test_scatter_matches_exact(setup):
    s = setup
    valid = s["valid"]
    rng = np.random.default_rng(0)
    pay = jnp.asarray(np.where(np.asarray(valid),
                               rng.uniform(10, 100, valid.shape), 0.0)
                      .astype(np.float32))
    gate_e = valid & (s["sume"] > 0)
    a_e, b_e = psf_exact.psf_scatter(
        s["geom"], s["offsets"], s["sume"],
        [jnp.where(gate_e, pay, 0.0), jnp.where(gate_e, 1.0, 0.0)],
        s["mask"].reshape(-1), s["ra"].shape_zyx)
    gate_f = valid & (s["fgeom"].sume > 0)
    a_f, b_f = pf.fast_scatter2(
        s["fast"], s["fgeom"], jnp.where(gate_f, pay, 0.0),
        jnp.where(gate_f, 1.0, 0.0), s["mask"], s["ra"].shape_zyx)
    a_e = np.asarray(a_e).reshape(s["ra"].shape_zyx)
    b_e = np.asarray(b_e).reshape(s["ra"].shape_zyx)
    a_f = np.asarray(a_f)
    b_f = np.asarray(b_f)
    # raw accumulations differ through the (aliased vs smooth) 1/sume
    # weighting; what updates the volume is the NORMALIZED field addon/cmap
    # (apply_addon divides by cmap) — compare that on solid voxels
    core = (b_e > 0.2) & (b_f > 0.2)
    ratio_e = a_e[core] / b_e[core]
    ratio_f = a_f[core] / b_f[core]
    rel = np.abs(ratio_f - ratio_e).mean() / max(np.abs(ratio_e).mean(),
                                                 1e-9)
    assert rel < 0.03, f"normalized scatter deviation {rel}"
    # and the total deposited weight mass must agree in scale
    mass_ratio = b_f.sum() / b_e.sum()
    assert 0.8 < mass_ratio < 1.25, f"weight mass ratio {mass_ratio}"


def test_adjoint_consistency(setup):
    """<splat(u), v>_vol == <u, gather(v)>_pixels for the fast engine's
    forward/adjoint pair (required for EM convergence)."""
    s = setup
    rng = np.random.default_rng(1)
    shape = s["ra"].shape_zyx
    u = jnp.asarray(rng.normal(size=s["valid"].shape).astype(np.float32))
    u = jnp.where(s["valid"] & (s["fgeom"].sume > 0), u, 0.0)
    v = jnp.asarray(rng.normal(size=shape).astype(np.float32))

    # forward: per-pixel gather of conv(v.mask) weighted 1/sume
    inv = jnp.where(s["fgeom"].sume > 0,
                    1.0 / jnp.where(s["fgeom"].sume > 0, s["fgeom"].sume,
                                    1.0), 0.0)
    fwd_val = jnp.zeros_like(u)
    vm = v * s["mask"]
    for (lo, hi), terms in zip(s["fast"].ranges, s["fast"].terms):
        cv = pf.conv_separable(vm, terms)
        fwd_val = fwd_val.at[lo:hi].set(
            pf.trilinear_gather(cv, s["fgeom"].xp[lo:hi]))
    fwd_val = fwd_val * inv
    lhs = float(jnp.sum(u * fwd_val))

    adj_a, _ = pf.fast_scatter2(s["fast"], s["fgeom"], u,
                                jnp.zeros_like(u), s["mask"], shape)
    rhs = float(jnp.sum(adj_a * v))
    assert abs(lhs - rhs) / max(abs(lhs), 1e-6) < 1e-3, (lhs, rhs)


def test_trilinear_splat2_matches_naive():
    """Dense 8-corner scatter == naive per-corner scatter-add."""
    rng = np.random.default_rng(2)
    shape = (9, 11, 13)  # odd dims exercise the halo slicing
    n = 500
    # positions spanning the halo: floor in [-1, dim-1] is in-bounds
    xp = np.stack([rng.uniform(-1.5, d + 0.5, n)
                   for d in (shape[2], shape[1], shape[0])], -1)
    pa = rng.normal(size=n).astype(np.float32)
    pb = rng.normal(size=n).astype(np.float32)
    out_a, out_b = pf.trilinear_splat2(
        jnp.asarray(xp, jnp.float32), jnp.asarray(pa), jnp.asarray(pb),
        shape)

    ref_a = np.zeros(shape, np.float64)
    ref_b = np.zeros(shape, np.float64)
    xpf = np.asarray(xp, np.float32)
    x, y, z = xpf[:, 0], xpf[:, 1], xpf[:, 2]
    u, v, w = np.floor(x), np.floor(y), np.floor(z)
    du, dv, dw = x - u, y - v, z - w
    ui, vi, wi = u.astype(int), v.astype(int), w.astype(int)
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                wt = ((du if cu else 1 - du) * (dv if cv else 1 - dv)
                      * (dw if cw else 1 - dw)).astype(np.float32)
                iu, iv, iw = ui + cu, vi + cv, wi + cw
                inb = ((iu >= 0) & (iu < shape[2]) & (iv >= 0)
                       & (iv < shape[1]) & (iw >= 0) & (iw < shape[0]))
                np.add.at(ref_a, (iw[inb], iv[inb], iu[inb]),
                          (wt * pa)[inb])
                np.add.at(ref_b, (iw[inb], iv[inb], iu[inb]),
                          (wt * pb)[inb])
    np.testing.assert_allclose(np.asarray(out_a), ref_a, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(out_b), ref_b, rtol=2e-4,
                               atol=2e-4)
