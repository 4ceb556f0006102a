"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The sharded EM+SR iteration must produce the same numbers as the
single-device path (the psum reductions replace global sums exactly).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fetalreconstruction_tpu.ops import psf as psf_ops
from fetalreconstruction_tpu.parallel import sharded
from fetalreconstruction_tpu.pipeline import svr_core
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu.sr.superresolution import smoothing_parameters

from phantom import make_ground_truth, simulate_stacks, mask_slices, \
    recon_mask


@pytest.fixture(scope="module")
def setup():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    gt = make_ground_truth(n=20, spacing=2.4)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.5, dz=4.0,
                                noise=1.0)
    batch = mask_slices(create_slices(stacks, [8.0, 8.0]))
    # pad slice count to a multiple of 8
    n0 = batch.n_slices
    n = sharded.pad_slices_for_mesh(n0, 8)
    if n > n0:
        pad = np.full((n - n0,) + batch.data.shape[1:], -1.0, np.float32)
        batch.data = np.concatenate([batch.data, pad])
        batch.i2w = np.concatenate([batch.i2w,
                                    np.tile(np.eye(4), (n - n0, 1, 1))])
        batch.dims = np.concatenate([batch.dims,
                                     np.tile(batch.dims[-1:],
                                             (n - n0, 1))])
    ra = gt.attr
    offsets = psf_ops.make_offsets(
        psf_ops.reference_support(batch.dims[:n0], ra.dx, 1.0, 10))
    ctx = svr_core.SVRContext(
        vol_shape=ra.shape_zyx, vol_spacing=(ra.dx, ra.dy, ra.dz),
        offsets=offsets, slice_spacing_xy=(2.5, 2.5),
        disable_bias=True)  # the reference CLI default (reconstruction.cc:121)
    transforms = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1))
    valid = jnp.asarray(batch.data != -1.0)
    geom, sume = svr_core.build_geometry(
        ctx, jnp.asarray(ra.w2i(), jnp.float32), transforms,
        jnp.asarray(batch.i2w, jnp.float32), jnp.asarray(batch.dims),
        valid)
    mask = recon_mask(gt)
    return dict(gt=gt, batch=batch, ctx=ctx, geom=geom, sume=sume,
                valid=valid, mask=mask,
                mask_flat=jnp.asarray(mask).reshape(-1), n=n)


def test_sharded_matches_single_device(setup):
    s = setup
    ctx = s["ctx"]
    mesh = sharded.make_mesh(jax.devices()[:8])
    n = s["n"]
    slices = jnp.asarray(s["batch"].data)
    em = svr_core.init_em_state(n, s["valid"])

    # --- single-device reference path
    recon0, wts0, vc0 = svr_core.gaussian_reconstruction(
        ctx, s["geom"], s["sume"], slices, s["valid"], em.bias, em.scale,
        s["mask_flat"])
    sim0 = svr_core.simulate(ctx, s["geom"], s["sume"], recon0,
                             s["mask_flat"])
    pos = s["batch"].data[s["batch"].data > 0]
    mx, mn = float(pos.max()), float(pos.min())
    excluded = jnp.zeros((n,), bool)
    em0 = svr_core.initialize_robust_statistics(
        ctx, slices, s["valid"], sim0, em, mx, mn, excluded)
    em0, _ = svr_core.estep(ctx, slices, s["valid"], s["sume"], sim0, em0,
                            excluded)
    alpha, lam = smoothing_parameters(150.0, 0.02)
    em0s = em0._replace(scale=jnp.asarray(np.asarray(em0.scale)))
    recon1, _ = svr_core.superresolution_step(
        ctx, s["geom"], s["sume"], slices, s["valid"],
        em0._replace(scale=jnp.ones((n,))), sim0, recon0, s["mask_flat"],
        alpha, lam, mn, mx)

    # --- sharded path
    g_fn = sharded.sharded_gaussian_reconstruction(ctx, mesh)
    recon0_s, wts0_s, vc0_s = g_fn(slices, s["valid"], s["geom"],
                                   s["sume"], em.bias, em.scale,
                                   s["mask_flat"])
    assert np.allclose(np.asarray(recon0_s), np.asarray(recon0), atol=1e-3)
    assert np.allclose(np.asarray(wts0_s), np.asarray(wts0), atol=1e-3)
    assert np.array_equal(np.asarray(vc0_s), np.asarray(vc0))

    step_fn = sharded.sharded_em_sr_iteration(ctx, mesh)
    recon1_s, em1_s, sim1_s = step_fn(
        slices, s["valid"], s["geom"], s["sume"],
        em0._replace(scale=jnp.ones((n,))), sim0, recon0, wts0,
        jnp.asarray(s["mask"]), s["mask_flat"], excluded,
        jnp.float32(alpha), jnp.float32(lam), jnp.float32(mn),
        jnp.float32(mx), jnp.int32(2))

    # reference: same sequence single-device
    em_ref = em0._replace(scale=jnp.ones((n,)))
    em_ref = svr_core.scale_step(ctx, slices, s["valid"], s["sume"], sim0,
                                 em_ref)
    recon_ref, _ = svr_core.superresolution_step(
        ctx, s["geom"], s["sume"], slices, s["valid"], em_ref, sim0,
        recon0, s["mask_flat"], alpha, lam, mn, mx)
    sim_ref = svr_core.simulate(ctx, s["geom"], s["sume"], recon_ref,
                                s["mask_flat"])
    em_ref = svr_core.mstep(ctx, slices, s["valid"], s["sume"], sim_ref,
                            em_ref, 2)
    em_ref, _ = svr_core.estep(ctx, slices, s["valid"], s["sume"], sim_ref,
                               em_ref, excluded)

    assert np.allclose(np.asarray(recon1_s), np.asarray(recon_ref),
                       atol=2e-2), \
        float(np.abs(np.asarray(recon1_s) - np.asarray(recon_ref)).max())
    assert np.allclose(np.asarray(em1_s.sigma2), np.asarray(em_ref.sigma2),
                       rtol=1e-3)
    assert np.allclose(np.asarray(em1_s.slice_weight),
                       np.asarray(em_ref.slice_weight), atol=1e-3)
    assert np.allclose(np.asarray(sim1_s.sim), np.asarray(sim_ref.sim),
                       atol=2e-2)


def test_sharded_fast_engine_matches_single_device(setup):
    """The production (fast conv+trilinear) engine under shard_map must
    reproduce the single-device fast-engine numbers exactly — this is the
    multi-chip production path (VERDICT round 1 item 2)."""
    from fetalreconstruction_tpu.ops import psf_fast as pf

    s = setup
    batch = s["batch"]
    n = s["n"]
    ra = s["gt"].attr
    # pad stack_index to the mesh-padded slice count
    sidx = np.asarray(batch.stack_index)
    if len(sidx) < n:
        sidx = np.concatenate([sidx, np.full((n - len(sidx),), sidx[-1],
                                             np.int32)])
    support = int(pf_support(batch, ra))
    fast = pf.FastPSF.from_batch(batch, ra.w2i(), support)
    ctx = svr_core.SVRContext(
        vol_shape=ra.shape_zyx, vol_spacing=(ra.dx, ra.dy, ra.dz),
        offsets=s["ctx"].offsets, slice_spacing_xy=(2.5, 2.5),
        disable_bias=True, fast=fast)
    transforms = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1))
    sid = jnp.asarray(sidx, jnp.int32)
    geom, sume = svr_core.build_geometry(
        ctx, jnp.asarray(ra.w2i(), jnp.float32), transforms,
        jnp.asarray(batch.i2w, jnp.float32), jnp.asarray(batch.dims),
        s["valid"], s["mask_flat"], stack_id=sid)

    slices = jnp.asarray(batch.data)
    em = svr_core.init_em_state(n, s["valid"])
    excluded = jnp.zeros((n,), bool)
    pos = batch.data[batch.data > 0]
    mx, mn = float(pos.max()), float(pos.min())
    alpha, lam = smoothing_parameters(150.0, 0.02)

    # single-device fast path
    recon0, wts0, vc0 = svr_core.gaussian_reconstruction(
        ctx, geom, sume, slices, s["valid"], em.bias, em.scale,
        s["mask_flat"])
    sim0 = svr_core.simulate(ctx, geom, sume, recon0, s["mask_flat"])
    em0 = svr_core.initialize_robust_statistics(
        ctx, slices, s["valid"], sim0, em, mx, mn, excluded)
    em0, _ = svr_core.estep(ctx, slices, s["valid"], sume, sim0, em0,
                            excluded)
    # inner_iteration donates em/sim/recon -> pass copies, keep originals
    em1, sim1, recon1 = svr_core.inner_iteration(
        ctx, geom, sume, slices, s["valid"],
        jax.tree.map(jnp.copy, em0), jax.tree.map(jnp.copy, sim0),
        jnp.copy(recon0), wts0,
        jnp.asarray(s["mask"]), s["mask_flat"], excluded,
        jnp.float32(alpha), jnp.float32(lam), jnp.float32(mn),
        jnp.float32(mx), jnp.int32(1))

    # sharded fast path (geometry rebuilt under the mesh too)
    mesh = sharded.make_mesh(jax.devices()[:8])
    g_geom = sharded.sharded_build_geometry(ctx, mesh)
    geom_s, sume_s = g_geom(jnp.asarray(ra.w2i(), jnp.float32), transforms,
                            jnp.asarray(batch.i2w, jnp.float32),
                            jnp.asarray(batch.dims, jnp.float32),
                            s["valid"], s["mask_flat"], sid)
    assert np.allclose(np.asarray(sume_s), np.asarray(sume), atol=1e-4)

    g_fn = sharded.sharded_gaussian_reconstruction(ctx, mesh)
    recon0_s, wts0_s, vc0_s = g_fn(slices, s["valid"], geom_s, sume_s,
                                   em.bias, em.scale, s["mask_flat"])
    assert np.allclose(np.asarray(recon0_s), np.asarray(recon0), atol=1e-3)
    assert np.allclose(np.asarray(wts0_s), np.asarray(wts0), atol=1e-3)
    assert np.array_equal(np.asarray(vc0_s), np.asarray(vc0))

    sim_fn = sharded.sharded_simulate(ctx, mesh)
    sim0_s = sim_fn(geom_s, sume_s, recon0_s, s["mask_flat"])
    assert np.allclose(np.asarray(sim0_s.sim), np.asarray(sim0.sim),
                       atol=1e-3)

    rs_fn = sharded.sharded_initialize_robust_statistics(ctx, mesh)
    em0_s = rs_fn(slices, s["valid"], sim0_s, em, jnp.float32(mx),
                  jnp.float32(mn), excluded)
    assert np.allclose(float(em0_s.sigma2), float(em0.sigma2), rtol=1e-4)

    e_fn = sharded.sharded_estep(ctx, mesh)
    em0_s, _ = e_fn(slices, s["valid"], sume_s, sim0_s, em0_s, excluded)
    assert np.allclose(np.asarray(em0_s.weights), np.asarray(em0.weights),
                       atol=1e-4)

    step_fn = sharded.sharded_inner_iteration(ctx, mesh)
    em1_s, sim1_s, recon1_s = step_fn(
        geom_s, sume_s, slices, s["valid"], em0_s, sim0_s, recon0_s,
        wts0_s, jnp.asarray(s["mask"]), s["mask_flat"], excluded,
        jnp.float32(alpha), jnp.float32(lam), jnp.float32(mn),
        jnp.float32(mx), jnp.int32(1))
    assert np.allclose(np.asarray(recon1_s), np.asarray(recon1),
                       atol=2e-2), \
        float(np.abs(np.asarray(recon1_s) - np.asarray(recon1)).max())
    assert np.allclose(np.asarray(em1_s.slice_weight),
                       np.asarray(em1.slice_weight), atol=1e-3)
    assert np.allclose(float(em1_s.sigma2), float(em1.sigma2), rtol=1e-3)


def pf_support(batch, ra):
    from fetalreconstruction_tpu.ops import psf as psf_ops
    return psf_ops.reference_support(batch.dims, ra.dx, 1.0, 10)


@pytest.mark.slow
def test_pipeline_mesh_mode_matches_single_device():
    """run_svr(mesh=...) (GSPMD data placement) must reproduce the
    single-device pipeline result."""
    from fetalreconstruction_tpu.pipeline.config import SVRConfig
    from fetalreconstruction_tpu.pipeline.svr import run_svr
    from phantom import make_ground_truth, simulate_stacks
    from fetalreconstruction_tpu.core.image import Image

    gt = make_ground_truth(n=20, spacing=2.4)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.5, dz=4.0,
                                noise=1.0)
    mask_img = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    cfg = SVRConfig(iterations=1, resolution=2.4, rec_iterations_first=2,
                    rec_iterations_last=2, smooth_mask=2.0,
                    multires_levels=2, engine="exact", max_psf_support=8)
    r_single = run_svr(cfg, stacks=[Image(s.data.copy(), s.attr.copy())
                                    for s in stacks], mask=mask_img)
    mesh = sharded.make_mesh(jax.devices()[:8])
    r_mesh = run_svr(cfg, stacks=[Image(s.data.copy(), s.attr.copy())
                                  for s in stacks], mask=mask_img,
                     mesh=mesh)
    a = r_single.reconstructed.data
    b = r_mesh.reconstructed.data
    assert a.shape == b.shape
    assert np.allclose(a, b, atol=5e-2), np.abs(a - b).max()


@pytest.mark.slow
def test_sharded_registration_matches_single_device():
    """sharded_register_slices (the production mesh registration stage)
    must equal the single-device register_slices_to_volume on a REAL
    problem: injected per-slice motion, registered against the true
    volume as the recon target (per-slice problems are independent, so
    partitioning over the mesh is exact)."""
    from fetalreconstruction_tpu.core.geometry import rigid_matrix
    from fetalreconstruction_tpu.ops.sampling import resample_to_grid
    from fetalreconstruction_tpu.register import slice2vol as s2v
    from fetalreconstruction_tpu.register.prepare import \
        prepare_registration_slices

    gt = make_ground_truth(n=24, spacing=1.8)
    rng = np.random.default_rng(5)
    nz = int(24 * 1.8 / 3.0)
    motions = np.zeros((nz, 6))
    motions[::2, :3] = rng.uniform(-1.5, 1.5, (len(motions[::2]), 3))
    motions[::2, 3:] = rng.uniform(-2.0, 2.0, (len(motions[::2]), 3))
    stacks, _ = simulate_stacks(gt, n_stacks=1, in_plane=2.0, dz=3.0,
                                noise=0.5, slice_motions=[motions])
    batch = create_slices(stacks, [6.0])
    n0 = batch.n_slices
    n = sharded.pad_slices_for_mesh(n0, 8)
    if n > n0:
        pad = np.full((n - n0,) + batch.data.shape[1:], -1.0, np.float32)
        batch.data = np.concatenate([batch.data, pad])
        batch.i2w = np.concatenate([batch.i2w,
                                    np.tile(batch.i2w[-1:],
                                            (n - n0, 1, 1))])
        batch.dims = np.concatenate([batch.dims,
                                     np.tile(batch.dims[-1:],
                                             (n - n0, 1))])
        batch.stack_index = np.concatenate(
            [batch.stack_index,
             np.full((n - n0,), batch.stack_index[-1], np.int32)])
        batch.attrs = batch.attrs + [batch.attrs[-1].copy()
                                     for _ in range(n - n0)]

    ra = gt.attr.with_spacing(1.8, 1.8, 1.8)
    recon = resample_to_grid(
        jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i(), jnp.float32),
        ra.shape_zyx, jnp.asarray(ra.i2w(), jnp.float32),
        interp="linear", padding=0.0)
    recon_w2i = jnp.asarray(ra.w2i(), jnp.float32)
    targets, mo, ofs = prepare_registration_slices(batch, ra.dx)
    t0 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1))

    # psf_matched off: this test checks SHARDING equality (the PSF-matched
    # path is covered by the run_svr pipeline equality tests);
    # coord-scan pins both sides to the identical scanned program so the
    # stepped driver's compaction (batch-shape-dependent roundings)
    # can't flip accept decisions on one side only
    cfg = s2v.SliceRegConfig(levels=1, iterations=3, psf_matched=False,
                             optimizer="coord-scan")
    single_t, single_sim = s2v.register_slices_to_volume(
        cfg, recon, recon_w2i, t0, jnp.asarray(mo), jnp.asarray(ofs),
        jnp.asarray(targets), ra.dx)

    mesh = sharded.make_mesh(jax.devices()[:8])
    reg_fn = sharded.sharded_register_slices(cfg, mesh, ra.dx)
    mesh_t, mesh_sim = reg_fn(recon, recon_w2i, t0, jnp.asarray(mo),
                              jnp.asarray(ofs), jnp.asarray(targets),
                              jnp.zeros((n,), jnp.int32))

    # the single-device optimizer must have actually moved (non-trivial
    # problem), and the sharded result must agree to far below a voxel.
    # Exact equality is NOT expected: per-slice reductions tile
    # differently at shard size vs batch size, and the line search's
    # discrete accept/reject decisions amplify that float noise (the
    # reference's multi-GPU slice partitioning has the same property).
    assert float(jnp.abs(single_t - t0).max()) > 1e-3
    assert np.allclose(np.asarray(mesh_t), np.asarray(single_t),
                       atol=5e-2), \
        float(np.abs(np.asarray(mesh_t) - np.asarray(single_t)).max())
    assert np.allclose(np.asarray(mesh_sim), np.asarray(single_sim),
                       atol=1e-2)

