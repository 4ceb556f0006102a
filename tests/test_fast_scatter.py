"""The fast engine's SR scatter, geometry precision and run-time plumbing.

- psf_fast.splat2 / fast_scatter2 against the NumPy float64 reference
  (ops/psf_fast_ref.py: 8-corner splat + adjoint separable convolution);
- the scatter under shard_map on the 8-device CPU mesh equals one device;
- every matrix product of the geometry chains is pinned to HIGHEST
  precision (a GPU would otherwise run f32 products in TF32, ~0.1 voxel
  at coordinates of 160-220);
- compile-cache placement and chip_smoke's device gate.
"""
import os

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from fetalreconstruction_tpu.ops import psf_fast as pf
from fetalreconstruction_tpu.ops import psf_fast_ref as ref


def _random_engine(vol_shape, n_stacks, n_slices, hw, seed):
    """FastPSF with n_stacks orientations + per-slice positions spanning
    the -1 halo and beyond (out-of-bounds pixels)."""
    rng = np.random.default_rng(seed)
    a3s = []
    for s in range(n_stacks):
        ang = np.deg2rad(30.0 * s)
        c, si = np.cos(ang), np.sin(ang)
        a3s.append(np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]]) * 0.8)
    dims = np.tile([[1.25, 1.25, 3.0]], (n_stacks, 1))
    per = n_slices // n_stacks
    ranges = [(s * per, (s + 1) * per) for s in range(n_stacks)]
    fast = pf.FastPSF(np.asarray(a3s), dims, ranges, support=5)
    zs, ys, xs = vol_shape
    xp = np.stack([rng.uniform(-2.0, d + 1.0, (n_slices, hw, hw))
                   for d in (xs, ys, zs)], -1).astype(np.float32)
    sid = np.asarray(pf.default_stack_id(fast, n_slices))
    sume = rng.uniform(0.0, 2.0, (n_slices, hw, hw)).astype(np.float32)
    sume[sume < 0.5] = 0.0
    return fast, xp, sid, sume, rng


@pytest.mark.parametrize("vol_shape,n_stacks", [
    ((9, 11, 13), 1),      # odd dims
    ((8, 10, 12), 3),      # even dims, three stacks
    ((7, 12, 9), 3),       # mixed
])
def test_fast_scatter2_matches_reference(vol_shape, n_stacks):
    n_slices, hw = 3 * n_stacks, 6
    fast, xp, sid, sume, rng = _random_engine(vol_shape, n_stacks,
                                              n_slices, hw, seed=n_stacks)
    pa = rng.normal(size=sume.shape).astype(np.float32)
    pb = rng.uniform(0, 1, sume.shape).astype(np.float32)
    mask = (rng.uniform(size=vol_shape) > 0.2).astype(np.float32)
    geom = pf.FastGeom(xp=jnp.asarray(xp), valid=jnp.ones(sume.shape, bool),
                       sume=jnp.asarray(sume), sid=jnp.asarray(sid),
                       den=jnp.ones(sume.shape, jnp.float32))
    # the dense splat alone
    dense = np.asarray(pf.splat2(geom.xp, jnp.asarray(pa), jnp.asarray(pb),
                                 vol_shape, sid=geom.sid, n_stacks=n_stacks))
    rdense = ref.splat2(xp, pa, pb, vol_shape, sid, n_stacks)
    assert dense.shape == (n_stacks, 2) + vol_shape
    np.testing.assert_allclose(dense, rdense, rtol=1e-5, atol=1e-5)
    # the whole transpose: splat + adjoint convolution + mask
    a, b = pf.fast_scatter2(fast, geom, jnp.asarray(pa), jnp.asarray(pb),
                            jnp.asarray(mask), vol_shape)
    ra, rb = ref.scatter2(fast.terms, xp, sid, sume, pa, pb, mask,
                          vol_shape)
    for got, want in ((a, ra), (b, rb)):
        err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
        assert err < 1e-5, err


def test_splat2_drops_out_of_bounds_corners():
    """Corners outside the grid vanish; pixels wholly outside add 0."""
    vol_shape = (4, 5, 6)
    xp = jnp.asarray([[-1.0, 0.0, 0.0],      # floor -1: half in x
                      [5.5, 4.5, 3.5],       # last voxel corner only
                      [-3.0, 2.0, 2.0],      # wholly outside
                      [2.25, 1.5, 1.75]], jnp.float32)
    one = jnp.ones((4,), jnp.float32)
    out = np.asarray(pf.splat2(xp, one, 2 * one, vol_shape))
    want = ref.splat2(np.asarray(xp), np.ones(4), 2 * np.ones(4), vol_shape)
    np.testing.assert_allclose(out, want, atol=1e-6)
    # every in-grid corner weight is deposited exactly once
    np.testing.assert_allclose(out[0, 0].sum(), 0.0 + 0.125 + 0.0 + 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("n_stacks", [1, 3])
def test_fast_scatter2_under_shard_map(n_stacks):
    """Slice-sharded scatter on the 8-device CPU mesh + psum equals the
    single-device result."""
    from fetalreconstruction_tpu.parallel import sharded
    vol_shape, n_slices, hw = (8, 9, 10), 8 * n_stacks, 5
    fast, xp, sid, sume, rng = _random_engine(vol_shape, n_stacks,
                                              n_slices, hw, seed=7)
    pa = jnp.asarray(rng.normal(size=sume.shape).astype(np.float32))
    pb = jnp.asarray(rng.uniform(0, 1, sume.shape).astype(np.float32))
    mask = jnp.ones(vol_shape, jnp.float32)
    geom = pf.FastGeom(xp=jnp.asarray(xp), valid=jnp.ones(sume.shape, bool),
                       sume=jnp.asarray(sume), sid=jnp.asarray(sid),
                       den=jnp.ones(sume.shape, jnp.float32))
    want = pf.fast_scatter2(fast, geom, pa, pb, mask, vol_shape)

    mesh = sharded.make_mesh(jax.devices()[:8])
    gspec = pf.FastGeom(xp=P("slices"), valid=P("slices"),
                        sume=P("slices"), sid=P("slices"), den=P("slices"))

    def body(g, a, b):
        out = pf.fast_scatter2(fast, g, a, b, mask, vol_shape)
        return tuple(jax.lax.psum(o, "slices") for o in out)

    f = jax.jit(sharded._shard_map(body, mesh,
                                   in_specs=(gspec, P("slices"),
                                             P("slices")),
                                   out_specs=(P(), P())))
    got = f(geom, pa, pb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# every geometry matrix product runs at HIGHEST precision
# ---------------------------------------------------------------------------

def _dots(jaxpr):
    """All dot_general equations of a closed jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dots(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dots(sub)
    return out


def _geometry_cases():
    from fetalreconstruction_tpu.core import geometry
    from fetalreconstruction_tpu.ops import psf as psf_exact
    from fetalreconstruction_tpu.ops import sampling
    from fetalreconstruction_tpu.pipeline import svr_core
    from fetalreconstruction_tpu.register import slice2vol as s2v
    from fetalreconstruction_tpu.register import volume as vreg
    from fetalreconstruction_tpu.sr import bspline

    n, h, w = 3, 6, 7
    m4 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1))
    e4 = jnp.eye(4, dtype=jnp.float32)
    params = jnp.zeros((n, 6), jnp.float32)
    vol = jnp.ones((6, 7, 8), jnp.float32)
    targets = jnp.ones((n, 16, 16), jnp.float32)
    table = pf.make_shingle([vol])
    geom = psf_exact.make_slice_geom(m4, jnp.ones((n, 3), jnp.float32),
                                     jnp.ones((n, h, w), bool))
    cfg = s2v.SliceRegConfig(levels=1, iterations=1)
    return {
        "svr_core.slice_forward_matrices": (
            svr_core.slice_forward_matrices, (e4, m4, m4)),
        "slice2vol.generate_slices": (
            lambda p, o: s2v.generate_slices(vol, e4, p, o, (h, w), 1),
            (params, m4)),
        "slice2vol.generate_slices_psf": (
            lambda p, o: s2v.generate_slices_psf(
                table, vol.shape, None, e4, p, o, (h, w), 1), (params, m4)),
        "slice2vol._level_arrays": (
            lambda t, o: s2v._level_arrays(2, 1.0, t, o), (targets, m4)),
        "slice2vol.register_slices_to_volume": (
            lambda t, mo, o, tg: s2v.register_slices_to_volume(
                cfg, vol, e4, t, mo, o, tg, 1.0), (m4, m4, m4, targets)),
        "volume._vol_cost_body": (
            lambda p: vreg._vol_cost_body("cc", 0, vol, vol, e4, e4, -1.0,
                                          -1.0, p), (params,)),
        "volume._vol_cost_body_b": (
            lambda p: vreg._vol_cost_body_b(
                "cc", 0, False, jnp.stack([vol] * n), jnp.stack([vol] * n),
                m4, m4, -jnp.ones(n), -jnp.ones(n), p), (params,)),
        "geometry.invert_rigid_jax": (geometry.invert_rigid_jax, (m4,)),
        "geometry.transform_points_jax": (
            geometry.transform_points_jax, (m4, jnp.ones((n, 3)))),
        "sampling.resample_to_grid": (
            lambda v, a, b: sampling._resample_to_grid_jit(
                v, a, (4, 5, 6), b), (vol, e4, e4)),
        "psf._offset_weight": (
            lambda g: psf_exact._offset_weight(g, jnp.ones(3, jnp.int32)),
            (geom,)),
        "bspline._eval_level": (
            lambda c: bspline._eval_level(c, (6, 7, 8), 2.0),
            (jnp.ones((5, 5, 6), jnp.float32),)),
    }


GEOMETRY_FUNCTIONS = (
    "svr_core.slice_forward_matrices", "slice2vol.generate_slices",
    "slice2vol.generate_slices_psf", "slice2vol._level_arrays",
    "slice2vol.register_slices_to_volume", "volume._vol_cost_body",
    "volume._vol_cost_body_b", "geometry.invert_rigid_jax",
    "geometry.transform_points_jax", "sampling.resample_to_grid",
    "psf._offset_weight", "bspline._eval_level")


@pytest.mark.parametrize("name", GEOMETRY_FUNCTIONS)
def test_geometry_products_use_highest_precision(name):
    cases = _geometry_cases()
    assert set(cases) == set(GEOMETRY_FUNCTIONS)
    fn, args = cases[name]
    dots = _dots(jax.make_jaxpr(fn)(*args).jaxpr)
    assert dots, f"{name}: no matrix product traced"
    hi = jax.lax.Precision.HIGHEST
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(p == hi for p in prec), \
            f"{name}: dot_general at precision {prec}"


# ---------------------------------------------------------------------------
# compile cache placement, chip_smoke's device gate
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_dir(monkeypatch, restore_cache_dir):
    from fetalreconstruction_tpu.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    got = cc.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jax_compile_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_env_dir_wins(monkeypatch, restore_cache_dir,
                                    tmp_path):
    from fetalreconstruction_tpu.utils import compile_cache as cc
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_chip_smoke_device_gate_refuses_cpu():
    import chip_smoke
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(chip_smoke.PhaseError, match="no GPU"):
        chip_smoke.require_gpu()
