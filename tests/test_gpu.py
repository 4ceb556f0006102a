"""Card-only checks: the fast engine and the geometry chain on a GPU.

Marked `gpu`; run on the card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Each test asks the `gpu` fixture for the device and skips, with a reason,
where JAX finds no GPU.  Tolerances: float32 against the float64 NumPy
reference on the same inputs; the GPU scatter sums with atomics in no
fixed order, so agreement is to float32 rounding (1e-5 of the maximum),
not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.ops import psf_fast as pf
from fetalreconstruction_tpu.ops import psf_fast_ref as ref
from fetalreconstruction_tpu.pipeline import svr_core

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev


def _engine(vol_shape, n_stacks=3, n_slices=12, hw=48, seed=0):
    rng = np.random.default_rng(seed)
    zs, ys, xs = vol_shape
    recon_w2i = np.diag([1.0, 1.0, 1.0, 1.0])
    recon_w2i[:3, 3] = [xs / 2, ys / 2, zs / 2]
    i2w, stack_a3 = [], []
    per = n_slices // n_stacks
    for s in range(n_stacks):
        rot = rigid_matrix([0, 0, 0, 30.0 * s, 20.0 * s, 0])
        for j in range(per):
            a = np.diag([0.9, 0.9, 3.0, 1.0])
            a[:3, 3] = [-hw * 0.45, -hw * 0.45, (j - per / 2) * 2.0]
            i2w.append(rot @ a)
        stack_a3.append(np.linalg.inv((recon_w2i @ i2w[s * per])[:3, :3]))
    ranges = [(s * per, (s + 1) * per) for s in range(n_stacks)]
    fast = pf.FastPSF(np.asarray(stack_a3),
                      np.tile([[0.9, 0.9, 3.0]], (n_stacks, 1)), ranges,
                      support=7)
    fwd = np.einsum("ij,njk->nik", recon_w2i, np.asarray(i2w))
    mask = (rng.uniform(size=vol_shape) > 0.1).astype(np.float32)
    geom = pf.make_fast_geom(fast, jnp.asarray(fwd, jnp.float32),
                             jnp.ones((n_slices, hw, hw), bool), vol_shape,
                             jnp.asarray(mask))
    return fast, fwd, geom, mask, rng


def test_geometry_chain_is_float32_exact(gpu):
    """Slice pixel -> volume position at coordinates of ~200 voxels: a
    TF32 product would be off by ~0.1 voxel; HIGHEST keeps it to f32."""
    rng = np.random.default_rng(1)
    n = 64
    w2i = np.eye(4)
    w2i[:3, 3] = [180.0, 200.0, 220.0]
    t = np.stack([rigid_matrix(list(rng.uniform(-5, 5, 3))
                               + list(rng.uniform(-10, 10, 3)))
                  for _ in range(n)])
    i2w = np.stack([rigid_matrix(list(rng.uniform(-40, 40, 3))
                                 + list(rng.uniform(-90, 90, 3)))
                    for _ in range(n)])
    got = np.asarray(jax.device_put(svr_core.slice_forward_matrices(
        jnp.asarray(w2i, jnp.float32), jnp.asarray(t, jnp.float32),
        jnp.asarray(i2w, jnp.float32)), gpu))
    want = np.einsum("ij,njk,nkl->nil", w2i, t, i2w)
    px = np.array([143.0, 143.0, 0.0, 1.0])
    err = np.abs(np.einsum("nij,j->ni", got - want, px)).max()
    assert err < 2e-3, f"position error {err} voxels"


def test_fast_scatter2_matches_reference(gpu):
    vs = (40, 44, 48)
    fast, _, geom, mask, rng = _engine(vs)
    gate = np.asarray(geom.valid) & (np.asarray(geom.sume) > 0)
    pa = np.where(gate, rng.uniform(-50, 50, gate.shape), 0).astype(
        np.float32)
    pb = np.where(gate, rng.uniform(0, 1, gate.shape), 0).astype(np.float32)
    a, b = jax.jit(lambda x, y: pf.fast_scatter2(
        fast, geom, x, y, jnp.asarray(mask), vs))(pa, pb)
    ra, rb = ref.scatter2(fast.terms, np.asarray(geom.xp),
                          np.asarray(geom.sid), np.asarray(geom.sume), pa,
                          pb, mask, vs)
    assert gate.mean() > 0.3
    for got, want in ((a, ra), (b, rb)):
        err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
        assert err < 1e-5, err


def test_fast_simulate_matches_reference(gpu):
    vs = (40, 44, 48)
    fast, _, geom, mask, rng = _engine(vs, seed=2)
    vol = rng.uniform(0, 500, vs).astype(np.float32)
    sim, simw, inside = jax.jit(lambda v: pf.fast_simulate(
        fast, geom, v, jnp.asarray(mask), vs))(vol)
    rsim, rsimw, rin = ref.simulate(
        fast.terms, np.asarray(geom.xp), np.asarray(geom.sid),
        np.asarray(geom.sume), np.asarray(geom.den), np.asarray(geom.valid),
        vol, mask)
    np.testing.assert_array_equal(np.asarray(inside), rin)
    assert rin.mean() > 0.3
    for got, want in ((sim, rsim), (simw, rsimw)):
        err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
        assert err < 1e-5, err
