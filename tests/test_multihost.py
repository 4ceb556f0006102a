"""Multi-host (DCN) path: jax.distributed over 2 CPU processes.

The reference is single-process multi-GPU only (GPUWorker.h); this
framework scales across hosts with jax.distributed + the same shard_map
program (SURVEY §2.4: one psum within a host and across hosts).
This test launches 2 local processes, each with 2 virtual CPU devices,
builds the 4-device global `slices` mesh, and checks a sharded EM/SR
collective result against the single-process value.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    port = sys.argv[2]
    jax.distributed.initialize(coordinator_address="localhost:" + port,
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from fetalreconstruction_tpu.parallel import sharded

    assert jax.device_count() == 4, jax.device_count()
    mesh = sharded.make_mesh(jax.devices())

    # deterministic per-slice data, sharded over the global mesh
    n, h, w = 8, 6, 6
    data = np.arange(n * h * w, dtype=np.float32).reshape(n, h, w)

    def body(x):
        # per-slice partial + global psum: the cross-host collective
        return jax.lax.psum(jnp.sum(x ** 2), "slices")

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("slices"),
                              out_specs=P(), check_vma=False))
    # each process supplies only its ADDRESSABLE shards
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    local = [jax.device_put(data[2 * order[d]:2 * order[d] + 2], d)
             for d in jax.local_devices()]
    x = jax.make_array_from_single_device_arrays(
        (n, h, w), NamedSharding(mesh, P("slices")), local)
    got = float(f(x))
    want = float((data ** 2).sum())
    assert abs(got - want) < 1e-3 * want, (got, want)
    if pid == 0:
        print("MULTIHOST_OK", got)
""")


WORKER_GRID = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    port = sys.argv[2]
    jax.distributed.initialize(coordinator_address="localhost:" + port,
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from fetalreconstruction_tpu.parallel import mesh2d as g2
    from fetalreconstruction_tpu.parallel.sharded import place_global
    from fetalreconstruction_tpu.pipeline import svr_core
    import __graft_entry__ as ge

    assert jax.device_count() == 4 and len(jax.local_devices()) == 2
    # 2x2 GRID mesh across the 2 processes: slices axis x vol_z axis
    mesh = g2.make_mesh2d(2, 2, jax.devices())

    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12, fast=True,
                              n_stacks=2)

    # ---- single-process replicated reference
    em0 = p["em"]
    recon0, wts0, _ = svr_core.gaussian_reconstruction(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em0.bias,
        em0.scale, p["mask_flat"])
    sim0 = svr_core.simulate(ctx, p["geom"], p["sume"], recon0,
                             p["mask_flat"])
    excluded = jnp.zeros((8,), bool)
    em0 = svr_core.initialize_robust_statistics(
        ctx, p["slices"], p["valid"], sim0, em0, 100.0, 10.0, excluded)
    args = (jnp.float32(1.0), jnp.float32(450.0), jnp.float32(10.0),
            jnp.float32(100.0), jnp.int32(1))
    em_r, sim_r, recon_r = svr_core.inner_iteration(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em0, sim0,
        recon0, wts0, p["mask_flat"].reshape(ctx.vol_shape),
        p["mask_flat"], excluded, *args, do_bias=False, do_scale=True,
        do_normalise_bias=False)
    ref = np.asarray(recon_r)

    # ---- the production GRID programs across 2 processes x 2 devices;
    # all host-global state goes through place_global (the multi-host
    # placement path under test: make_array_from_callback, not
    # device_put)
    def put(a, spec):
        return place_global(mesh, spec, np.asarray(a))

    S, V = P("slices"), P("vol_z")
    slices = put(p["slices"], S); valid = put(p["valid"], S)
    transforms = put(p["transforms"], S)
    i2w = put(np.asarray(p["i2w"], np.float32), S)
    sid = put(np.asarray(p["stack_id"], np.int32), S)
    mask_vol = put(np.asarray(p["mask_flat"]).reshape(ctx.vol_shape), V)
    rw2i = put(np.asarray(p["recon_attr"].w2i(), np.float32), P())

    g_fn = g2.g2_build_geometry_fn(ctx, mesh)
    geom = g_fn(rw2i, transforms, i2w, valid, mask_vol, sid)
    em = svr_core.init_em_state(8, valid)
    gauss = g2.g2_gaussian_reconstruction_fn(ctx, mesh)
    recon, wts, _ = gauss(slices, valid, geom, em.bias, em.scale,
                          mask_vol)
    sim_fn = g2.g2_simulate_fn(ctx, mesh)
    sim = sim_fn(geom, recon, mask_vol)
    irs = g2.g2_initialize_robust_statistics_fn(ctx, mesh)
    em = irs(slices, valid, sim, em, put(np.float32(100.0), P()),
             put(np.float32(10.0), P()), put(np.zeros(8, bool), S))
    step = g2.g2_inner_iteration_fn(ctx, mesh, do_bias=False,
                                    do_scale=True)
    em2, sim2, recon2 = step(geom, slices, valid, em, sim, recon, wts,
                             mask_vol, put(np.zeros(8, bool), S), *args)
    # recon2 is a vol_z-sharded slab array; each process checks its
    # addressable z-slabs against the replicated reference
    sc = max(abs(ref).max(), 1.0)
    for sh in recon2.addressable_shards:
        lo = sh.index[0].start or 0
        want = ref[lo:lo + sh.data.shape[0]]
        assert np.allclose(np.asarray(sh.data), want,
                           atol=2e-3 * sc), \\
            abs(np.asarray(sh.data) - want).max()
    for sh in em2.slice_weight.addressable_shards:
        lo = sh.index[0].start or 0
        want = np.asarray(em_r.slice_weight)[lo:lo + sh.data.shape[0]]
        assert np.allclose(np.asarray(sh.data), want, atol=1e-3)
    if pid == 0:
        print("MULTIHOST_GRID_OK")
""")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    # the worker script lives in tmp_path; make the repo importable
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=repo_root)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert procs[1].returncode == 0, outs[1][-2000:]
    assert "MULTIHOST_OK" in outs[0], outs[0][-2000:]


WORKER_PIPELINE = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    port = sys.argv[2]
    jax.distributed.initialize(coordinator_address="localhost:" + port,
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from fetalreconstruction_tpu.parallel import sharded
    from fetalreconstruction_tpu.pipeline import svr_core
    import __graft_entry__ as ge

    assert jax.device_count() == 4 and len(jax.local_devices()) == 2
    mesh = sharded.make_mesh(jax.devices())

    # deterministic tiny problem (fast engine), built identically in
    # both processes
    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12, fast=True,
                              n_stacks=2)

    # ---- single-process reference on local device 0
    em0 = p["em"]
    recon0, wts0, _ = svr_core.gaussian_reconstruction(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em0.bias,
        em0.scale, p["mask_flat"])
    sim0 = svr_core.simulate(ctx, p["geom"], p["sume"], recon0,
                             p["mask_flat"])
    excluded = jnp.zeros((8,), bool)
    em0 = svr_core.initialize_robust_statistics(
        ctx, p["slices"], p["valid"], sim0, em0, 100.0, 10.0, excluded)
    args = (jnp.float32(1.0), jnp.float32(450.0), jnp.float32(10.0),
            jnp.float32(100.0), jnp.int32(1))
    em_r, sim_r, recon_r = svr_core.inner_iteration(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em0, sim0,
        recon0, wts0, p["mask_flat"].reshape(ctx.vol_shape),
        p["mask_flat"], excluded, *args, do_bias=False, do_scale=True,
        do_normalise_bias=False)
    ref = np.asarray(recon_r)
    ref_sw = np.asarray(em_r.slice_weight)

    # ---- the REAL pipeline programs across 2 processes x 2 devices
    def put(a, spec):
        a = np.asarray(a)
        sh = NamedSharding(mesh, spec)
        if spec == P():
            local = a
        else:
            k = a.shape[0] // 2
            local = a[pid * k:(pid + 1) * k]
        return jax.make_array_from_process_local_data(sh, local, a.shape)

    S = P("slices")
    slices = put(p["slices"], S); valid = put(p["valid"], S)
    transforms = put(p["transforms"], S)
    i2w = put(np.asarray(p["i2w"], np.float32), S)
    dims = put(np.asarray(p["dims"], np.float32), S)
    sid = put(np.asarray(p["stack_id"], np.int32), S)
    mask_flat = put(p["mask_flat"], P())
    rw2i = put(np.asarray(p["recon_attr"].w2i(), np.float32), P())

    g_fn = sharded.sharded_build_geometry(ctx, mesh)
    geom, sume = g_fn(rw2i, transforms, i2w, dims, valid, mask_flat, sid)
    em = svr_core.init_em_state(8, valid)
    gauss = sharded.sharded_gaussian_reconstruction(ctx, mesh)
    recon, wts, _ = gauss(slices, valid, geom, sume, em.bias, em.scale,
                          mask_flat)
    sim_fn = sharded.sharded_simulate(ctx, mesh)
    sim = sim_fn(geom, sume, recon, mask_flat)
    irs = sharded.sharded_initialize_robust_statistics(ctx, mesh)
    em = irs(slices, valid, sim, em, put(np.float32(100.0), P()),
             put(np.float32(10.0), P()), put(np.zeros(8, bool), S))
    inner = sharded.sharded_inner_iteration(ctx, mesh, donate=False)
    em2, sim2, recon2 = inner(
        geom, sume, slices, valid, em, sim, recon, wts,
        put(np.asarray(p["mask_flat"]).reshape(ctx.vol_shape), P()),
        mask_flat, put(np.zeros(8, bool), S), *args)
    # recon2 is replicated (out_spec P()) -> directly readable per process
    got = np.asarray(recon2)
    sc = max(abs(ref).max(), 1.0)
    assert np.allclose(got, ref, atol=2e-3 * sc), abs(got - ref).max()
    # slice_weight is sharded: check this process's addressable shards
    for sh in em2.slice_weight.addressable_shards:
        lo = sh.index[0].start or 0
        want = ref_sw[lo:lo + sh.data.shape[0]]
        assert np.allclose(np.asarray(sh.data), want, atol=1e-3), \
            (np.asarray(sh.data), want)
    if pid == 0:
        print("MULTIHOST_PIPELINE_OK")
""")


def test_two_process_sharded_inner_iteration(tmp_path):
    """The PRODUCTION shard_map programs (geometry build, gaussian
    reconstruction, fused inner EM/SR iteration) across 2 processes x 2
    devices equal the single-process path — the multi-host claim covers
    the pipeline, not a toy psum (round-3 weakness)."""
    script = tmp_path / "worker_pipeline.py"
    script.write_text(WORKER_PIPELINE)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=repo_root)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "MULTIHOST_PIPELINE_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_two_process_grid_mode(tmp_path):
    """The 2-D GRID mesh (slices x vol_z) across 2 processes x 2 devices:
    place_global must place slab- and slice-sharded state without
    jax.device_put (which cannot target non-addressable devices), and the
    grid collectives (psum over slices, psum/ppermute over vol_z) must
    reproduce the replicated engine — the round-4 gap that hard-rejected
    --distributed with --mesh-mode volume|grid."""
    script = tmp_path / "worker_grid.py"
    script.write_text(WORKER_GRID)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=repo_root)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "MULTIHOST_GRID_OK" in outs[0], outs[0][-3000:]
