"""Batched 3D-3D registration: lock-step batch vs the serial path.

The batched driver (register_volumes_batched) must register M pairs with
the same quality the one-at-a-time loop achieves — it is the analog
of ParallelStackRegistrations (irtkReconstructionGPU.cc:849-938).
Per-pair costs are mathematically identical (batch padding is excluded
by the padding masks); batched reductions may round differently at the
last ulp, so accept decisions on razor-thin improvements can diverge —
the assertion is on recovered transforms, not on bitwise paths.
"""
import numpy as np
import pytest

from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.register.volume import (
    VolRegConfig, register_volumes, register_volumes_batched)

from phantom import make_ground_truth
from test_volume_reg import _mean_displacement, _transformed_copy


@pytest.mark.slow
def test_batched_matches_serial():
    gt = make_ground_truth(n=32, spacing=1.5)
    true_ps = [[2.0, -1.5, 1.0, 3.0, -2.0, 2.5],
               [-1.5, 1.0, -2.0, -2.5, 1.5, 1.0],
               [1.0, 2.0, 1.5, 1.5, 2.5, -2.0]]
    pairs = [_transformed_copy(gt, p) for p in true_ps]
    cfg = VolRegConfig(levels=2, iterations=10, metric="cc")

    serial = [register_volumes(cfg, gt, src)[0] for src, _ in pairs]
    batched, sims = register_volumes_batched(
        cfg, [gt] * len(pairs), [src for src, _ in pairs])

    assert batched.shape == (3, 4, 4)
    for i, (src, t_true) in enumerate(pairs):
        err_s = _mean_displacement(t_true @ serial[i], gt)
        err_b = _mean_displacement(t_true @ batched[i], gt)
        # same quality class as the serial path (and absolutely small)
        assert err_b < max(2.0 * err_s, 0.75), \
            f"pair {i}: batched {err_b:.3f} vs serial {err_s:.3f} mm"
        assert err_b < 2.0
        assert sims[i] > 0.9


@pytest.mark.slow
def test_batched_shared_source():
    """Package mode: many targets against ONE broadcast source volume."""
    gt = make_ground_truth(n=32, spacing=1.5)
    true_ps = [[1.5, -1.0, 0.5, 2.0, -1.0, 1.5],
               [-1.0, 1.5, -1.0, -1.5, 2.0, 0.5]]
    # target_i = gt moved by p_i; register target->gt finds T mapping
    # target world -> source world
    targets = []
    for p in true_ps:
        src, t_true = _transformed_copy(gt, p)
        targets.append((src, t_true))
    cfg = VolRegConfig(levels=2, iterations=10, metric="cc")
    mats, _ = register_volumes_batched(
        cfg, [t for t, _ in targets], [gt] * len(targets))
    for i, (tgt, t_true) in enumerate(targets):
        # tgt(x) = gt(T_true x): registering tgt (as target) to gt (as
        # source) should find T with tgt(x) ~ gt(T x), i.e. T ~ T_true
        err0 = _mean_displacement(t_true, gt)
        err = _mean_displacement(np.linalg.inv(t_true) @ mats[i], gt)
        assert err < 0.5 * err0, f"pair {i}: {err0:.2f} -> {err:.2f} mm"


@pytest.mark.slow
def test_batched_mixed_shapes():
    """Pairs with different target shapes pad to a common batch shape
    without contaminating each other's costs."""
    gt = make_ground_truth(n=32, spacing=1.5)
    small = Image(np.ascontiguousarray(gt.data[4:-4, 2:-2, :]),
                  gt.attr.region(0, 2, 4, gt.attr.x, gt.attr.y - 2,
                                 gt.attr.z - 4))
    p = [1.5, -1.0, 1.0, 2.0, -1.5, 1.0]
    src, t_true = _transformed_copy(gt, p)
    cfg = VolRegConfig(levels=2, iterations=10, metric="cc")
    mats, _ = register_volumes_batched(cfg, [gt, small], [src, src])
    for i, tgt in enumerate([gt, small]):
        err0 = _mean_displacement(t_true, gt)
        err = _mean_displacement(t_true @ mats[i], gt)
        assert err < 0.6 * err0, f"pair {i}: {err0:.2f} -> {err:.2f} mm"
