"""Batched rigid gradient-descent optimizer (shared engine).

The reference implements this optimizer twice — on CPU
(irtkGradientDescentOptimizer.cc driven by irtkImageRegistration::Run) and
on GPU (registerMultipleSlicesToVolume, reconstruction_cuda2.cu:4001-4147).
Both share the same structure, reproduced here once, vectorized over a
batch of independent rigid problems advancing in lock-step with active
masks:

  for each step-size round (step halved each round):
    for each iteration (up to cfg.iterations):
      sim0 = cost(params)
      grad[p] = cost(params + step e_p) - cost(params - step e_p)  (6 dims)
      grad /= ||grad||
      while any active slice improves by > eps: params += step * grad
      (implicit backtrack: failed trials are not applied)
      deactivate problems with no improvement this iteration
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    steps: int = 4
    iterations: int = 20
    epsilon: float = 1e-4
    max_linesearch: int = 16


def optimize_level(cfg: OptimizerConfig, cost: Callable, params0, step0):
    """Run the full step-halving schedule at one pyramid level.

    cost: (N,6) params -> (N,) similarity (maximized).
    Returns (params (N,6), similarity (N,)).
    """
    n = params0.shape[0]
    eye6 = jnp.eye(6, dtype=params0.dtype)

    def step_round(carry, step_size):
        params, _ = carry

        def grad_iter(carry2, _):
            params, active, _ = carry2
            sim0 = cost(params)

            def probe(_, e_p):
                sp = cost(params + step_size * e_p[None, :])
                sm = cost(params - step_size * e_p[None, :])
                return 0, sp - sm

            _, grads = jax.lax.scan(probe, 0, eye6)  # (6, N)
            grad = jnp.moveaxis(grads, 0, -1)
            norm = jnp.linalg.norm(grad, axis=-1, keepdims=True)
            grad = jnp.where(norm > 0, grad / jnp.maximum(norm, 1e-30), 0.0)

            def ls_cond(state):
                _, _, ls_active, it = state
                return jnp.any(ls_active) & (it < cfg.max_linesearch)

            def ls_body(state):
                prms, best, ls_active, it = state
                trial = prms + step_size * grad * ls_active[:, None]
                sim_new = cost(trial)
                improved = ls_active & (sim_new > best + cfg.epsilon)
                prms = jnp.where(improved[:, None], trial, prms)
                best = jnp.where(improved, sim_new, best)
                return prms, best, improved, it + 1

            params, best, _, _ = jax.lax.while_loop(
                ls_cond, ls_body,
                (params, sim0, active, jnp.zeros((), jnp.int32)))
            active = active & (best > sim0 + cfg.epsilon)
            return (params, active, best), None

        active0 = jnp.ones((n,), bool)
        (params, _, best), _ = jax.lax.scan(
            grad_iter, (params, active0, jnp.zeros((n,), params0.dtype)),
            None, length=cfg.iterations)
        return (params, best), None

    steps = jnp.asarray([step0 / (2.0 ** s) for s in range(cfg.steps)],
                        params0.dtype)
    (params, sim), _ = jax.lax.scan(
        step_round, (params0, jnp.zeros((n,), params0.dtype)), steps)
    return params, sim


def coord_sweep(cost: Callable, params, active, best, step_size,
                epsilon: float):
    """One Gauss-Seidel sweep over the 6 DOFs (shared by the scanned
    optimize_level_coord and the stepped per-sweep driver in
    slice2vol — identical accept semantics by construction).

    The accept threshold is SCALE-AWARE: a trial step of size s must
    improve the similarity by epsilon * max(s, 1) — large steps on a
    flat cost ridge are drift, not signal (round-4 measurement: with a
    flat threshold the sweep walks well-aligned slices off truth
    chasing noise-level gains against a blurred template; a flat
    RAISED threshold instead kills the small refinement steps real
    motion recovery needs).

    The 6 DOF blocks run as ONE lax.scan body, not unrolled — scan is
    sequential, so the Gauss-Seidel update order is preserved exactly,
    and the HLO holds a single cost-eval instance instead of 12, which
    keeps compile time down.

    Returns (params, active & improved, best)."""
    n = params.shape[0]
    eye6 = jnp.eye(6, dtype=params.dtype)
    eps_base = epsilon * jnp.maximum(step_size, 1.0)
    # through-plane DOFs of a thick slice (tz, rx, ry — params 2, 3, 4)
    # see mostly forward-model blur mismatch, not signal: their accept
    # threshold is 4x stiffer (round-4 measurement: ungated
    # through-plane moves dragged well-aligned slices off truth)
    eps_fac = jnp.asarray([1.0, 1.0, 4.0, 4.0, 4.0, 1.0], params.dtype)

    def dof_block(carry, inp):
        params, best, improved = carry
        e_p, fac = inp
        eps_eff = eps_base * fac
        delta = step_size * e_p[None, :]
        cp = cost(params + delta)
        cm = cost(params - delta)
        # directional-contrast gate: besides improving on `best`, the
        # central difference cp - cm must itself be decisive — on a
        # near-flat DOF (through-plane translation of a thick slice)
        # both probes hover at best+noise and an ungated sweep walks
        # the slice along the flat valley; the reference's normalized
        # gradient implicitly suppressed such DOFs, this is the
        # per-DOF analog
        take_p = active & (cp > best + eps_eff) & (cp >= cm + eps_eff)
        take_m = active & (cm > best + eps_eff) & (cm >= cp + eps_eff) \
            & ~take_p
        sign = (take_p.astype(params.dtype)
                - take_m.astype(params.dtype))
        params = params + delta * sign[:, None]
        best = jnp.where(take_p, cp, jnp.where(take_m, cm, best))
        improved = improved | take_p | take_m
        return (params, best, improved), None

    (params, best, improved), _ = jax.lax.scan(
        dof_block, (params, best, jnp.zeros((n,), bool)),
        (eye6, eps_fac))
    return params, active & improved, best


def optimize_level_coord(cfg: OptimizerConfig, cost: Callable, params0,
                         step0):
    """Per-DOF coordinate search (Gauss-Seidel) at one pyramid level.

    DOCUMENTED DEVIATION from the reference optimizer: the reference's
    gradient scheme probes every DOF at +-step, normalizes the 6-vector
    and line-searches ALONG THAT MIXED DIRECTION — when translation and
    rotation axes have very different cost curvature the direction
    overshoots the narrow axis and the round deactivates after one
    failed trial (round-4 measurement on a textured-slice problem with
    6 deg in-plane rotation + 1.5 mm shift: gradient descent stalls at
    rz~0.3 deg and chained restarts are a fixed point, while this sweep
    recovers (1.5 mm, 6.0 deg) exactly — tools/README.md).  Each sweep
    tries +-step on each DOF independently and accepts per-slice
    improvements; 12 cost evaluations per sweep, the same budget as one
    gradient iteration, with no line search needed.

    cost: (N,6) params -> (N,) similarity (maximized).
    Returns (params (N,6), similarity (N,)).
    """
    n = params0.shape[0]

    def step_round(carry, step_size):
        params, _ = carry

        def sweep(carry2, _):
            params, active, best = carry2
            params, active, best = coord_sweep(cost, params, active, best,
                                               step_size, cfg.epsilon)
            return (params, active, best), None

        best0 = cost(params)
        active0 = jnp.ones((n,), bool)
        (params, _, best), _ = jax.lax.scan(
            sweep, (params, active0, best0), None, length=cfg.iterations)
        return (params, best), None

    steps = jnp.asarray([step0 / (2.0 ** s) for s in range(cfg.steps)],
                        params0.dtype)
    (params, sim), _ = jax.lax.scan(
        step_round, (params0, jnp.zeros((n,), params0.dtype)), steps)
    return params, sim
