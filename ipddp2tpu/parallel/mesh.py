"""Multi-chip scaling: shard the instance batch over a device mesh.

The reference has no distributed code of any kind (SURVEY.md §2.3); this layer
is new design. Instances are embarrassingly parallel, so the sharding story
is: lay the batch out over the mesh's data-parallel axis with `shard_map`,
let each device run its shard's lockstep solves, and use collectives only for
convergence bookkeeping — `psum`/`pmax` of (num converged, max errors) ride
the interconnect (NVLink between GPUs); no other cross-device traffic
exists. This replaces the NCCL/MPI-style backend a torch port would have
reached for.

Axis conventions:
  * "dp" — instance/data parallel (the only partitioned axis; trajectories of
    a single OCP are small and stay chip-local).
  * The time axis stays `lax.scan`-sequential for exactness; an optional
    associative-scan parallel-Riccati mode over sharded time segments is the
    planned "sequence-parallel" analog (SURVEY.md §5).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..batch import BatchStats, solve_batch
from ..options import Options
from ..problem import Bounds, Problem
from ..solve import Solution

Array = jax.Array


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """A 1-D mesh over all (or the given) devices."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def sharded_batch_stats(sol: Solution, axis: str = "dp") -> BatchStats:
    """Cross-device convergence bookkeeping: the only collectives in the
    framework (psum/pmax over the mesh's dp axis)."""
    shard_n = sol.converged.shape[0]
    return BatchStats(
        num_instances=jax.lax.psum(jnp.asarray(shard_n), axis),
        num_converged=jax.lax.psum(jnp.sum(sol.converged), axis),
        num_failed=jax.lax.psum(jnp.sum(sol.status != 0), axis),
        max_iterations=jax.lax.pmax(jnp.max(sol.iterations), axis),
        # median over shards is approximated by the mean of shard medians —
        # bookkeeping only, not used for control flow
        median_iterations=jax.lax.pmean(
            jnp.median(sol.iterations), axis),
        max_primal_inf=jax.lax.pmax(jnp.max(sol.primal_inf), axis),
        max_dual_inf=jax.lax.pmax(jnp.max(sol.dual_inf), axis),
    )


def solve_sharded(problem: Problem, bounds: Bounds, x1: Array, u_init: Array,
                  theta=None, options: Optional[Options] = None,
                  mesh: Optional[Mesh] = None, axis: str = "dp"):
    """Solve a batch of instances sharded over the mesh's `axis`.

    The batch size must divide the mesh axis size. Returns the batched
    `Solution` (sharded along the batch axis) and replicated `BatchStats`.
    """
    options = options or Options()
    mesh = mesh or make_mesh(axis=axis)

    spec = P(axis)
    theta_spec = None if theta is None else jax.tree.map(
        lambda _: spec, theta)

    def shard_fn(bounds, x1, u_init, theta):
        sol = solve_batch(problem, bounds, x1, u_init, theta=theta,
                          options=options)
        stats = sharded_batch_stats(sol, axis)
        return sol, stats

    in_specs = (Bounds(spec, spec), spec, spec, theta_spec)
    out_specs = (jax.tree.map(lambda _: spec, Solution(*[0] * len(Solution._fields))),
                 jax.tree.map(lambda _: P(), BatchStats(*[0] * len(BatchStats._fields))))

    # check_vma verifies the collectives above; the backward-sweep kernel
    # carries its inputs' vma into its out_shape.
    fn = jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=True))
    return fn(bounds, x1, u_init, theta)
