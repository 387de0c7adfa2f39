"""Instance batching: the data-parallel axis of the framework.

The reference solves randomized problem instances in a serial seed loop
(reference: experiments/ipddp2/concar.jl:28); here the *entire solver* is
`vmap`ped over instances — initial states, control bounds, and problem
parameters theta all batch — so one jitted call drives thousands of
independent interior-point solves in lockstep on a chip. Converged or failed
instances freeze their slice of the carried state (batched `lax.while_loop`
masking) while the rest keep iterating; per-instance status codes replace
the reference's per-seed result rows (SURVEY.md §2.3, §5).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .options import Options
from .problem import Bounds, Problem
from .solve import Solution, solve

Array = jax.Array


class BatchStats(NamedTuple):
    """Aggregate convergence bookkeeping for a batch of instances."""

    num_instances: Array
    num_converged: Array
    num_failed: Array          # status != 0 (line search / backward failures)
    max_iterations: Array      # slowest instance
    median_iterations: Array
    max_primal_inf: Array
    max_dual_inf: Array


def solve_batch(problem: Problem, bounds: Bounds, x1: Array, u_init: Array,
                theta=None, options: Optional[Options] = None) -> Solution:
    """Solve a batch of instances of one problem family.

    All array arguments carry a leading batch axis (bounds arrays included —
    instances may have different control limits, as in the reference's
    randomized concar benchmark). `theta` is a pytree whose leaves carry the
    batch axis, or None.
    """
    options = options or Options()
    theta_axes = None if theta is None else 0
    return jax.vmap(
        partial(solve, problem, options=options),
        in_axes=(Bounds(0, 0), 0, 0, theta_axes),
    )(bounds, x1, u_init, theta)


def batch_stats(sol: Solution) -> BatchStats:
    """Summarize a batched Solution (pure; works inside jit/shard_map)."""
    n = sol.converged.shape[0]
    return BatchStats(
        num_instances=jnp.asarray(n),
        num_converged=jnp.sum(sol.converged),
        num_failed=jnp.sum(sol.status != 0),
        max_iterations=jnp.max(sol.iterations),
        median_iterations=jnp.median(sol.iterations),
        max_primal_inf=jnp.max(sol.primal_inf),
        max_dual_inf=jnp.max(sol.dual_inf),
    )
