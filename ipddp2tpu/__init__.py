"""ipddp2tpu — a batched IPDDP2 trajectory-optimization framework in JAX.

A JAX/XLA/Pallas implementation of primal-dual interior-point Differential
Dynamic Programming (IPDDP2, arXiv:2504.08278) for discrete-time optimal
control with nonlinear dynamics, stagewise equality constraints and control
bounds — the capability set of the reference Julia package
InteriorPointDDP.jl, re-designed for batched accelerator execution:

  * derivatives via jacfwd/grad composition under jit (replaces Symbolics.jl
    codegen),
  * the backward pass as a reverse `lax.scan` of per-stage primal-dual KKT
    solves backed by batched LDL^T factorizations with inertia correction,
  * a filter line-search rollout as `lax.scan` + `lax.while_loop`,
  * thousands of OCP instances `vmap`ped per device and sharded across a
    device mesh with `shard_map`, collectives only for convergence
    bookkeeping.

Public API (functional core + reference-parity facade):

    Problem, Bounds, Options, solve         — functional core
    Dynamics, Objective, Constraint, Bound,
    Solver, solve_solver, get_trajectory    — reference-style facade
                                              (reference exports:
                                              src/InteriorPointDDP.jl:29-45)
"""

from .options import Options
from .problem import Bounds, Problem, uniform_bounds, unbounded
from .solve import Solution, SolverState, solve
from .solver import (Bound, Constraint, Dynamics, Objective, Solver,
                     current_trajectory, get_trajectory)
from .batch import solve_batch
from .chunked import solve_chunked
from .mixed import solve_mixed, solve_mixed_chunked
from .serve import solve_pool

__version__ = "0.1.0"

__all__ = [
    "Options", "Problem", "Bounds", "uniform_bounds", "unbounded",
    "Solution", "SolverState", "solve",
    "Dynamics", "Objective", "Constraint", "Bound", "Solver",
    "get_trajectory", "current_trajectory",
    "solve_batch", "solve_chunked", "solve_mixed", "solve_mixed_chunked",
    "solve_pool",
]
