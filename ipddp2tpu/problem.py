"""Optimal control problem specification.

The solver targets discrete-time OCPs of the same class as the reference
(reference: README.md:5-15, src/data/problem.jl):

    minimize_{x,u}   sum_{t=0}^{T-1} l(x_t, u_t, t)  +  l_T(x_T)
    subject to       x_0 = x1
                     x_{t+1} = f(x_t, u_t, t)      t = 0..T-1   (dynamics)
                     c(x_t, u_t, t) = 0            t = 0..T-1   (stagewise equality)
                     lower_t <= u_t <= upper_t     t = 0..T-1   (+-inf allowed)

Horizon convention: the reference uses `N = horizon` stages where the last
stage has `num_control = 0` and carries only the terminal objective
(reference: src/data/problem.jl:41,71). Here we use `T = N - 1` *control*
stages with uniform (nx, nu, nc) plus an explicit terminal cost on x_T, which
removes the ragged terminal stage entirely — every per-stage array is a dense
`[T, ...]` block, the layout XLA tiles best.

Design stance (batch-first, see SURVEY.md §7):
  * `Problem` is a frozen, hashable dataclass of *functions and dims* — it is a
    static jit argument, so the whole solve specializes and compiles once per
    problem structure.
  * All runtime data (bounds, user parameters `theta`, initial state/controls)
    are arrays/pytrees, so the entire solver `vmap`s over problem instances
    (randomized bounds, obstacle positions, initial states, ...) — the batch
    axis that replaces the reference's serial `for seed = 1:100` loop
    (reference: experiments/ipddp2/concar.jl:28).

All user callables take an explicit stage index `t` and a parameter pytree
`theta` so that time-varying problems and instance batching need no closures:

    dynamics(x, u, t, theta)      -> x_next  [nx]
    stage_cost(x, u, t, theta)    -> scalar
    terminal_cost(x, theta)       -> scalar
    constraints(x, u, t, theta)   -> [nc]          (optional; nc may be 0)

Complementarity relaxation: constraint rows listed in `compl_indices` are
relaxed by the barrier parameter (c[i] -= mu), matching the reference's
`indices_compl` mechanism used for contact complementarity
(reference: src/data/methods.jl:27-29, src/constraints.jl:16-50).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax.numpy as jnp

Array = Any


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static problem structure (hashable: pass as a jit static argument)."""

    T: int                              # number of control stages (= reference horizon - 1)
    nx: int
    nu: int
    nc: int
    dynamics: Callable                  # f(x, u, t, theta) -> [nx]
    stage_cost: Callable                # l(x, u, t, theta) -> scalar
    terminal_cost: Callable             # lT(x, theta) -> scalar
    constraints: Optional[Callable] = None   # c(x, u, t, theta) -> [nc]
    compl_indices: tuple = ()           # constraint rows relaxed by mu
    contact: bool = False               # declares slack-encoded
                                        # complementarity / contact structure
                                        # (the reference benchmarks encode
                                        # contact as bilinear equality rows
                                        # with smoothing slacks rather than
                                        # via indices_compl); steers
                                        # inertia_method="auto" to the
                                        # reference-faithful BK oracle,
                                        # which measures at reference-level
                                        # success on these landscapes

    def __post_init__(self):
        if self.nc > 0 and self.constraints is None:
            raise ValueError("nc > 0 requires a constraints function")
        if any((i < 0 or i >= self.nc) for i in self.compl_indices):
            raise ValueError("compl_indices out of range")

    @property
    def horizon(self) -> int:
        """Reference-convention horizon N (= T + 1)."""
        return self.T + 1

    def eval_constraints(self, x, u, t, theta):
        if self.nc == 0:
            return jnp.zeros((0,), dtype=x.dtype)
        return self.constraints(x, u, t, theta)

    def compl_mask(self, dtype):
        """[nc] vector with 1.0 at mu-relaxed complementarity rows."""
        m = jnp.zeros((self.nc,), dtype=dtype)
        if self.compl_indices:
            m = m.at[jnp.array(self.compl_indices)].set(1.0)
        return m


class Bounds(NamedTuple):
    """Runtime control bounds, `[T, nu]` each, +-inf marks an absent bound.

    The reference keeps per-stage index lists of finite bounds
    (reference: src/bounds.jl:1-26); the static-shape equivalent here is
    isfinite masks used in `where`-selects.
    """

    lower: Array  # [T, nu]
    upper: Array  # [T, nu]

    @property
    def mask_lower(self):
        return jnp.isfinite(self.lower)

    @property
    def mask_upper(self):
        return jnp.isfinite(self.upper)

    @property
    def num_bounds(self):
        """Total count of finite bounds (scalar array)."""
        return jnp.sum(self.mask_lower) + jnp.sum(self.mask_upper)


def unbounded(T: int, nu: int, dtype=jnp.float64) -> Bounds:
    inf = jnp.inf
    return Bounds(
        lower=jnp.full((T, nu), -inf, dtype=dtype),
        upper=jnp.full((T, nu), inf, dtype=dtype),
    )


def uniform_bounds(T: int, lower, upper) -> Bounds:
    """Broadcast a single-stage bound pair to all T stages."""
    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)
    return Bounds(
        lower=jnp.broadcast_to(lower, (T,) + lower.shape),
        upper=jnp.broadcast_to(upper, (T,) + upper.shape),
    )


# Solver status codes — identical numbering to the reference
# (reference: src/data/solver.jl:5-7).
STATUS_OK = 0                     # converged / running
STATUS_BACKWARD_FAILED = 1        # no PD iteration matrix within reg ladder
STATUS_FRACTION_BOUNDARY = 2      # (transient) fraction-to-boundary violated
STATUS_FILTER_BLOCKED = 3         # (transient) trial blocked by filter
STATUS_ARMIJO_FAILED = 4          # (transient) Armijo decrease failed
STATUS_SUFFICIENT_PROGRESS = 5    # (transient) theta/L progress failed
STATUS_SOC_FAILED = 6             # reserved (reference never sets it)
STATUS_LINE_SEARCH_FAILED = 7     # step size underflowed machine eps
STATUS_MAX_ITERATIONS = 8
STATUS_STALLED = 9                # host-side stall freeze (no mu / KKT-error
                                  # progress over solve_chunked's
                                  # stall_window; ours — the reference has
                                  # no equivalent and burns to max_iter)

STATUS_MESSAGES = {
    STATUS_OK: "Optimal solution found",
    STATUS_BACKWARD_FAILED: "Backward pass failure: unable to find positive definite iteration matrix",
    STATUS_LINE_SEARCH_FAILED: "Line search failed to find a suitable iterate",
    STATUS_MAX_ITERATIONS: "Maximum solver iterations reached",
    STATUS_STALLED: "Stalled: frozen by the chunked driver (no progress)",
}
