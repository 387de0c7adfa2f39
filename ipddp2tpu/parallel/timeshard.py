"""Time-axis sharding: the suffix value scan distributed over a device mesh.

The framework's sequence-parallel axis (SURVEY.md §5 "long-context analog"):
for horizons far beyond one chip's sweet spot, the associative value
recursion (parallel/priccati.py) shards over time like blockwise attention —
each device scans its contiguous block of stages locally, the per-block
composed elements (5 small [nx, nx]/[nx] tensors, a few KB) are exchanged
with ONE all_gather over the mesh axis, every device composes its boundary
prefix from the terminal-side block totals, and one vmapped combine folds it
into the local prefixes. Communication is O(D) tiny elements riding the
ICI — the Riccati analog of ring attention's KV exchange, with the
associative-combine playing softmax-rescaling's role.

Depth: O(T/D + log D) combines vs O(log T) single-device vs O(T) sequential;
bytes on the wire per sweep: D * (3 nx^2 + 2 nx) floats.

Usable inside `jax.shard_map` over a 1-D time mesh; parity vs the
single-device scan is pinned by tests/test_timeshard.py on the 8-virtual-
device CPU mesh (SURVEY.md §4's fake-backend analog).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..problem import Problem
from .priccati import ValueElement, combine

Array = jax.Array


def _identity_element(nx: int, dtype) -> ValueElement:
    """Neutral element of `combine`: V composes through unchanged."""
    return ValueElement(
        A=jnp.eye(nx, dtype=dtype),
        b=jnp.zeros((nx,), dtype),
        C=jnp.zeros((nx, nx), dtype),
        eta=jnp.zeros((nx,), dtype),
        J=jnp.zeros((nx, nx), dtype),
    )


def _block_scan(seq: ValueElement) -> ValueElement:
    """Inclusive associative scan of one local block (reverse-time order)."""
    return jax.lax.associative_scan(combine, seq, reverse=False)


def value_scan_timesharded(problem: Problem, elements: ValueElement,
                           lTx: Array, lTxx: Array, mesh: Mesh,
                           axis: str = "sp"):
    """Suffix value functions with the time axis sharded over `mesh[axis]`.

    Same contract as `priccati.parallel_value_scan`: elements are the [T,...]
    per-stage value maps of the CURRENT iterate; returns (Vx [T, nx],
    Vxx [T, nx, nx]) with entry t = V_{t+1}. T must divide the axis size.
    """
    T, nx = problem.T, problem.nx
    D = mesh.shape[axis]
    assert T % D == 0, "the time-mesh axis size must divide the horizon T"
    dtype = elements.A.dtype

    # reverse-time ordering with the terminal element prepended, as in the
    # single-device scan (priccati.parallel_value_scan)
    term = ValueElement(
        A=jnp.zeros((nx, nx), dtype), b=jnp.zeros((nx,), dtype),
        C=jnp.zeros((nx, nx), dtype), eta=-lTx, J=lTxx)
    rev = jax.tree.map(lambda a: jnp.flip(a, axis=0), elements)
    seq = jax.tree.map(lambda t_, r: jnp.concatenate([t_[None], r[:-1]]),
                       term, rev)

    def shard_fn(local: ValueElement) -> tuple:
        # 1. local inclusive scan over this device's stage block
        local_scan = _block_scan(local)
        # 2. exchange block totals (the last local prefix) over the axis
        total = jax.tree.map(lambda a: a[-1], local_scan)
        totals = jax.tree.map(
            lambda a: jax.lax.all_gather(a, axis), total)  # [D, ...]
        # 3. exclusive prefix of the terminal-side totals for this block:
        #    block d needs totals of blocks 0..d-1 composed (block 0 holds
        #    the terminal element; reverse-time order). Computed redundantly
        #    per device in O(D) combines — D is the mesh size, tiny.
        idx = jax.lax.axis_index(axis)
        # tie the identity element to a varying input so the fori_loop
        # carry's varying-manual-axes match under shard_map (same pattern
        # as solve.initialize's `seed`)
        vzero = local.b[0, 0] * 0
        prefix0 = jax.tree.map(lambda a: a + vzero,
                               _identity_element(nx, dtype))

        def fold(d, acc):
            use = d < idx
            tot_d = jax.tree.map(lambda a: a[d], totals)
            new = combine(acc, tot_d)
            return jax.tree.map(lambda n, a: jnp.where(use, n, a), new, acc)

        prefix = jax.lax.fori_loop(0, D, fold, prefix0)
        # 4. fold the boundary prefix into every local prefix
        out = jax.vmap(lambda e: combine(prefix, e))(local_scan)
        return out

    spec_elem = jax.tree.map(lambda _: P(axis), seq)
    acc = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(spec_elem,), out_specs=spec_elem,
    ))(seq)

    Vxx = jnp.flip(acc.J, axis=0)
    Vx = jnp.flip(-acc.eta, axis=0)
    return Vx, Vxx


# ---------------------------------------------------------------------------
# End-to-end wiring: backward_mode="timeshard"
#
# The solver core is mesh-agnostic (Options is a frozen jit-static config and
# cannot hold a Mesh), so the active time mesh is communicated through a
# module-level trace-time context: `solve_timesharded` sets it for the
# duration of tracing, and `solve._body` reads it when options.backward_mode
# == "timeshard" to plug `value_scan_timesharded` into the parallel backward
# pass. The context matters only while the solve traces — the mesh is baked
# into the compiled program.
# ---------------------------------------------------------------------------

import contextlib as _contextlib

_ACTIVE_TIME_MESH: list = []


def active_time_mesh():
    """The (mesh, axis) installed by `use_time_mesh`, or raise."""
    if not _ACTIVE_TIME_MESH:
        raise RuntimeError(
            'backward_mode="timeshard" needs an active time mesh; call the '
            "solve through `solve_timesharded(...)` or wrap tracing in "
            "`use_time_mesh(mesh, axis)`")
    return _ACTIVE_TIME_MESH[-1]


@_contextlib.contextmanager
def use_time_mesh(mesh: Mesh, axis: str = "sp"):
    _ACTIVE_TIME_MESH.append((mesh, axis))
    try:
        yield
    finally:
        _ACTIVE_TIME_MESH.pop()


def solve_timesharded(problem: Problem, bounds, x1, u_init, theta=None,
                      options=None, mesh: Mesh = None, axis: str = "sp"):
    """Solve ONE instance with the backward pass's value scan sharded over
    the mesh's time axis — the long-horizon (T >> 100) regime where a single
    solve spans chips and the O(T/D + log D)-depth blockwise scan replaces
    the sequential recursion. `mesh` defaults to a 1-D mesh over all devices;
    T must divide the axis size."""
    import dataclasses

    from ..options import Options
    from ..solve import solve

    if mesh is None:
        import numpy as np
        mesh = Mesh(np.asarray(jax.devices()), (axis,))
    options = options or Options()
    options = dataclasses.replace(options, backward_mode="timeshard")
    with use_time_mesh(mesh, axis):
        return solve(problem, bounds, x1, u_init, theta=theta,
                     options=options)
