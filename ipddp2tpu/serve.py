"""Continuous-batching solve pool: the serving layer.

A lockstep batch wastes device time: the slowest instance (e.g. 311
iterations) holds slots occupied by long-converged ones (median ~146 on
concar). This driver keeps a fixed number of device slots full — after every
chunk of iterations, converged/failed slots are harvested into the result set
and refilled with fresh instances from the queue, exactly like continuous
batching in LLM serving. Per-slot iteration limits ride the `run(k_limit=...)`
hook (a per-instance array under vmap), so freshly-seated instances and
veterans advance together in one compiled step.

Throughput gain ~ max_iterations / median_iterations of the workload (~2x on
the concar distribution) on top of whatever the batch amortizes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .options import Options
from .problem import Bounds, Problem
from .solve import Solution, initialize, run

Array = jax.Array


class PoolResult(NamedTuple):
    solutions: Solution      # leading axis = number of instances
    chunks: int              # device steps executed
    occupancy: float         # mean fraction of useful slot-iterations


def solve_pool(problem: Problem, bounds: Bounds, x1: Array, u_init: Array,
               theta=None, options: Optional[Options] = None,
               slots: int = 16, chunk: int = 20) -> PoolResult:
    """Solve N stacked instances using `slots` device slots.

    All array arguments carry the instance axis (N >= slots). Returns
    per-instance Solutions in input order.
    """
    options = options or Options()
    n = x1.shape[0]
    assert n >= slots, "need at least as many instances as slots"
    has_theta = theta is not None

    take = lambda tree, idx: jax.tree.map(lambda a: a[idx], tree)

    init_one = jax.jit(lambda b, x, u, th: initialize(
        problem, th, b, x, u, options))

    @jax.jit
    def run_chunk(state, b, th, k_limits):
        return jax.vmap(
            lambda s, bb, tt, kl: run(problem, bb, s, tt, options,
                                      k_limit=kl),
            in_axes=(0, Bounds(0, 0), 0 if has_theta else None, 0),
        )(state, b, th, k_limits)

    # seat the first `slots` instances
    idxs = jnp.arange(slots)
    slot_bounds = take(bounds, idxs)
    slot_theta = take(theta, idxs) if has_theta else None
    state = jax.vmap(init_one, in_axes=(Bounds(0, 0), 0, 0,
                                        0 if has_theta else None))(
        slot_bounds, x1[:slots], u_init[:slots],
        take(theta, idxs) if has_theta else None)
    active = np.arange(slots)          # instance index seated in each slot
    seated = slots
    live = np.ones(slots, bool)

    results = [None] * n
    chunks = 0
    useful = 0
    total_slot_iters = 0

    def harvest(state, slot):
        s = take(state, slot)
        return Solution(
            x=s.x, u=s.u, phi=s.phi, zl=s.zl, zu=s.zu, lam=s.lam,
            objective=s.objective, iterations=s.k, status=s.status,
            converged=s.converged, primal_inf=s.primal_inf,
            dual_inf=s.dual_inf, cs_inf=s.cs_inf, mu=s.mu)

    while live.any():
        k_now = np.asarray(state.k)
        k_limits = jnp.asarray(
            np.where(live, k_now + chunk,
                     k_now))              # idle slots frozen
        state = run_chunk(state, slot_bounds, slot_theta, k_limits)
        chunks += 1
        status = np.asarray(state.status)
        conv = np.asarray(state.converged)
        k_after = np.asarray(state.k)
        useful += int((k_after - k_now)[live].sum())
        total_slot_iters += int(live.sum()) * chunk

        # finished = converged, hard failure, or true iteration budget spent
        finished = live & (conv | ((status != 0) & (status != 8))
                           | (k_after >= options.max_iterations))
        # slots that merely hit the chunk cap continue
        resume = live & ~finished & (status == 8)
        if resume.any():
            state = state._replace(status=jnp.where(
                jnp.asarray(resume), jnp.int32(0), state.status))

        for slot in np.where(finished)[0]:
            results[active[slot]] = jax.tree.map(np.asarray,
                                                 harvest(state, int(slot)))
            if seated < n:
                i = seated
                fresh = init_one(
                    take(bounds, i), x1[i], u_init[i],
                    take(theta, i) if has_theta else None)
                state = jax.tree.map(
                    lambda s, f, sl=int(slot): s.at[sl].set(f), state, fresh)
                slot_bounds = jax.tree.map(
                    lambda sb, b, sl=int(slot): sb.at[sl].set(b[i]),
                    slot_bounds, bounds)
                if has_theta:
                    slot_theta = jax.tree.map(
                        lambda st, t, sl=int(slot): st.at[sl].set(t[i]),
                        slot_theta, theta)
                active[slot] = i
                seated += 1
            else:
                live[slot] = False

    solutions = jax.tree.map(lambda *leaves: np.stack(leaves), *results)
    return PoolResult(solutions=solutions, chunks=chunks,
                      occupancy=useful / max(total_slot_iters, 1))


def solve_pool_resident(problem: Problem, bounds: Bounds, x1: Array,
                        u_init: Array, theta=None,
                        options: Optional[Options] = None,
                        slots: int = 16, chunk: int = 20) -> PoolResult:
    """`solve_pool` with the harvest/refill queue ON DEVICE.

    The host-roundtrip pool pays a full-trajectory device->host read on
    every harvest and a separate `.at[slot].set` dispatch on every refill.
    Here the whole reservoir (instance params), the result buffers, and
    the seat bookkeeping are device arrays, and ONE jitted step advances
    every slot a chunk, scatters finished solutions into the result
    buffers, and re-seats fresh instances from the reservoir — the host
    reads a single "all done" scalar per chunk and downloads results once
    at the end. Whether either pool beats lockstep batching with frozen
    lanes on a given device is a measurement (not measured on the GPU).
    """
    options = options or Options()
    n = x1.shape[0]
    assert n >= slots, "need at least as many instances as slots"
    has_theta = theta is not None
    gather = lambda tree, idx: jax.tree.map(lambda a: a[idx], tree)

    def init_one(b, x, u, th):
        return initialize(problem, th, b, x, u, options)

    state0 = jax.vmap(init_one,
                      in_axes=(Bounds(0, 0), 0, 0, 0 if has_theta else None))(
        gather(bounds, jnp.arange(slots)), x1[:slots], u_init[:slots],
        gather(theta, jnp.arange(slots)) if has_theta else None)

    # result buffers carry one DUMP row at index n: unfinished/idle slots
    # scatter there. Only the Solution fields are buffered (the filter/
    # trial bookkeeping in SolverState never leaves the device).
    OUT_FIELDS = ("x", "u", "phi", "zl", "zu", "lam", "objective", "k",
                  "status", "converged", "primal_inf", "dual_inf",
                  "cs_inf", "mu")
    pick = lambda s: {f: getattr(s, f) for f in OUT_FIELDS}
    out0 = jax.tree.map(
        lambda a: jnp.zeros((n + 1,) + a.shape[1:], a.dtype), pick(state0))

    @jax.jit
    def step(carry):
        state, active, seated, out, useful = carry
        live = active < n
        sb = gather(bounds, jnp.minimum(active, n - 1))
        sth = (gather(theta, jnp.minimum(active, n - 1))
               if has_theta else None)
        k0 = state.k
        k_lim = jnp.where(live, k0 + chunk, k0)    # idle slots frozen
        state = jax.vmap(
            lambda s, bb, tt, kl: run(problem, bb, s, tt, options,
                                      k_limit=kl),
            in_axes=(0, Bounds(0, 0), 0 if has_theta else None, 0),
        )(state, sb, sth, k_lim)
        useful = useful + jnp.sum(jnp.where(live, state.k - k0, 0))

        finished = live & (state.converged
                           | ((state.status != 0) & (state.status != 8))
                           | (state.k >= options.max_iterations))
        resume = live & ~finished & (state.status == 8)
        state = state._replace(status=jnp.where(resume, jnp.int32(0),
                                                state.status))

        # harvest: scatter finished slots' states into the result buffers
        dst = jnp.where(finished, active, n)
        out = jax.tree.map(lambda o, s: o.at[dst].set(s), out, pick(state))

        # refill: rank finished slots; seat reservoir instances in order
        ranks = jnp.cumsum(finished.astype(jnp.int32)) - 1
        new_idx = jnp.where(finished, seated + ranks, n)
        valid = new_idx < n
        src = jnp.minimum(new_idx, n - 1)
        fresh = jax.vmap(init_one,
                         in_axes=(Bounds(0, 0), 0, 0,
                                  0 if has_theta else None))(
            gather(bounds, src), x1[src], u_init[src],
            gather(theta, src) if has_theta else None)
        seat = finished & valid
        state = jax.tree.map(
            lambda s, f: jnp.where(
                seat.reshape((-1,) + (1,) * (f.ndim - 1)), f, s),
            state, fresh)
        active = jnp.where(finished, jnp.where(valid, new_idx, n), active)
        seated = jnp.minimum(seated + jnp.sum(finished.astype(jnp.int32)),
                             n)
        return state, active, seated, out, useful

    carry = (state0, jnp.arange(slots), jnp.asarray(slots, jnp.int32),
             out0, jnp.asarray(0, jnp.int32))
    chunks = 0
    while True:
        carry = step(carry)
        chunks += 1
        if bool(np.asarray(jnp.all(carry[1] >= n))):   # one scalar read
            break

    state, _, _, out, useful = carry
    s = gather(out, jnp.arange(n))
    solutions = Solution(
        x=s["x"], u=s["u"], phi=s["phi"], zl=s["zl"], zu=s["zu"],
        lam=s["lam"], objective=s["objective"], iterations=s["k"],
        status=s["status"], converged=s["converged"],
        primal_inf=s["primal_inf"], dual_inf=s["dual_inf"],
        cs_inf=s["cs_inf"], mu=s["mu"])
    solutions = jax.tree.map(np.asarray, solutions)
    return PoolResult(solutions=solutions, chunks=chunks,
                      occupancy=float(np.asarray(useful))
                      / max(chunks * slots * chunk, 1))
