"""Chunked solving: bounded-length device programs resumed from state.

The solver's `lax.while_loop` runs the whole barrier iteration on-device.
Chunking bounds the length of each device program, lets the host act
between chunks (stall freezing, batch compaction, adaptive line search) and
stops a batch as soon as every instance is done. Because the entire solver
state is one pytree (SURVEY.md §5 checkpoint/warm-start
design), the loop chunks cleanly: run at most `chunk` iterations per jitted
call, inspect convergence on the host, resume. Each resume re-enters
`run()` with the carried state — bitwise the same trajectory as the single
long program.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .options import Options
from .problem import Bounds, Problem
from .solve import Solution, initialize, run


def solve_chunked(problem: Problem, bounds: Bounds, x1, u_init, theta=None,
                  options: Optional[Options] = None, chunk: int = 25,
                  batched: bool = False, return_state: bool = False,
                  stall_window: Optional[int] = None,
                  compact_sizes=None, adapt_ls=None):
    """Solve (a batch of) instances with host-resumed iteration chunks.

    With `batched`, all array arguments carry a leading instance axis and the
    chunk loop continues until every instance converged/failed or the
    iteration budget is exhausted.

    `stall_window` (iterations) enables host-side stall freezing: a batched
    instance whose barrier parameter mu has not decreased AND whose KKT
    error has not improved by >=1.2x over the window is frozen (status 9).
    In a lockstep batch the handful of stalled instances otherwise run to
    the full iteration cap and stretch the whole batch's wall; they do not
    converge anyway (measured: the bench's f32-phase failures all sit at
    the cap).
    """
    options = options or Options()

    init = initialize if not batched else jax.vmap(
        lambda b, x, u, th: initialize(problem, th, b, x, u, options),
        in_axes=(Bounds(0, 0), 0, 0, None if theta is None else 0))

    if batched:
        state = init(bounds, x1, u_init, theta)
    else:
        state = initialize(problem, theta, bounds, x1, u_init, options)

    state = run_chunked(problem, bounds, state, theta, options,
                        chunk=chunk, batched=batched,
                        stall_window=stall_window if batched else None,
                        compact_sizes=compact_sizes if batched else None,
                        adapt_ls=adapt_ls if batched else None)

    sol = Solution(
        x=state.x, u=state.u, phi=state.phi, zl=state.zl, zu=state.zu,
        lam=state.lam, objective=state.objective, iterations=state.k,
        status=state.status, converged=state.converged,
        primal_inf=state.primal_inf, dual_inf=state.dual_inf,
        cs_inf=state.cs_inf, mu=state.mu)
    return (sol, state) if return_state else sol


@lru_cache(maxsize=16)
def _chunk_runner(problem: Problem, options: Options, batched: bool,
                  has_theta: bool):
    """Memoized jitted chunk executor. A fresh `jax.jit` closure per
    `run_chunked` call would re-trace the full solver on every call (and
    every compaction rung) — tracing a b1024 program costs seconds that
    land inside the timed wall even when the XLA executable is cached.

    NB the cache keys on object identity of `problem`'s function members
    (NamedTuples hash their fields; functions hash by id): callers must
    reuse the same `Problem`/`Options` objects across calls for the
    memoization to hit. Fresh closures per call never hit yet still fill
    the cache, pinning dead compiled programs — hence the small maxsize."""

    @jax.jit
    def run_chunk(state, bounds, theta, k_limits):
        if batched:
            fn = jax.vmap(
                lambda s, b, th, kl: run(problem, b, s, th, options,
                                         k_limit=kl),
                in_axes=(0, Bounds(0, 0), 0 if has_theta else None, 0))
            return fn(state, bounds, theta, k_limits)
        return run(problem, bounds, state, theta, options,
                   k_limit=k_limits)

    return run_chunk


@jax.jit
def _gather_tree(tree, idx):
    return jax.tree.map(lambda a: a[idx], tree)


@jax.jit
def _scatter_tree(tree, idx, sub):
    return jax.tree.map(lambda a, c: a.at[idx].set(c), tree, sub)


def run_chunked(problem: Problem, bounds: Bounds, state, theta=None,
                options: Optional[Options] = None, chunk: int = 25,
                batched: bool = False, total=None,
                stall_window: Optional[int] = None,
                compact_sizes=None, adapt_ls=None):
    """Continue `run` from an existing state in host-resumed chunks
    (the warm-start entry point for chunked execution).

    Iteration limits are per-instance (state.k + chunk for the still-running
    ones), so a batch with heterogeneous progress — e.g. a warm-started
    second phase where some instances already spent their budget — advances
    every live instance regardless of the stragglers.

    `total` overrides options.max_iterations as the iteration ceiling; it
    may be a per-instance array (e.g. `state.k + phase2_budget` to bound a
    warm-started endgame per instance).

    `adapt_ls` (ascending tuple of candidate K values, batched only) enables
    per-chunk adaptive hybrid line search: at each chunk boundary the host
    reads the running instances' last line-search trial counts
    (`state.num_ls`) and picks the smallest candidate K covering their 90th
    percentile for the next chunk. Early iterations backtrack deep (want a
    wide speculative batch), late iterations accept gamma=1 (a narrow one);
    a static K pays for the wrong regime half the time. Requires hybrid
    mode (`ls_speculative > 0` with `ls_spec_continue`), whose accept
    semantics — largest acceptable gamma — are K-invariant, so switching K
    between chunks never changes which step is taken, only what it costs.
    Each candidate K compiles its own program (keep the set small).

    `compact_sizes` (descending tuple, batched only) enables batch
    compaction at chunk boundaries: when the still-running instances fit a
    smaller size from the schedule, they are gathered (device-side) into a
    compact batch that continues chunking, and scattered back on return.
    Under lockstep vmap a converged lane still executes every masked
    iteration; that is free when an iteration is latency-bound (the f32
    phase) but pays full price when it is compute-bound — the f64 endgame,
    where the median instance needs ~6 iterations and the cap is ~40. Not
    compatible with `stall_window` (phase-1 machinery; compaction is a
    phase-2 tool). NB each compact size compiles its own program — sizes
    should be few (powers of two) and warmed in the compile cache."""
    options = options or Options()
    if total is None:
        total = options.max_iterations
    total = np.asarray(total)
    if compact_sizes:
        assert batched and stall_window is None, (
            "compact_sizes requires batched=True and no stall_window")
        compact_sizes = tuple(sorted(set(int(s) for s in compact_sizes),
                                     reverse=True))
    if adapt_ls:
        assert batched, "adapt_ls requires batched=True"
        if options.ls_speculative <= 0 or not options.ls_spec_continue:
            adapt_ls = None     # only the hybrid LS is K-invariant
        else:
            adapt_ls = tuple(sorted(set(int(k) for k in adapt_ls)))

    run_chunk = _chunk_runner(problem, options, batched, theta is not None)

    stall = None
    while True:
        k_now = np.asarray(state.k)
        conv = np.asarray(state.converged)
        status = np.asarray(state.status)
        running = (~conv & ((status == 0) | (status == 8))
                   & (k_now < total))
        if stall_window is not None:
            err = np.maximum(np.asarray(state.primal_inf),
                             np.maximum(np.asarray(state.dual_inf),
                                        np.asarray(state.cs_inf)))
            mu_now = np.asarray(state.mu)
            if stall is None:
                # err starts at +inf: initialize() zeroes the KKT-error
                # fields, so baselining on the pre-first-chunk state would
                # make the improvement clause unsatisfiable until the first
                # mu decrease and wrongly freeze converging instances
                stall = {"err": np.full_like(err, np.inf), "mu": mu_now,
                         "k": k_now.astype(float)}
            else:
                improved = (err < stall["err"] / 1.2) | (mu_now
                                                         < stall["mu"])
                stall["err"] = np.where(improved, err, stall["err"])
                stall["mu"] = np.minimum(mu_now, stall["mu"])
                stall["k"] = np.where(improved, k_now, stall["k"])
                stalled = running & (k_now - stall["k"] >= stall_window)
                if stalled.any():
                    state = state._replace(status=jnp.where(
                        jnp.asarray(stalled), jnp.int32(9), state.status))
                    running = running & ~stalled
        if not np.any(running):
            break
        if compact_sizes:
            B = running.shape[0]
            r = int(running.sum())
            fit = [s for s in compact_sizes if r <= s < B]
            if fit:
                target = min(fit)
                idx = np.concatenate(
                    [np.where(running)[0],
                     np.where(~running)[0][:target - r]])
                jidx = jnp.asarray(idx)
                sub_state = _gather_tree(state, jidx)
                sub_bounds = _gather_tree(bounds, jidx)
                sub_theta = (None if theta is None
                             else _gather_tree(theta, jidx))
                sub_total = np.broadcast_to(total, (B,))[idx]
                # pad lanes are non-running (converged/failed/spent); the
                # recursion's own running mask keeps them frozen
                sub_state = run_chunked(problem, sub_bounds, sub_state,
                                        sub_theta, options, chunk=chunk,
                                        batched=True, total=sub_total,
                                        compact_sizes=compact_sizes)
                return _scatter_tree(state, jidx, sub_state)
        if adapt_ls and np.any(np.asarray(state.num_ls) > 0):
            # pick the smallest K covering the running instances' p90
            # line-search depth (num_ls is the LAST iteration's trial
            # count; across a large batch its p90 is a stable regime
            # signal). Instances beyond K fall to the sequential
            # continuation, whose lockstep trips are max-over-batch —
            # covering the extreme tail is what the K=8-everywhere
            # measurement showed to be a net loss.
            depth = np.asarray(state.num_ls)[running]
            d90 = float(np.percentile(depth, 90)) if depth.size else 1.0
            K = next((k for k in adapt_ls if k >= d90), adapt_ls[-1])
            if K != options.ls_speculative:
                options = options.__class__(**{
                    **options.__dict__, "ls_speculative": K})
                run_chunk = _chunk_runner(problem, options, batched,
                                          theta is not None)
        # clear transient hit-the-chunk-cap stops on the running instances
        state = state._replace(status=jnp.where(
            jnp.asarray(running & (status == 8)), jnp.int32(0),
            state.status))
        k_next = np.where(running, np.minimum(k_now + chunk, total), k_now)
        k_limits = jnp.asarray(k_next, jnp.int32)
        if not batched:
            k_limits = k_limits.reshape(())
        state = run_chunk(state, bounds, theta, k_limits)
    return state
