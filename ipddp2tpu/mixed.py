"""Mixed-precision continuation: f32 bulk phase + f64 certification endgame.

The reference runs Float64 end to end (its LAPACK path is CPU-native f64).
An f64 iteration costs more than an f32 one on an accelerator, while f32
alone cannot certify a 1e-7 KKT point (eps_f32 ~ 1.2e-7). The continuation
exploits the interior-point structure: the barrier path down to mu ~ 1e-4
is insensitive to f32 rounding, so the bulk of the iterations run in f32;
the converged-in-f32 state then warm-starts (SURVEY.md §5's warm-start API)
an f64 solve that only has the endgame left — typically a handful of
iterations at small mu.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .derivatives import evaluate_constraints, relax_constraints
from .forward import barrier_lagrangian
from .options import Options
from .problem import Bounds, Problem
from .solve import Solution, SolverState, full_precision, initialize, run


def _cast_state(state: SolverState, dtype) -> SolverState:
    def cast(a):
        return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a

    return jax.tree.map(cast, state)


@full_precision
def promote_state(problem: Problem, bounds: Bounds, state: SolverState,
                  theta, options: Options) -> SolverState:
    """Cast an f32 state to f64 and refresh the merit bookkeeping in full
    precision (constraints, barrier Lagrangian, filter reset)."""
    s = _cast_state(state, jnp.float64)
    c_raw = evaluate_constraints(problem, theta, s.x, s.u)
    c_rel = relax_constraints(problem, c_raw, s.mu)
    L, J = barrier_lagrangian(problem, theta, bounds, s.x, s.u, c_rel,
                              s.phi, s.il, s.iu, s.mu)
    from .solve import _reset_filter

    return s._replace(
        c_raw=c_raw, objective=J, L_curr=L,
        theta_curr=jnp.sum(jnp.abs(c_rel)),
        filter_pts=_reset_filter(
            jnp.zeros((options.filter_capacity, 2), jnp.float64),
            s.max_primal_1),
        filter_n=s.filter_n * 0 + 1,
        status=s.status * 0, converged=s.converged & False)


def solve_mixed(problem: Problem, bounds: Bounds, x1, u_init, theta=None,
                options: Optional[Options] = None,
                phase1_tolerance: float = 3e-4,
                phase1_max_iterations: Optional[int] = None,
                return_state: bool = False):
    """Two-phase solve. `bounds`/`x1`/`u_init`/`theta` may be f32 or f64;
    phase 1 runs in f32 to `phase1_tolerance`, phase 2 in f64 to
    `options.optimality_tolerance`. Fully jittable / vmappable.

    `phase1_max_iterations` caps the f32 phase separately: the iteration
    budget (`options.max_iterations`) is shared across phases (k carries
    through the promote, reference max-iterations semantics), so without a
    cap an f32-stalled instance burns its whole budget before the f64
    endgame can rescue it."""
    options = options or Options()
    f32 = jnp.float32
    cast32 = lambda a: (a.astype(f32)
                        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                        else a)
    bounds32 = jax.tree.map(cast32, bounds)
    theta32 = jax.tree.map(cast32, theta) if theta is not None else None
    p1_max = min(options.max_iterations,
                 phase1_max_iterations or options.max_iterations)
    opts32 = options.__class__(**{
        **options.__dict__, "optimality_tolerance": phase1_tolerance,
        "max_iterations": p1_max})

    s32 = initialize(problem, theta32, bounds32,
                     jnp.asarray(x1, f32), jnp.asarray(u_init, f32), opts32)
    s32 = run(problem, bounds32, s32, theta32, opts32)

    cast64 = lambda a: (a.astype(jnp.float64)
                        if jnp.issubdtype(jnp.asarray(a).dtype,
                                          jnp.floating) else a)
    bounds64 = jax.tree.map(cast64, bounds)
    theta64 = jax.tree.map(cast64, theta) if theta is not None else None
    s64 = promote_state(problem, bounds64, s32, theta64, options)
    s64 = run(problem, bounds64, s64, theta64, options)

    sol = Solution(
        x=s64.x, u=s64.u, phi=s64.phi, zl=s64.zl, zu=s64.zu, lam=s64.lam,
        objective=s64.objective, iterations=s64.k, status=s64.status,
        converged=s64.converged, primal_inf=s64.primal_inf,
        dual_inf=s64.dual_inf, cs_inf=s64.cs_inf, mu=s64.mu)
    return (sol, s64) if return_state else sol


def solve_mixed_chunked(problem: Problem, bounds: Bounds, x1, u_init,
                        theta=None, options: Optional[Options] = None,
                        phase1_tolerance: float = 3e-4, chunk: int = 25,
                        phase1_max_iterations: Optional[int] = None,
                        phase2_max_iterations: Optional[int] = None,
                        phase2_ls_speculative: Optional[int] = None,
                        phase1_stall_window: Optional[int] = None,
                        rescue_failed=True,
                        rescue_ls_speculative: Optional[int] = None,
                        rescue_max_iterations: Optional[int] = None,
                        phase2_chunk: Optional[int] = None,
                        phase2_compact=False,
                        phase1_adapt_ls=None,
                        batched: bool = False,
                        return_info: bool = False):
    """Chunked two-phase solve: f32 bulk phase, f64 endgame, each as
    host-resumed short device programs (for runtimes that kill long
    executions). Batched variant vmaps over a leading instance axis.
    `phase1_max_iterations`: see solve_mixed. `phase2_max_iterations` caps
    each instance's f64 iterations beyond its promote point — normal
    endgames take ~6-25 f64 iterations, but an instance whose f32 phase
    FAILED (not merely hit tolerance) triggers a near-full-length f64
    rescue (hundreds of iterations) that can cost more wall than the rest
    of the batch combined; the cap bounds that.

    `phase2_compact` (batched only): lockstep lanes that already converged
    still pay for every masked f64 iteration; compaction gathers the
    still-running instances into a smaller batch at phase-2 chunk
    boundaries (`phase2_chunk`,
    default `chunk` — set it well below the phase-2 iteration cap or there
    are no boundaries to compact at). True = powers of two from half the
    batch down to 64; or pass an explicit descending size tuple.

    `rescue_failed`: what to do with instances whose f32 phase FAILED
    (stalled/capped without reaching phase-1 tolerance):
      * True — promote them anyway; the f64 endgame re-solves them in
        lockstep with the healthy batch. Correct but ruinous: one rescue
        runs hundreds of early-stage f64 iterations whose heavy line-search
        trip counts are max-over-batch.
      * False — deny them the endgame and report them failed (the
        throughput-max config).
      * "restart" — deny them the lockstep endgame, then RE-SOLVE just the
        failures from scratch in pure f64 as a separate compacted batch
        (padded to the smallest compaction rung) after the healthy endgame
        returns. A from-scratch f64 solve takes the reference's ~150 median
        iterations vs 400-515 for continuing the poisoned f32 state, and
        the compact batch never drags the healthy instances — success
        approaches the pure-f64 campaign's at a bounded wall cost. The
        rescue line search is the caller's (`rescue_ls_speculative`
        overrides its K).

    `rescue_max_iterations`: iteration cap for the restart rescue batch
    only (default `options.max_iterations`). The reference runs
    max_iter=1000 (src/options.jl:5); a throughput bench capping the
    lockstep batch at fewer iterations can still give the compacted
    rescue stragglers the full reference budget — they are the instances
    competing with the reference's 100/100.

    `phase1_adapt_ls`: ascending K-candidate tuple for per-chunk adaptive
    hybrid line search in the f32 bulk phase (see run_chunked.adapt_ls).

    `return_info`: also return a dict classifying every instance's path
    through the phases — phase-1 end {converged,status,k}, phase-2
    pre-rescue {converged,status,k,KKT errors}, and the rescue batch's
    {indices,converged,status,k} — the observability needed to attribute
    residual failures (iteration cap vs stall vs line-search failure)."""
    from .chunked import run_chunked, solve_chunked

    options = options or Options()
    f32 = jnp.float32
    cast32 = lambda a: (a.astype(f32)
                        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                        else a)
    b32 = jax.tree.map(cast32, bounds)
    th32 = jax.tree.map(cast32, theta) if theta is not None else None
    p1_max = min(options.max_iterations,
                 phase1_max_iterations or options.max_iterations)
    opts32 = options.__class__(**{
        **options.__dict__, "optimality_tolerance": phase1_tolerance,
        "max_iterations": p1_max})

    _, s32 = solve_chunked(problem, b32, jax.tree.map(cast32, x1),
                           jax.tree.map(cast32, u_init), theta=th32,
                           options=opts32, chunk=chunk, batched=batched,
                           return_state=True,
                           stall_window=phase1_stall_window,
                           adapt_ls=phase1_adapt_ls)
    info = {"p1": _phase_snapshot(s32)} if return_info else None

    cast64 = lambda a: (a.astype(jnp.float64)
                        if jnp.issubdtype(jnp.asarray(a).dtype,
                                          jnp.floating) else a)
    b64 = jax.tree.map(cast64, bounds)
    th64 = jax.tree.map(cast64, theta) if theta is not None else None
    opts64 = options
    if phase2_ls_speculative is not None:
        opts64 = opts64.__class__(**{
            **opts64.__dict__,
            "ls_speculative": phase2_ls_speculative})
    if batched:
        s64 = jax.vmap(
            lambda st, bb, tt: promote_state(problem, bb, st, tt, opts64),
            in_axes=(0, Bounds(0, 0), None if theta is None else 0))(
            s32, b64, th64)
    else:
        s64 = promote_state(problem, b64, s32, th64, opts64)
    import numpy as np
    total2 = None
    if phase2_max_iterations is not None:
        total2 = np.minimum(np.asarray(options.max_iterations),
                            np.asarray(s64.k) + phase2_max_iterations)
    if rescue_failed is not True:
        # Deny the f64 endgame to instances whose f32 phase FAILED (did not
        # reach phase-1 tolerance): a rescue is a near-full-length f64
        # re-solve, and under lockstep vmap ONE early-stage instance drags
        # every batch iteration to early-iteration cost (heavy line-search
        # trip counts are max-over-batch). Throughput-optimal serving lets
        # them fail; route retries to a fresh f64 batch instead.
        healthy = np.asarray(s32.converged)
        base = (np.asarray(options.max_iterations) if total2 is None
                else total2)
        total2 = np.where(healthy, base, np.asarray(s64.k))
        # keep the f32 failure status on denied instances (promote_state
        # resets status to 0, which would report them "optimal")
        s64 = s64._replace(status=jnp.where(
            jnp.asarray(healthy), s64.status, s32.status))
    compact = None
    if phase2_compact and batched:
        B = int(np.shape(s64.k)[0])
        if phase2_compact is True:
            sizes, s = [], 1
            while s < B:
                if s >= 64:
                    sizes.append(s)
                s *= 2
            compact = tuple(reversed(sizes)) or None
        else:
            compact = tuple(phase2_compact)
    s64 = run_chunked(problem, b64, s64, th64, opts64,
                      chunk=phase2_chunk or chunk,
                      batched=batched, total=total2,
                      compact_sizes=compact)
    if return_info:
        info["p2"] = _phase_snapshot(s64)
        info["rescue"] = None

    if rescue_failed == "restart" and batched:
        failed = np.where(~np.asarray(s64.converged))[0]
        if failed.size:
            from .chunked import _gather_tree, _scatter_tree
            rungs = compact or (64,)
            target = next((s for s in reversed(rungs) if failed.size <= s),
                          int(np.shape(s64.k)[0]))
            # pad lanes duplicate failed instances (identical work profile
            # under lockstep; only the real lanes are scattered back)
            idx = np.concatenate([failed, failed[
                np.arange(target - failed.size) % failed.size]])
            jidx = jnp.asarray(idx)
            # the caller's phase-1 line search unless overridden (the
            # rescue exists for success, not throughput)
            opts_r = options.__class__(**{
                **options.__dict__,
                "ls_speculative": (rescue_ls_speculative
                                   if rescue_ls_speculative is not None
                                   else options.ls_speculative),
                "max_iterations": (rescue_max_iterations
                                   if rescue_max_iterations is not None
                                   else options.max_iterations)})
            sub_b = _gather_tree(b64, jidx)
            sub_th = None if theta is None else _gather_tree(th64, jidx)
            _, s_r = solve_chunked(
                problem, sub_b,
                _gather_tree(jax.tree.map(cast64, jnp.asarray(x1)), jidx),
                _gather_tree(jax.tree.map(cast64, jnp.asarray(u_init)),
                             jidx),
                theta=sub_th, options=opts_r,
                chunk=phase2_chunk or chunk, batched=True,
                return_state=True,
                compact_sizes=tuple(s for s in rungs if s < target) or None)
            keep = jnp.asarray(idx[:failed.size])
            s64 = _scatter_tree(s64, keep,
                                _gather_tree(s_r, jnp.arange(failed.size)))
            if return_info:
                info["rescue"] = {"indices": failed,
                                  **_phase_snapshot(
                                      _gather_tree(
                                          s_r, jnp.arange(failed.size)))}

    sol = Solution(
        x=s64.x, u=s64.u, phi=s64.phi, zl=s64.zl, zu=s64.zu, lam=s64.lam,
        objective=s64.objective, iterations=s64.k, status=s64.status,
        converged=s64.converged, primal_inf=s64.primal_inf,
        dual_inf=s64.dual_inf, cs_inf=s64.cs_inf, mu=s64.mu)
    return (sol, info) if return_info else sol


def _phase_snapshot(state) -> dict:
    """Host copies of the per-instance fields needed to attribute failures."""
    import numpy as np

    out = {f: np.asarray(getattr(state, f))
           for f in ("converged", "status", "k",
                     "primal_inf", "dual_inf", "cs_inf", "mu")}
    return out
