"""Outer loop: Fiacco-McCormick barrier iteration with filter globalization.

Functional re-design of the reference driver (reference: src/solve.jl:1-199):
one `lax.while_loop` over a fully-traced iteration

    derivatives -> backward pass -> KKT error norms -> {converged | barrier
    update (skip forward) | forward pass + nominal update + filter update}

carrying a single `SolverState` pytree. Because every field is a static-shape
array, the whole solve `jax.jit`s once and `jax.vmap`s over problem instances
— converged instances simply stop updating their slice of the carry (the
batched while_loop masks them), which is the per-instance "status code"
failure model of SURVEY.md §5.

Error norms follow the reference exactly, including the IPOPT s_max scaling
and its quirk of counting only a single stage's equality-constraint dimension
in the dual-error scaling denominator (reference: src/solve.jl:130,145).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .backward import backward_pass, costate_scan
from .derivatives import (DerivativeBundle, contract_dynamics_hessian,
                          evaluate_constraints, evaluate_derivatives,
                          relax_constraints)
from .forward import (Trial, barrier_lagrangian, forward_pass,
                      forward_pass_hybrid, forward_pass_speculative)
from .options import Options
from .problem import Bounds, Problem

Array = jax.Array


class SolverState(NamedTuple):
    """Everything carried across outer iterations (the nominal iterate plus
    scalar bookkeeping — the functional analog of the reference's
    ProblemData nominal_* + SolverData, reference: src/data/problem.jl:1-37,
    src/data/solver.jl:8-33)."""

    # nominal trajectories
    x: Array        # [T+1, nx]
    u: Array        # [T, nu]
    c_raw: Array    # [T, nc] un-relaxed constraints at the nominal iterate
    il: Array       # [T, nu]
    iu: Array       # [T, nu]
    phi: Array      # [T, nc]
    zl: Array       # [T, nu]
    zu: Array       # [T, nu]
    lam: Array      # [T+1, nx]
    # barrier / regularization
    mu: Array
    reg_last: Array
    # performance measures of the accepted iterate
    objective: Array
    theta_curr: Array       # constraint violation 1-norm (primal_1_curr)
    L_curr: Array           # barrier Lagrangian (barrier_lagrangian_curr)
    max_primal_1: Array
    min_primal_1: Array
    # KKT errors (of the last evaluated iterate)
    primal_inf: Array
    dual_inf: Array
    cs_inf: Array
    # filter (fixed-capacity ring: empty slots +inf)
    filter_pts: Array       # [CAP, 2]
    filter_n: Array
    # counters and flags
    k: Array                # overall iteration counter (accepted steps)
    j: Array                # outer/barrier iteration counter
    ls_resets: Array        # filter resets consumed after LS failures
    num_ls: Array           # last line-search trial count
    step_size: Array
    status: Array
    converged: Array


class Solution(NamedTuple):
    x: Array
    u: Array
    phi: Array
    zl: Array
    zu: Array
    lam: Array
    objective: Array
    iterations: Array
    status: Array
    converged: Array
    primal_inf: Array
    dual_inf: Array
    cs_inf: Array
    mu: Array


def full_precision(fn):
    """Trace `fn` with every matrix product at HIGHEST precision.

    On a GPU an f32 `dot_general` at default precision may run in TF32,
    which keeps about three decimal digits, far short of the f32 phase's
    3e-4 KKT target. Every traced entry of the solver (`initialize`, `run`,
    `iteration`, `mixed.promote_state`) carries this, so any caller of
    `solve`, `solve_batch`, the chunked and mixed drivers or the sharded
    solve gets full f32 products, including those in the user's model
    functions. f64 products and CPU results are unchanged."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def _nominal_trial(s: SolverState) -> Trial:
    return Trial(x=s.x, u=s.u, c_raw=s.c_raw, il=s.il, iu=s.iu,
                 phi=s.phi, zl=s.zl, zu=s.zu)


def _reset_filter(filter_pts: Array, max_primal_1) -> Array:
    """Filter <- {(theta_max, -inf)} (reference: src/solve.jl:101-105)."""
    cap = filter_pts.shape[0]
    dtype = filter_pts.dtype
    # +0*max_primal_1 ties the constant +inf slots to the (possibly
    # shard_map-varying) state so the array's VMA matches loop carries.
    pts = jnp.full((cap, 2), jnp.inf, dtype=dtype) + max_primal_1 * 0
    pts = pts.at[0, 0].set(max_primal_1)
    return pts.at[0, 1].set(-jnp.inf)


def _augment_filter(filter_pts, filter_n, theta_curr, L_curr,
                    options: Options):
    """Filter <- Filter + {((1-g_t) theta, L - g_L theta)}
    (reference: src/solve.jl:95-99).

    On ring overflow the occupied slot is merged by componentwise min — a
    conservative envelope that blocks a superset of what the evicted point
    blocked, so saturation never re-admits previously dominated iterates
    (the reference's push! list is unbounded). Empty slots hold +inf, so
    below capacity the min is an exact insert."""
    cap = filter_pts.shape[0]
    # slots 1..cap-1 form the ring; slot 0 holds the theta_max sentinel
    idx = 1 + jnp.mod(filter_n - 1, cap - 1)
    pt = jnp.stack([(1.0 - options.gamma_theta) * theta_curr,
                    L_curr - options.gamma_L * theta_curr])
    return filter_pts.at[idx].min(pt), filter_n + 1


def resolve_options(options: Options, problem: Problem) -> Options:
    """Resolve problem-dependent "auto" knobs to concrete values.

    `inertia_method="auto"` -> "bk" (reference-faithful rook Bunch-Kaufman,
    reference: src/inertia_correction.jl:261) on problems with mu-relaxed
    complementarity rows (contact problems: measured to restore exact
    acrobot golden parity and reference-level pushing success), else "ldl"
    (the fast pivoted-LDLT path the Pallas megakernels implement). Called by
    every solve entry point; idempotent and cheap (frozen-dataclass replace
    hashes identically across calls, so no recompile churn)."""
    import dataclasses

    if options.inertia_method != "auto":
        return options
    is_contact = bool(problem.compl_indices) or problem.contact
    return dataclasses.replace(
        options, inertia_method="bk" if is_contact else "ldl")


@full_precision
def initialize(problem: Problem, theta, bounds: Bounds, x1, u_init,
               options: Options) -> SolverState:
    """Interior projection of the control guess, nominal rollout, dual init
    (reference: src/solver.jl:54-105, src/solve.jl:14-36)."""
    options = resolve_options(options, problem)
    T, nu = problem.T, problem.nu
    lo, hi = bounds.lower, bounds.upper
    ml, mu_mask = bounds.mask_lower, bounds.mask_upper
    dtype = u_init.dtype
    k1, k2 = options.kappa_1, options.kappa_2

    # two-sided interior projection (reference: src/solver.jl:85-92)
    span = hi - lo
    lo_proj = lo + jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(lo)), k2 * span)
    hi_proj = hi - jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(hi)), k2 * span)
    u_two = jnp.minimum(jnp.maximum(u_init, lo_proj), hi_proj)
    # one-sided projections (reference: src/solver.jl:71-84; the upper-only
    # branch there is buggy — we implement the clear intent, mirrored)
    u_lo = jnp.maximum(u_init, lo + k1 * jnp.maximum(lo, 1.0))
    u_hi = jnp.minimum(u_init, hi - k1 * jnp.maximum(hi, 1.0))

    u = jnp.where(ml & mu_mask, u_two,
                  jnp.where(ml, u_lo, jnp.where(mu_mask, u_hi, u_init)))

    def step(x_t, xs):
        t, u_t = xs
        x_next = problem.dynamics(x_t, u_t, t, theta)
        return x_next, x_t
    x_T, x_stk = jax.lax.scan(step, x1, (jnp.arange(T), u))
    x = jnp.concatenate([x_stk, x_T[None]], axis=0)

    # Every state field is tied to the instance inputs via this zero so its
    # varying-manual-axes under shard_map match the loop-body outputs
    # (literal-constant inits are "unvarying" and trip the while/scan carry
    # VMA check); outside shard_map this is a no-op zero.
    seed = x1[0] * jnp.zeros((), dtype)
    iseed = seed.astype(jnp.int32)

    il = u - lo
    iu = hi - u
    phi = jnp.zeros((T, problem.nc), dtype) + seed
    zl = jnp.where(ml, 1.0, 0.0).astype(dtype) + seed
    zu = jnp.where(mu_mask, 1.0, 0.0).astype(dtype) + seed
    lam = jnp.zeros((T + 1, problem.nx), dtype) + seed

    mu = jnp.asarray(options.mu_init, dtype) + seed
    c_raw = evaluate_constraints(problem, theta, x, u)
    c_rel = relax_constraints(problem, c_raw, mu)
    theta_curr = jnp.sum(jnp.abs(c_rel))
    L_curr, J = barrier_lagrangian(problem, theta, bounds, x, u, c_rel,
                                   phi, il, iu, mu)

    max_primal_1 = 1e4 * jnp.maximum(1.0, theta_curr)
    min_primal_1 = 1e-4 * jnp.maximum(1.0, theta_curr)
    filter_pts = _reset_filter(
        jnp.zeros((options.filter_capacity, 2), dtype), max_primal_1)

    zero = seed
    return SolverState(
        x=x, u=u, c_raw=c_raw, il=il, iu=iu, phi=phi, zl=zl, zu=zu, lam=lam,
        mu=mu, reg_last=zero,
        objective=J, theta_curr=theta_curr, L_curr=L_curr,
        max_primal_1=max_primal_1, min_primal_1=min_primal_1,
        primal_inf=zero, dual_inf=zero, cs_inf=zero,
        filter_pts=filter_pts, filter_n=jnp.int32(1) + iseed,
        k=iseed, j=iseed, ls_resets=iseed,
        num_ls=iseed,
        step_size=zero, status=iseed,
        converged=seed > zero,
    )


def dual_error(problem: Problem, deriv: DerivativeBundle, bounds: Bounds,
               phi, zl, zu, lam, options: Options):
    """Stationarity in u with IPOPT s_max scaling (reference:
    src/solve.jl:117-147)."""
    r = (deriv.lu
         + jnp.einsum("tcu,tc->tu", deriv.cu, phi)
         - zl + zu
         + jnp.einsum("txu,tx->tu", deriv.fu, lam[1:]))
    dual_inf = jnp.max(jnp.abs(r)) if r.size else jnp.zeros((), zl.dtype)
    z_norm = jnp.sum(zl) + jnp.sum(zu)
    phi_norm = jnp.sum(jnp.abs(phi))
    num_ineq = bounds.num_bounds
    # Reference quirk mirrored: the equality-count term uses a single stage's
    # constraint dimension, not the total (reference: src/solve.jl:130).
    num_constr = problem.nc
    scaling = jnp.maximum(
        options.s_max,
        (phi_norm + z_norm) / jnp.maximum(num_ineq + num_constr, 1.0),
    ) / options.s_max
    return dual_inf / scaling


def cs_error(bounds: Bounds, il, iu, zl, zu, mu, options: Options):
    """Complementary-slackness error |il.zl - mu|, |iu.zu - mu| over finite
    bounds, s_max-scaled (reference: src/solve.jl:149-180)."""
    ml, mu_mask = bounds.mask_lower, bounds.mask_upper
    rl = jnp.where(ml, jnp.where(ml, il, 0.0) * zl - mu, 0.0)
    ru = jnp.where(mu_mask, jnp.where(mu_mask, iu, 0.0) * zu - mu, 0.0)
    cs = jnp.maximum(jnp.max(jnp.abs(rl), initial=0.0),
                     jnp.max(jnp.abs(ru), initial=0.0))
    z_norm = jnp.sum(zl) + jnp.sum(zu)
    num_ineq = bounds.num_bounds
    scaling = jnp.maximum(
        options.s_max, z_norm / jnp.maximum(num_ineq, 1.0)) / options.s_max
    return cs / scaling


def solve(problem: Problem, bounds: Bounds, x1, u_init,
          theta=None, options: Optional[Options] = None,
          return_state: bool = False):
    """Solve the OCP. Fully jittable / vmappable.

    Equivalent entry point to the reference `solve!(solver, x1, u_init)`
    (reference: src/solve.jl:1-93).
    """
    options = options or Options()
    state = initialize(problem, theta, bounds, x1, u_init, options)
    state = run(problem, bounds, state, theta, options)
    sol = Solution(
        x=state.x, u=state.u, phi=state.phi, zl=state.zl, zu=state.zu,
        lam=state.lam, objective=state.objective, iterations=state.k,
        status=state.status, converged=state.converged,
        primal_inf=state.primal_inf, dual_inf=state.dual_inf,
        cs_inf=state.cs_inf, mu=state.mu)
    return (sol, state) if return_state else sol


@full_precision
def iteration(problem: Problem, bounds: Bounds, s: SolverState, theta,
              options: Options) -> SolverState:
    """One outer iteration: derivatives -> backward -> errors -> {converged |
    barrier update | forward + accept}. Pure function of the state; the unit
    the driver compile-checks and the building block of `run`."""
    options = resolve_options(options, problem)
    tol = options.optimality_tolerance
    num_bounds = bounds.num_bounds
    return _body(problem, bounds, theta, options, tol, num_bounds, s)


@full_precision
def run(problem: Problem, bounds: Bounds, state: SolverState, theta,
        options: Options, k_limit=None) -> SolverState:
    """The main iteration loop on an initialized state.

    `k_limit` (runtime scalar, default options.max_iterations) bounds the
    iteration counter for this call — the chunked-execution hook: resuming
    `run` on the returned state with a higher limit continues the identical
    trajectory."""
    options = resolve_options(options, problem)
    tol = options.optimality_tolerance
    num_bounds = bounds.num_bounds
    if k_limit is None:
        k_limit = options.max_iterations
    k_limit = jnp.minimum(jnp.asarray(k_limit, jnp.int32),
                          options.max_iterations)

    def cond(s: SolverState):
        return ((s.k < k_limit)
                & (s.status == 0) & (~s.converged))

    def body(s: SolverState):
        return _body(problem, bounds, theta, options, tol, num_bounds, s)

    state = jax.lax.while_loop(cond, body, state)
    state = state._replace(status=jnp.where(
        (~state.converged) & (state.status == 0)
        & (state.k >= k_limit),
        jnp.int32(8), state.status))
    return state


def _body(problem: Problem, bounds: Bounds, theta, options: Options,
          tol, num_bounds, s: SolverState) -> SolverState:
    deriv = evaluate_derivatives(
        problem, theta, s.x, s.u, s.phi,
        quasi_newton=options.quasi_newton)
    c_rel = relax_constraints(problem, s.c_raw, s.mu)
    nominal = (c_rel, s.il, s.iu, s.phi, s.zl, s.zu)
    # costate first (affine associative scan), then pre-contract the dynamics
    # Hessians vectorized over T — the backward sweep never materializes the
    # full [T, nx, nz, nz] tensor. These stages are per-stage parallel work
    # XLA fuses across T x B; only the T-sequential backward sweep has a
    # kernel.
    lam = costate_scan(deriv, s.phi)
    if options.quasi_newton:
        second = None
    else:
        second = deriv.cH_phi + contract_dynamics_hessian(
            problem, theta, s.x, s.u, lam[1:])
    if options.backward_mode in ("parallel", "timeshard"):
        from .parallel.priccati import backward_pass_parallel
        vscan = None
        if options.backward_mode == "timeshard":
            from functools import partial

            from .parallel import timeshard
            mesh, ax = timeshard.active_time_mesh()
            vscan = partial(timeshard.value_scan_timesharded,
                            mesh=mesh, axis=ax)
        bw = backward_pass_parallel(problem, deriv, nominal, s.mu,
                                    s.reg_last, options, lam=lam,
                                    second=second, value_scan=vscan)
    else:
        bw = backward_pass(problem, deriv, nominal, s.mu, s.reg_last,
                           options, lam=lam, second=second)
    s = s._replace(lam=bw.lam, reg_last=bw.reg)

    d_inf = dual_error(problem, deriv, bounds,
                       s.phi, s.zl, s.zu, s.lam, options)
    p_inf = (jnp.max(jnp.abs(c_rel)) if c_rel.size
             else jnp.zeros((), s.mu.dtype))
    cs0 = cs_error(bounds, s.il, s.iu, s.zl, s.zu, 0.0, options)
    cs_mu = cs_error(bounds, s.il, s.iu, s.zl, s.zu, s.mu, options)
    opt_err_0 = jnp.maximum(jnp.maximum(d_inf, cs0), p_inf)
    opt_err_mu = jnp.maximum(jnp.maximum(d_inf, cs_mu), p_inf)
    s = s._replace(primal_inf=p_inf, dual_inf=d_inf, cs_inf=cs0)

    converged = opt_err_0 < tol
    backward_failed = bw.status != 0
    barrier_branch = ((opt_err_mu <= options.kappa_eps * s.mu)
                      & (num_bounds > 0) & (s.mu > tol / 10.0))

    # Branching is compute-both-and-select rather than `lax.cond`: under
    # `vmap` (every batched solve) a batched-predicate cond executes both
    # branches anyway, so this costs nothing there, keeps the rare
    # per-instance path only marginally heavier (the barrier branch fires on
    # ~5% of iterations), and sidesteps a JAX shard_map bug where
    # vmap-of-cond branches closing over array constants fail the VMA check
    # ("pvary is a invariant->variant collective").
    def select_state(pred, a: SolverState, b: SolverState) -> SolverState:
        return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)

    def do_barrier(s: SolverState):
        # mu <- max(tol/10, min(kappa_mu mu, mu^theta_mu)); reset filter;
        # refresh merit measures; skip the forward pass
        # (reference: src/solve.jl:61-73).
        mu_new = jnp.maximum(tol / 10.0,
                             jnp.minimum(options.kappa_mu * s.mu,
                                         s.mu ** options.theta_mu))
        c_rel_new = relax_constraints(problem, s.c_raw, mu_new)
        L_new, J = barrier_lagrangian(
            problem, theta, bounds, s.x, s.u, c_rel_new,
            s.phi, s.il, s.iu, mu_new)
        theta_new = jnp.sum(jnp.abs(c_rel_new))
        return s._replace(
            mu=mu_new,
            filter_pts=_reset_filter(s.filter_pts, s.max_primal_1),
            filter_n=s.filter_n * 0 + 1,
            L_curr=L_new, theta_curr=theta_new, objective=J,
            j=s.j + 1)

    def do_forward(s: SolverState):
        if options.ls_speculative > 0:
            fw_fn = (forward_pass_hybrid if options.ls_spec_continue
                     else forward_pass_speculative)
        else:
            fw_fn = forward_pass
        fw = fw_fn(
            problem, theta, bounds, bw.gains, _nominal_trial(s),
            bw.dL, s.mu, s.theta_curr, s.L_curr, s.min_primal_1,
            s.filter_pts, options)

        def accept(s: SolverState):
            t = fw.trial
            aug = (~fw.armijo_passed) & (~fw.switching)
            fpts_aug, fn_aug = _augment_filter(
                s.filter_pts, s.filter_n, s.theta_curr, s.L_curr, options)
            fpts = jnp.where(aug, fpts_aug, s.filter_pts)
            fn = jnp.where(aug, fn_aug, s.filter_n)
            return s._replace(
                x=t.x, u=t.u, c_raw=t.c_raw, il=t.il, iu=t.iu,
                phi=t.phi, zl=t.zl, zu=t.zu,
                objective=fw.objective,
                L_curr=fw.L_next, theta_curr=fw.theta_next,
                filter_pts=fpts, filter_n=fn,
                k=s.k + 1, num_ls=fw.num_ls, step_size=fw.step_size)

        def reject(s: SolverState):
            if options.ls_failure_resets > 0:
                # robustness extension: a saturated filter can block every
                # step near convergence (observed on degenerate contact
                # switching stages); resetting it and retrying is bounded by
                # ls_failure_resets and changes nothing when the filter was
                # not the blocker (the retry fails again and consumes budget)
                can_reset = s.ls_resets < options.ls_failure_resets
                return select_state(
                    can_reset,
                    s._replace(
                        filter_pts=_reset_filter(s.filter_pts,
                                                 s.max_primal_1),
                        filter_n=s.filter_n * 0 + 1,
                        ls_resets=s.ls_resets + 1),
                    s._replace(status=fw.status))
            return s._replace(status=fw.status)

        return select_state(fw.status == 0, accept(s), reject(s))

    s_active = select_state(barrier_branch, do_barrier(s), do_forward(s))
    s = select_state(
        backward_failed,
        s._replace(status=s.status * 0 + 1),
        select_state(converged,
                     s._replace(converged=s.converged | True),
                     s_active))
    if options.verbose:
        from .utils.printing import iteration_logger
        iteration_logger(s, options)
    return s
