"""Forward pass: feedback rollout + fraction-to-boundary + filter line search.

Functional re-design of the reference forward pass (reference:
src/forward_pass.jl:1-153). The rollout is a `lax.scan` over time applying the
affine update rule from the backward pass

    u  = u_bar  + gamma*alpha + beta  (x - x_bar)
    phi= phi_bar+ gamma*psi   + omega (x - x_bar)
    zl = zl_bar + gamma*chi_l + zeta_l(x - x_bar)
    zu = zu_bar + gamma*chi_u + zeta_u(x - x_bar)
    x' = f(x, u)

(reference: src/forward_pass.jl:117-150); the backtracking gamma <- gamma/2
line search is a `lax.while_loop` applying, in order, the same acceptance
gauntlet as the reference:

  1. finiteness of the rollout (the functional analog of catching DomainError,
     reference: src/forward_pass.jl:18-24),
  2. fraction-to-boundary on (il, iu, zl, zu) vs tau = max(tau_min, 1 - mu)
     (reference: src/forward_pass.jl:26-27,59-85),
  3. filter acceptability on (theta, L) (reference: src/forward_pass.jl:36-37),
  4. switching + Armijo, else sufficient-progress (reference:
     src/forward_pass.jl:40-49).

The filter is a fixed-capacity ring buffer of (theta_f, L_f) pairs — empty
slots hold +inf so they can never block — replacing the reference's unbounded
`push!` list (reference: src/solve.jl:95-105), a deliberate static-shape
redesign for XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .backward import Gains
from .derivatives import (evaluate_constraints, evaluate_objective,
                          relax_constraints)
from .options import Options
from .problem import Bounds, Problem

Array = jax.Array


class Trial(NamedTuple):
    """A candidate iterate produced by one rollout."""

    x: Array       # [T+1, nx]
    u: Array       # [T, nu]
    c_raw: Array   # [T, nc] un-relaxed constraint values
    il: Array      # [T, nu]
    iu: Array      # [T, nu]
    phi: Array     # [T, nc]
    zl: Array      # [T, nu]
    zu: Array      # [T, nu]


class ForwardResult(NamedTuple):
    trial: Trial
    theta_next: Array    # constraint violation 1-norm of accepted iterate
    L_next: Array        # barrier Lagrangian of accepted iterate
    objective: Array     # objective of accepted iterate
    step_size: Array
    num_ls: Array        # line-search iteration counter (reference: data.l)
    status: Array        # 0 accepted, 7 line search failed
    armijo_passed: Array
    switching: Array


def rollout(problem: Problem, theta, bounds: Bounds, gains: Gains,
            nominal_x, nominal_u, nominal_phi, nominal_zl, nominal_zu,
            gamma) -> Trial:
    """Closed-loop rollout of the affine update rule at step size gamma."""
    T = problem.T

    def step(x_t, xs):
        (t, xbar, ubar, phibar, zlbar, zubar,
         a, b, p, w, cl, el, cu_, eu, lo, hi) = xs
        dx = x_t - xbar
        u_t = ubar + gamma * a + b @ dx
        phi_t = phibar + gamma * p + w @ dx
        zl_t = zlbar + gamma * cl + el @ dx
        zu_t = zubar + gamma * cu_ + eu @ dx
        x_next = problem.dynamics(x_t, u_t, t, theta)
        il_t = u_t - lo
        iu_t = hi - u_t
        return x_next, (x_t, u_t, phi_t, zl_t, zu_t, il_t, iu_t)

    xs = (jnp.arange(T), nominal_x[:T], nominal_u,
          nominal_phi, nominal_zl, nominal_zu,
          gains.alpha, gains.beta, gains.psi, gains.omega,
          gains.chi_l, gains.zeta_l, gains.chi_u, gains.zeta_u,
          bounds.lower, bounds.upper)
    x_T, (x_stk, u, phi, zl, zu, il, iu) = jax.lax.scan(
        step, nominal_x[0], xs
    )
    x = jnp.concatenate([x_stk, x_T[None]], axis=0)
    c_raw = evaluate_constraints(problem, theta, x, u)
    return Trial(x=x, u=u, c_raw=c_raw, il=il, iu=iu, phi=phi, zl=zl, zu=zu)


def fraction_to_boundary_ok(trial: Trial, nominal_il, nominal_iu,
                            nominal_zl, nominal_zu, tau) -> Array:
    """Elementwise check (1 - tau) * nominal <= current on il, iu, zl, zu
    (reference: src/forward_pass.jl:59-85). Entries at infinite bounds hold
    +inf (slacks) or 0 (duals) on both sides and pass vacuously."""
    s = 1.0 - tau

    def ok(nom, cur):
        return ~jnp.any(s * nom > cur)

    return (ok(nominal_il, trial.il) & ok(nominal_iu, trial.iu)
            & ok(nominal_zl, trial.zl) & ok(nominal_zu, trial.zu))


def barrier_lagrangian(problem: Problem, theta, bounds: Bounds,
                       trial_x, trial_u, c_rel, phi, il, iu, mu):
    """L = J + sum <c, phi> - mu * (sum log il + sum log iu) over finite bounds
    (reference: src/data/methods.jl:34-67). Returns (L, J)."""
    J = evaluate_objective(problem, theta, trial_x, trial_u)
    ml = bounds.mask_lower
    mu_mask = bounds.mask_upper
    log_l = jnp.sum(jnp.where(ml, jnp.log(jnp.where(ml, il, 1.0)), 0.0))
    log_u = jnp.sum(jnp.where(mu_mask, jnp.log(jnp.where(mu_mask, iu, 1.0)), 0.0))
    L = J + jnp.sum(c_rel * phi) - mu * (log_l + log_u)
    return L, J


def filter_blocks(filter_pts: Array, theta, L) -> Array:
    """True if (theta, L) is dominated by any filter point
    (reference: src/forward_pass.jl:36). filter_pts: [CAP, 2], empty slots +inf."""
    return jnp.any((theta >= filter_pts[:, 0]) & (L >= filter_pts[:, 1]))


def forward_pass(problem: Problem, theta, bounds: Bounds, gains: Gains,
                 nominal: Trial, dL, mu, theta_prev, L_prev,
                 min_primal_1, filter_pts, options: Options,
                 gamma0=None, skip=None, num_ls0=None) -> ForwardResult:
    """Backtracking line search (reference: src/forward_pass.jl:1-57).

    `gamma0`/`skip`/`num_ls0` support the hybrid continuation
    (`forward_pass_hybrid`): start backtracking at `gamma0` instead of 1,
    run zero trials where `skip` is True (the speculative pre-pass already
    accepted), and seed the trial counter."""
    dtype = nominal.u.dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    min_step = jnp.maximum(eps, jnp.asarray(options.ls_min_step, dtype))
    tau = jnp.maximum(options.tau_min, 1.0 - mu)

    def try_step(gamma):
        trial = rollout(problem, theta, bounds, gains, nominal.x, nominal.u,
                        nominal.phi, nominal.zl, nominal.zu, gamma)
        finite = (jnp.all(jnp.isfinite(trial.x))
                  & jnp.all(jnp.isfinite(trial.u))
                  & jnp.all(jnp.isfinite(trial.phi))
                  & jnp.all(jnp.isfinite(trial.zl))
                  & jnp.all(jnp.isfinite(trial.zu))
                  & jnp.all(jnp.isfinite(trial.c_raw)))
        frac_ok = fraction_to_boundary_ok(
            trial, nominal.il, nominal.iu, nominal.zl, nominal.zu, tau)

        c_rel = relax_constraints(problem, trial.c_raw, mu)
        th = jnp.sum(jnp.abs(c_rel))
        L, J = barrier_lagrangian(problem, theta, bounds,
                                  trial.x, trial.u, c_rel,
                                  trial.phi, trial.il, trial.iu, mu)

        # Step acceptance (reference: src/forward_pass.jl:36-49).
        blocked = filter_blocks(filter_pts, th, L)
        switching = (dL < 0.0) & (
            jnp.maximum(-gamma * dL, 0.0) ** options.s_L
            * gamma ** (1.0 - options.s_L)
            > options.delta * theta_prev ** options.s_theta
        )
        armijo = (L - L_prev - 10.0 * eps * jnp.abs(L_prev)
                  <= options.eta_L * gamma * dL)
        suff = ((th <= (1.0 - options.gamma_theta) * theta_prev)
                | (L <= L_prev - options.gamma_L * theta_prev))
        use_armijo = (th <= min_primal_1) & switching
        decrease_ok = jnp.where(use_armijo, armijo, suff)

        accept = finite & frac_ok & ~blocked & decrease_ok
        # Transient status codes for observability (reference numbering).
        status = jnp.where(
            ~finite | ~frac_ok, jnp.int32(2),
            jnp.where(blocked, jnp.int32(3),
                      jnp.where(use_armijo, jnp.int32(4), jnp.int32(5))))
        # The reference increments the line-search counter only on
        # filter/acceptance failures, not rollout or boundary failures
        # (reference: src/forward_pass.jl:37,49).
        counted = finite & frac_ok & ~accept
        return trial, th, L, J, accept, status, counted, armijo, switching

    do_skip = (jnp.zeros((), jnp.bool_) if skip is None
               else jnp.asarray(skip))

    def cond(carry):
        gamma, done = carry[0], carry[1]
        return ~do_skip & ~done & (gamma >= min_step)

    def body(carry):
        gamma, done, _, num_ls, *_ = carry
        trial, th, L, J, accept, status, counted, armijo, switching = \
            try_step(gamma)
        num_ls = num_ls + jnp.where(counted, 1, 0)
        new_gamma = jnp.where(accept, gamma, gamma * 0.5)
        return (new_gamma, accept, status, num_ls,
                trial, th, L, J, armijo, switching)

    # Carry inits derived from the traced inputs (not literal constants) so
    # their varying-manual-axes match the body outputs under shard_map.
    zeros_trial = jax.tree.map(lambda a: a * jnp.zeros((), a.dtype), nominal)
    zero = mu * jnp.zeros((), dtype)
    vfalse = zero > jnp.zeros((), dtype)
    izero = zero.astype(jnp.int32)
    g0 = (jnp.ones((), dtype) if gamma0 is None
          else jnp.asarray(gamma0, dtype))
    n0 = izero if num_ls0 is None else jnp.asarray(num_ls0, jnp.int32)
    carry0 = (g0 + zero, vfalse, izero,
              n0, zeros_trial, zero, zero, zero,
              vfalse, vfalse)
    (gamma, done, _, num_ls, trial, th, L, J, armijo, switching) = \
        jax.lax.while_loop(cond, body, carry0)

    status = jnp.where(done, jnp.int32(0), jnp.int32(7))
    return ForwardResult(trial=trial, theta_next=th, L_next=L, objective=J,
                         step_size=gamma, num_ls=num_ls, status=status,
                         armijo_passed=armijo, switching=switching)


def forward_pass_speculative(problem: Problem, theta, bounds: Bounds,
                                  gains: Gains, nominal: Trial, dL, mu,
                                  theta_prev, L_prev, min_primal_1,
                                  filter_pts,
                                  options: Options) -> ForwardResult:
    """Speculative line search: evaluate all step sizes gamma = 2^-i,
    i < ls_speculative, in ONE batched rollout and select the largest
    acceptable one.

    Accelerator-first redesign of the backtracking loop (SURVEY.md §7
    "hard parts" #3): instead of a data-dependent `while_loop` whose trip count diverges
    across vmapped instances, all candidates evaluate in lockstep as an extra
    vectorization axis — trading bounded extra FLOPs (the rollout is the cheap
    pass) for uniform, compile-friendly control flow. Acceptance semantics per
    candidate are identical to `forward_pass`; if no candidate passes, the
    step fails with status 7 (the reference would continue halving to machine
    eps, where progress is already negligible — by then gamma < 2^-K).
    """
    K = options.ls_speculative
    dtype = nominal.u.dtype
    tau = jnp.maximum(options.tau_min, 1.0 - mu)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    gammas = 0.5 ** jnp.arange(K, dtype=dtype)        # descending

    def try_step(gamma):
        trial = rollout(problem, theta, bounds, gains,
                        nominal.x, nominal.u, nominal.phi,
                        nominal.zl, nominal.zu, gamma)
        finite = (jnp.all(jnp.isfinite(trial.x))
                  & jnp.all(jnp.isfinite(trial.u))
                  & jnp.all(jnp.isfinite(trial.phi))
                  & jnp.all(jnp.isfinite(trial.zl))
                  & jnp.all(jnp.isfinite(trial.zu))
                  & jnp.all(jnp.isfinite(trial.c_raw)))
        frac_ok = fraction_to_boundary_ok(
            trial, nominal.il, nominal.iu, nominal.zl, nominal.zu, tau)
        c_rel = relax_constraints(problem, trial.c_raw, mu)
        th = jnp.sum(jnp.abs(c_rel))
        L, J = barrier_lagrangian(problem, theta, bounds,
                                  trial.x, trial.u, c_rel,
                                  trial.phi, trial.il, trial.iu, mu)
        blocked = filter_blocks(filter_pts, th, L)
        switching = (dL < 0.0) & (
            jnp.maximum(-gamma * dL, 0.0) ** options.s_L
            * gamma ** (1.0 - options.s_L)
            > options.delta * theta_prev ** options.s_theta)
        armijo = (L - L_prev - 10.0 * eps * jnp.abs(L_prev)
                  <= options.eta_L * gamma * dL)
        suff = ((th <= (1.0 - options.gamma_theta) * theta_prev)
                | (L <= L_prev - options.gamma_L * theta_prev))
        use_armijo = (th <= min_primal_1) & switching
        accept = (finite & frac_ok & ~blocked
                  & jnp.where(use_armijo, armijo, suff))
        counted = finite & frac_ok & ~accept
        return trial, th, L, J, accept, counted, armijo, switching

    trials, ths, Ls, Js, accepts, counted, armijos, switchings = jax.vmap(
        try_step)(gammas)

    found = jnp.any(accepts)
    idx = jnp.argmax(accepts)          # first (largest) accepted gamma
    pick = lambda a: jax.tree.map(lambda x: x[idx], a)
    # not-found: count ALL counted trials so the hybrid continuation's
    # counter picks up where the K candidates left off
    num_ls = jnp.where(found,
                       jnp.sum(jnp.where(jnp.arange(K) < idx, counted,
                                         False)),
                       jnp.sum(jnp.where(counted, 1, 0)))
    return ForwardResult(
        trial=pick(trials), theta_next=ths[idx], L_next=Ls[idx],
        objective=Js[idx],
        step_size=gammas[idx],
        num_ls=num_ls.astype(jnp.int32),
        status=jnp.where(found, jnp.int32(0), jnp.int32(7)),
        armijo_passed=armijos[idx], switching=switchings[idx])


def forward_pass_hybrid(problem: Problem, theta, bounds: Bounds,
                        gains: Gains, nominal: Trial, dL, mu,
                        theta_prev, L_prev, min_primal_1, filter_pts,
                        options: Options) -> ForwardResult:
    """Hybrid line search: one batched evaluation of the K = ls_speculative
    largest candidates, then sequential backtracking CONTINUES from 2^-K
    for instances where none was acceptable.

    Semantics are identical to pure backtracking (`forward_pass`): both
    accept the largest acceptable gamma in the same 2^-i sequence with the
    same per-candidate acceptance tests — the hybrid only changes the
    evaluation schedule. Under vmap the continuation while_loop runs zero
    trips unless some instance genuinely backtracks below 2^-K, so the
    max-over-batch trial chain that makes deep-backtracking iterations
    cost 10-20 sequential rollouts collapses to ONE batched evaluation in
    the common case."""
    spec = forward_pass_speculative(problem, theta, bounds, gains, nominal,
                                    dL, mu, theta_prev, L_prev,
                                    min_primal_1, filter_pts, options)
    found = spec.status == 0
    K = options.ls_speculative
    seq = forward_pass(problem, theta, bounds, gains, nominal, dL, mu,
                       theta_prev, L_prev, min_primal_1, filter_pts,
                       options, gamma0=0.5 ** K, skip=found,
                       num_ls0=spec.num_ls)
    return jax.tree.map(lambda a, b: jnp.where(found, a, b), spec, seq)
