"""Backward pass: Riccati-like recursion of per-stage primal-dual KKT solves.

Batched re-design of the reference backward pass (reference:
src/backward_pass.jl:1-195): a `lax.scan` (reverse over time) whose per-stage
body assembles the condensed primal-dual KKT system

    K = [ H_hat + reg*I   cu^T      ]     rhs = -[ Qu_hat   B  ]
        [ cu             -delta_c*I ]            [ c        cx ]

with
    Sigma_L = zl / il,  Sigma_U = zu / iu
    Qu_hat  = lu + cu^T phi + fu^T Vx' - mu/il + mu/iu
    C       = lxx + fx^T Vxx' fx  (+ lam' . fxx + phi . cxx)
    H_hat   = luu + diag(Sigma_L + Sigma_U) + fu^T Vxx' fu (+ lam' . fuu + phi . cuu)
    B       = lux + fu^T Vxx' fx  (+ lam' . fux + phi . cux)

solves for the affine control/equality-dual update rule [alpha beta; psi omega],
derives the bound-dual gains in closed form

    chi_l = mu/il - zl - Sigma_L alpha      zeta_l = -Sigma_L . beta
    chi_u = mu/iu - zu + Sigma_U alpha      zeta_u =  Sigma_U . beta

and propagates the value function and costate

    Vxx = C + beta^T B + omega^T cx
    Vx  = lx + cx^T phi + beta^T Qu_hat + omega^T c + fx^T Vx'
    lam = lx + cx^T phi + fx^T lam'

(reference: src/backward_pass.jl:62-189). The inertia-correction escape hatch
— restart the whole pass with a larger primal regularization whenever a stage's
KKT matrix has wrong inertia, and switch on dual regularization
delta_c = options.delta_c * mu^kappa_c when it is singular — is a bounded
`lax.while_loop` over the IPOPT-style ladder (reference:
src/backward_pass.jl:55,191, src/inertia_correction.jl:257-276).

The dynamics second-order contraction needs the costate lam' (reference:
src/backward_pass.jl:105); since the costate recursion is affine and
independent of the value recursion, it is evaluated FIRST as an associative
scan and the Hessian contraction lam . d2f is pre-computed vectorized over T
(contract_dynamics_hessian) — the sequential scan body then consumes one
dense [nz, nz] `second` block per stage and never materializes the full
[nx, nz, nz] Hessian tensor. Everything `vmap`s over problem instances; the
restart loop then runs in lockstep with per-instance predicates.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.custom_batching import custom_vmap

from .derivatives import DerivativeBundle
from .ops.ldlt import (eigh_factor_and_inertia, eigh_solve,
                       ldlt_factor_pivoted, ldlt_solve_refined)
from .options import Options
from .problem import Problem

Array = jax.Array


class Gains(NamedTuple):
    """Affine update rule parameters, stacked over time.

    Layout mirrors the reference's per-stage gain matrices with views
    (reference: src/data/update_rule.jl:68-84) as dense [T, ...] arrays.
    """

    alpha: Array    # [T, nu]      feedforward control
    beta: Array     # [T, nu, nx]  feedback control
    psi: Array      # [T, nc]      feedforward equality dual
    omega: Array    # [T, nc, nx]  feedback equality dual
    chi_l: Array    # [T, nu]      feedforward lower-bound dual
    zeta_l: Array   # [T, nu, nx]  feedback lower-bound dual
    chi_u: Array    # [T, nu]
    zeta_u: Array   # [T, nu, nx]


class BackwardResult(NamedTuple):
    gains: Gains
    lam: Array          # [T+1, nx] costates (nominal dynamics duals)
    dL: Array           # scalar: expected Lagrangian change per unit step
    status: Array       # scalar int: 0 ok, 1 backward failed
    reg: Array          # scalar: regularization used by the accepted pass
    delta_c: Array      # scalar: dual regularization used


class _StageOut(NamedTuple):
    alpha: Array
    beta: Array
    psi: Array
    omega: Array
    chi_l: Array
    zeta_l: Array
    chi_u: Array
    zeta_u: Array


def _costate_seq_single(fx, r_x, lam_T):
    """Per-instance reverse scan: lam_t = r_t + fx_t' lam_{t+1}."""
    def step(lam_next, xs):
        fxT, r = xs
        lam = r + (fxT @ lam_next[..., None])[..., 0]
        return lam, lam

    _, lam = jax.lax.scan(step, lam_T, (fx.swapaxes(-1, -2), r_x),
                          reverse=True)
    return jnp.concatenate([lam, lam_T[None]], axis=0)       # [T+1, nx]


def costate_scan(deriv: DerivativeBundle, phi, mode: str = "auto"):
    """Costate refresh lam_t = r_x + fx' lam_{t+1} (reference:
    src/backward_pass.jl:183,189), evaluated BEFORE the backward sweep so
    the dynamics Hessians can be pre-contracted outside the sequential scan.

    Two evaluation orders with identical-math results (up to reassociation):
      * "assoc": associative affine scan, O(log T) depth but O(T log T)
        [nx,nx]@[nx,nx] combines — wins when depth (latency) dominates;
      * "seq": reverse `lax.scan` of [nx,nx]@[nx] matvecs, O(T) depth but
        4x less work and no log factor.
    "auto" is assoc: the CPU's golden-parity iterate paths depend on it
    (reassociation shifts iteration counts), and on an H100 at b2048 it
    measured faster in f32 and level in f64 (chip_smoke.py's kernel phase
    times both; PERF.md)."""
    r_x = deriv.lx + jnp.einsum("tcx,tc->tx", deriv.cx, phi)
    lam_T = deriv.lTx
    if mode == "auto":
        mode = "assoc"

    if mode == "seq":
        return _costate_seq_single(deriv.fx, r_x, lam_T)

    def comb(a, b):
        # a = lower scan index (terminal side, inner map), b = outer
        Ma, va = a
        Mb, vb = b
        return Mb @ Ma, (Mb @ va[..., None])[..., 0] + vb

    Ms = jnp.flip(deriv.fx.swapaxes(-1, -2), axis=0)
    vs = jnp.flip(r_x, axis=0)
    Mc, vc = jax.lax.associative_scan(comb, (Ms, vs))
    lam = jnp.flip((Mc @ lam_T[..., None])[..., 0] + vc, axis=0)
    return jnp.concatenate([lam, lam_T[None]], axis=0)   # [T+1, nx]


def _run_pass(problem: Problem, deriv: DerivativeBundle, nominal,
              mu, reg, delta_c, options: Options, second=None,
              collect_kkt: bool = False):
    """One full backward sweep at fixed (reg, delta_c).

    `second` is the pre-contracted second-order term per stage
    (lam . d2f + phi . d2c, [T, nz, nz]) or None in quasi-Newton mode.
    Returns (stage outputs, dL, fail, singular_at_first_failure)
    (plus stacked per-stage KKT matrices when collect_kkt, for diagnostics).
    """
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    T = problem.T
    c_rel, il, iu, phi, zl, zu = nominal  # each [T, ...]

    quasi_newton = options.quasi_newton
    dtype = il.dtype
    eye_nu = jnp.eye(nu, dtype=dtype)
    eye_nc = jnp.eye(nc, dtype=dtype)

    def stage(carry, xs):
        Vx_n, Vxx_n, dL, fail, singular = carry
        (fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
         c_t, il_t, iu_t, phi_t, zl_t, zu_t) = xs

        sl = 1.0 / il_t          # 0 where il = +inf (unbounded below)
        su = 1.0 / iu_t
        sig_l = zl_t * sl
        sig_u = zu_t * su

        Qu = lu + cu.T @ phi_t + fu.T @ Vx_n - mu * sl + mu * su

        fuV = fu.T @ Vxx_n               # [nu, nx]
        fxV = fx.T @ Vxx_n               # [nx, nx]
        C = lxx + fxV @ fx
        H = luu + jnp.diag(sig_l + sig_u) + fuV @ fu
        Bm = lux + fuV @ fx

        if not quasi_newton:
            C = C + sec[:nx, :nx]
            Bm = Bm + sec[nx:, :nx]
            H = H + sec[nx:, nx:]
        H = H + reg * eye_nu

        m = nu + nc
        K = jnp.zeros((m, m), dtype)
        K = K.at[:nu, :nu].set(H)
        if nc > 0:
            K = K.at[:nu, nu:].set(cu.T)
            K = K.at[nu:, :nu].set(cu)
            K = K.at[nu:, nu:].set(-delta_c * eye_nc)

        rhs = jnp.concatenate(
            [
                jnp.concatenate([-Qu[:, None], -Bm], axis=1),
                jnp.concatenate([-c_t[:, None], -cx], axis=1),
            ],
            axis=0,
        )                                             # [m, nx+1]
        if options.inertia_method == "eigh":
            factors = eigh_factor_and_inertia(K, atol=options.inertia_atol)
            X = eigh_solve(factors, rhs)
            solve_ok = jnp.asarray(True)
        elif options.inertia_method == "bk":
            # Reference-faithful Bunch-Kaufman rook diagnostic path
            # (reference: src/inertia_correction.jl:257-276): plain ldiv,
            # no refinement/residual gate; singular = info > 0; ladder on
            # np != nu or info != 0. See ops/bk.py fidelity notes.
            from .ops.bk import bk_factor_rook, bk_inertia, bk_solve
            bkf = bk_factor_rook(K)
            n_pos_bk, _, _ = bk_inertia(bkf, atol=options.inertia_atol)
            X = bk_solve(bkf, rhs)

            class _F(NamedTuple):
                ok: Array
                n_pos: Array
                n_zero: Array
            factors = _F(ok=bkf.info == 0, n_pos=n_pos_bk,
                         n_zero=jnp.where(bkf.info > 0, 1, 0))
            solve_ok = jnp.asarray(True)
        else:
            # Diagonal-pivoted LDL^T: pivot signs give the exact inertia when
            # the factorization is sound; soundness is certified a posteriori
            # by the refined solve's backward-stability residual. A breakdown
            # is answered exactly like wrong inertia — bump reg and restart
            # (reference escape hatch: src/inertia_correction.jl:266-273).
            factors = ldlt_factor_pivoted(K, unroll=options.ldlt_unroll)
            X, solve_ok = ldlt_solve_refined(
                factors, K, rhs, refine_steps=options.refine_steps,
                check_residual=True,
                residual_rtol=options.kkt_residual_rtol)
        stage_ok = factors.ok & (factors.n_pos == nu) & solve_ok
        stage_singular = factors.n_zero > 0
        alpha, beta = X[:nu, 0], X[:nu, 1:]
        psi, omega = X[nu:, 0], X[nu:, 1:]

        chi_l = mu * sl - zl_t - sig_l * alpha
        zeta_l = -sig_l[:, None] * beta
        chi_u = mu * su - zu_t + sig_u * alpha
        zeta_u = sig_u[:, None] * beta

        Vxx = C + beta.T @ Bm + omega.T @ cx
        # Exact-arithmetic Vxx is symmetric (C - [B' cx'] K^{-1} [B; cx]);
        # without explicit symmetrization, roundoff asymmetry is amplified
        # geometrically by the recursion (~1.5x/stage observed on the contact
        # benchmarks, destroying the KKT blocks after ~60 stages).
        Vxx = 0.5 * (Vxx + Vxx.T)
        Vx_pre = lx + cx.T @ phi_t
        Vx = Vx_pre + beta.T @ Qu + omega.T @ c_t + fx.T @ Vx_n

        dL = dL + Qu @ alpha + c_t @ psi

        first_fail = jnp.logical_and(~fail, ~stage_ok)
        singular = singular | (first_fail & stage_singular)
        fail = fail | ~stage_ok

        out = _StageOut(alpha, beta, psi, omega,
                        chi_l, zeta_l, chi_u, zeta_u)
        if collect_kkt:
            out = (out, (K, rhs, X, stage_ok, factors.n_pos, solve_ok))
        return (Vx, Vxx, dL, fail, singular), out

    nz = nx + nu
    xs = (deriv.fx, deriv.fu,
          deriv.lx, deriv.lu, deriv.lxx, deriv.lux, deriv.luu,
          deriv.cx, deriv.cu,
          second if second is not None else jnp.zeros((T, nz, nz), dtype),
          c_rel, il, iu, phi, zl, zu)

    # Tie the scalar carry inits to a traced input so their varying-manual-
    # axes match the body outputs under shard_map (a literal zero is
    # "unvarying" and trips the scan carry VMA check).
    vzero = mu * jnp.zeros((), dtype)
    vfalse = vzero > jnp.zeros((), dtype)
    carry0 = (deriv.lTx, deriv.lTxx, vzero, vfalse, vfalse)
    (_, _, dL, fail, singular), outs = jax.lax.scan(
        stage, carry0, xs, reverse=True
    )
    kkt_debug = None
    if collect_kkt:
        outs, kkt_debug = outs
    gains = Gains(outs.alpha, outs.beta, outs.psi, outs.omega,
                  outs.chi_l, outs.zeta_l, outs.chi_u, outs.zeta_u)
    if collect_kkt:
        return gains, dL, fail, singular, kkt_debug
    return gains, dL, fail, singular


@lru_cache(maxsize=64)
def _make_sweep(problem: Problem, options: Options):
    """One backward-sweep attempt at fixed per-instance (reg, delta_c), as a
    `custom_vmap` function: per instance it is the `lax.scan` sweep
    (`_run_pass`); under `vmap` over problem instances it dispatches to the
    fused Pallas kernel (`ops/backward_pallas.py`) when `use_sweep_kernel`
    says so. The batched reg-restart ladder above is unchanged: JAX's
    batched `while_loop` masks non-failing instances itself.
    """
    use_kernel = use_sweep_kernel(options)

    def single(deriv, nominal, second, mu, reg, delta_c):
        return _run_pass(problem, deriv, nominal, mu, reg, delta_c,
                         options, second=second)

    sweep = custom_vmap(single)

    @sweep.def_vmap
    def _rule(axis_size, in_batched, deriv, nominal, second, mu, reg,
              delta_c):
        def bc(x, b):
            if b:
                return x
            return jnp.broadcast_to(x[None], (axis_size,) + jnp.shape(x))

        deriv, nominal, second, mu, reg, delta_c = jax.tree.map(
            bc, [deriv, nominal, second, mu, reg, delta_c], in_batched)
        if not use_kernel:
            out = jax.vmap(single)(deriv, nominal, second, mu, reg, delta_c)
            return out, jax.tree.map(lambda _: True, out)

        from .ops.backward_pallas import backward_sweep_pallas
        c_rel, il, iu, phi, zl, zu = nominal
        gains_t, dL, fail, singular = backward_sweep_pallas(
            deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx,
            deriv.lux, deriv.luu, deriv.cx, deriv.cu, second,
            c_rel, il, iu, phi, zl, zu, deriv.lTx, deriv.lTxx,
            mu, reg, delta_c,
            nx=problem.nx, nu=problem.nu, nc=problem.nc,
            refine=max(options.refine_steps, 1),
            rtol=options.kkt_residual_rtol)
        out = (Gains(*gains_t), dL, fail, singular)
        return out, jax.tree.map(lambda _: True, out)

    return sweep


def use_sweep_kernel(options: Options) -> bool:
    """Whether batched backward sweeps run the Pallas kernel.

    "auto" takes it on a GPU with the LDL^T inertia oracle (the kernel
    counts exact-zero pivots, not eigh's atol signs; an unresolved "auto"
    inertia method means LDL^T, as in `_run_pass`); "xla" never; "pallas"
    always. Off the GPU Pallas refuses to lower the kernel, so nothing
    falls back to the interpreter unasked: only a caller of
    `backward_sweep_pallas` that passes `interpret=True` gets it."""
    mode = options.backward_kernel
    if mode == "auto":
        return (jax.default_backend() == "gpu"
                and options.inertia_method in ("ldl", "auto"))
    if mode not in ("xla", "pallas"):
        raise ValueError(f"unknown backward_kernel {mode!r}")
    return mode == "pallas"


def backward_pass(problem: Problem, deriv: DerivativeBundle, nominal,
                  mu, reg_last, options: Options, *, lam=None,
                  second=None) -> BackwardResult:
    """Full backward pass with the inertia-correction restart ladder.

    `nominal` = (c_relaxed [T,nc], il [T,nu], iu [T,nu], phi [T,nc],
    zl [T,nu], zu [T,nu]) — the accepted-iterate quantities the recursion
    reads (reference: src/backward_pass.jl:48-49). `lam`/`second` (costates
    and pre-contracted second-order terms) are computed here if not supplied
    by the caller.
    """
    nx, nu, nc, T = problem.nx, problem.nu, problem.nc, problem.T
    dtype = nominal[1].dtype
    # Tied to mu so the ladder while_loop carry's varying-manual-axes match
    # under shard_map (mu is varying via `initialize`).
    zero = mu * jnp.zeros((), dtype)

    if lam is None:
        lam = costate_scan(deriv, nominal[3])
    if second is None and not options.quasi_newton:
        # cH_phi precomputed with nominal phi; dynamics part needs lam
        second = deriv.cH_phi
        if deriv.fH is not None:
            second = second + jnp.einsum("ti,tijk->tjk", lam[1:], deriv.fH)

    sweep = _make_sweep(problem, options)

    def next_reg(reg):
        # IPOPT-style ladder (reference: src/inertia_correction.jl:268-273).
        first = jnp.where(
            reg_last == 0.0,
            jnp.asarray(options.reg_1, dtype),
            jnp.maximum(options.reg_min, options.kappa_w_minus * reg_last),
        )
        bumped = jnp.where(
            reg_last == 0.0,
            options.kappa_w_plus_bar * reg,
            options.kappa_w_plus * reg,
        )
        return jnp.where(reg == 0.0, first, bumped)

    # Clamp reg_max to the working dtype's finite max (the reference default
    # 1e40 overflows to inf when cast to f32, which would make the guard
    # vacuous) — computed in Python to avoid the overflow-on-cast warning.
    reg_max = jnp.asarray(min(options.reg_max, float(jnp.finfo(dtype).max)),
                          dtype)

    # One loop, one sweep call site (a second site would compile the
    # sweep kernel twice): n = -1 marks "no attempt yet", and the first
    # attempt always runs with reg = 0, delta_c = 0
    # (reference: src/backward_pass.jl:52-53).
    def cond(carry):
        reg, _, _, _, fail, _, n = carry
        # Stop once the reg the *next* attempt would use exceeds reg_max —
        # the reference never factorizes above reg_max
        # (reference: src/backward_pass.jl:55).
        return (n < 0) | (fail & (next_reg(reg) <= reg_max)
                          & (n < options.max_backward_restarts))

    def body(carry):
        reg, delta_c, _, _, _, singular, n = carry
        # The failed attempt determined the new (reg, delta_c)
        # (reference: src/inertia_correction.jl:263-273).
        first = n < 0
        delta_c_new = jnp.where(
            first, zero,
            jnp.where(singular,
                      jnp.asarray(options.delta_c, dtype)
                      * mu ** options.kappa_c,
                      delta_c))
        reg_new = jnp.where(first, zero, next_reg(reg))
        gains, dL, fail, singular = sweep(deriv, nominal, second, mu,
                                          reg_new, delta_c_new)
        return (reg_new, delta_c_new, gains, dL, fail, singular, n + 1)

    def placeholder(*shape):
        return jnp.zeros((T,) + shape, dtype) + zero

    no_gains = Gains(placeholder(nu), placeholder(nu, nx), placeholder(nc),
                     placeholder(nc, nx), placeholder(nu),
                     placeholder(nu, nx), placeholder(nu),
                     placeholder(nu, nx))
    vfalse = zero > zero
    carry = (zero, zero, no_gains, zero, vfalse, vfalse,
             jnp.asarray(-1, jnp.int32) + zero.astype(jnp.int32))
    reg, delta_c, gains, dL, fail, singular, _ = jax.lax.while_loop(
        cond, body, carry
    )

    status = jnp.where(fail, jnp.int32(1), jnp.int32(0))
    return BackwardResult(gains=gains, lam=lam, dL=dL, status=status,
                          reg=reg, delta_c=delta_c)
