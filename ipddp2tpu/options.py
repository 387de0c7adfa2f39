"""Solver hyperparameters.

Mirrors the reference option set (reference: src/options.jl:1-38) with identical
defaults and IPOPT-inspired semantics, transliterated to ASCII names:

    reference name   here
    --------------   ----
    μ_init           mu_init
    κ_1, κ_2         kappa_1, kappa_2
    reg_1/min/max    reg_1, reg_min, reg_max
    κ_̄w_p            kappa_w_plus_bar     (first regularization bump factor, 100)
    κ_w_p            kappa_w_plus         (subsequent bump factor, 8)
    κ_w_m            kappa_w_minus        (decrease factor from last reg, 1/3)
    κ_c, δ_c         kappa_c, delta_c     (dual regularization schedule)
    κ_ϵ              kappa_eps            (barrier decrease trigger factor)
    κ_μ, θ_μ         kappa_mu, theta_mu   (linear / superlinear barrier decrease)
    τ_min            tau_min              (fraction-to-boundary lower bound)
    s_max            s_max                (NLP error scaling threshold)
    η_L              eta_L                (Armijo relaxation factor)
    s_L, δ, s_θ      s_L, delta, s_theta  (switching-rule exponents/multiplier)
    γ_α, γ_θ, γ_L    gamma_alpha, gamma_theta, gamma_L
    κ_Σ              kappa_Sigma          (unused by the reference; kept for parity)

The options marked "unused" below are unused in the reference implementation as
well (src/options.jl, see SURVEY.md §2.1); they are carried for API parity.

The dataclass is frozen and hashable so it can be passed to `jax.jit` as a
static argument — changing any option triggers a (cached) recompile.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Options:
    quasi_newton: bool = False          # drop all second-order tensor contractions
    optimality_tolerance: float = 1.0e-8
    max_iterations: int = 1000
    reset_cache: bool = True            # unused (parity)
    verbose: bool = False
    print_frequency: int = 10

    mu_init: float = 1.0                # barrier parameter initialisation
    ineq_dual_init: float = 1.0         # unused (parity): bound duals init to 1
    kappa_1: float = 0.01               # interior projection margin (abs)
    kappa_2: float = 0.01               # interior projection margin (rel)

    reg_1: float = 1e-4                 # first primal regularization value
    reg_min: float = 1e-20
    reg_max: float = 1e40
    kappa_w_plus_bar: float = 100.0     # reg bump when no previous reg
    kappa_w_plus: float = 8.0           # reg bump with previous reg
    kappa_w_minus: float = 1.0 / 3.0    # reg warm-start decrease
    kappa_c: float = 0.25               # dual reg exponent: delta_c * mu**kappa_c
    delta_c: float = 1e-8               # dual regularization scale

    kappa_eps: float = 10.0             # barrier decrease trigger: err_mu <= kappa_eps*mu
    kappa_mu: float = 0.2               # linear barrier decrease factor
    theta_mu: float = 1.2               # superlinear barrier decrease exponent
    tau_min: float = 0.99               # fraction-to-boundary lower bound

    s_max: float = 100.0                # scaling threshold for NLP error
    eta_L: float = 1e-4                 # Armijo relaxation factor
    s_L: float = 2.3                    # switching rule: barrier model exponent
    delta: float = 1.0                  # switching rule: constraint violation multiplier
    s_theta: float = 1.1                # switching rule: violation exponent
    gamma_alpha: float = 0.05           # unused (parity)
    gamma_theta: float = 1e-5           # filter margin: constraint violation
    gamma_L: float = 1e-5               # filter margin: barrier Lagrangian

    kappa_Sigma: float = 1e10           # unused (parity): dual rescaling threshold

    # --- extensions (not in the reference) ---
    filter_capacity: int = 64           # fixed-capacity ring buffer replaces the
                                        # reference's unbounded push! list
    inertia_atol: float = 1e-12         # |eig| tolerance for zero-eigenvalue count
                                        # (reference: inertia! atol=1e-12)
    max_backward_restarts: int = 60     # hard cap on the reg-ladder while_loop;
                                        # reference loops until reg > reg_max which
                                        # takes <= ~56 bumps from reg_1 with x8 steps
    refine_steps: int = 1               # iterative refinement sweeps on KKT solves
    backward_mode: str = "scan"         # "scan" (sequential lax.scan, matches
                                        # the reference) or "parallel"
                                        # (associative-scan Riccati: O(log T)
                                        # depth, same semantics)
    backward_kernel: str = "auto"       # batched backward-sweep dispatch
                                        # (backward.use_sweep_kernel):
                                        # "auto"   = the fused Pallas kernel
                                        #            when vmapped on a GPU
                                        #            (LDL^T inertia only)
                                        # "pallas" = always the kernel (GPU
                                        #            only: Pallas refuses
                                        #            to lower it elsewhere)
                                        # "xla"    = always the vmapped scan
    ldlt_unroll: bool = True            # unroll the factorization column loop
                                        # (faster dispatch; False shrinks the
                                        # compiled program for slow-compile
                                        # targets)
    kkt_residual_rtol: float = 1e-6     # backward-stability gate on refined KKT
                                        # solves; failing it triggers the same
                                        # reg-bump escape as wrong inertia
    inertia_method: str = "auto"        # "auto" (the default) resolves per
                                        #   problem at the solve entry
                                        #   points: "bk" when the problem
                                        #   declares mu-relaxed
                                        #   complementarity rows (contact
                                        #   problems — measured: restores
                                        #   exact acrobot golden parity and
                                        #   reference-level 98/100 pushing
                                        #   success), else "ldl";
                                        # "ldl" (fast, diagonal-pivoted +
                                        #   refinement),
                                        # "eigh" (oracle: exact inertia), or
                                        # "bk" (reference-faithful rook
                                        #   Bunch-Kaufman diagnostic,
                                        #   ops/bk.py — LAPACK sytrf_rook's
                                        #   decision structure + the exact
                                        #   reg-ladder semantics of
                                        #   src/inertia_correction.jl)
    ls_min_step: float = 0.0            # extra lower bound on line-search step size
                                        # (0 = machine eps like the reference)
    ls_failure_resets: int = 0          # robustness extension (0 = reference
                                        # behavior): on a line-search failure,
                                        # reset the filter and retry up to this
                                        # many times before declaring status 7
                                        # (rescues near-convergence filter
                                        # saturation on degenerate contact
                                        # problems)
    ls_speculative: int = 0             # 0 = reference backtracking while_loop;
                                        # K > 0 = evaluate gammas 2^-0..2^-(K-1)
                                        # in one batched rollout and pick the
                                        # largest acceptable
    ls_spec_continue: bool = False      # hybrid line search: after the
                                        # ls_speculative candidates, CONTINUE
                                        # sequential backtracking from
                                        # 2^-K instead of failing — semantics
                                        # identical to pure backtracking
                                        # (largest acceptable step), wall =
                                        # one batched K-candidate evaluation
                                        # in the common case; the lockstep
                                        # tail loop only runs for instances
                                        # backtracking below 2^-K
