"""Time-sharded value scan parity (parallel/timeshard.py): the suffix value
functions computed with the time axis sharded over the 8-virtual-device mesh
must match the single-device associative scan, on a REAL mid-solve iterate
(randomized duals/trajectories — uniform states can hide composition-order
bugs, CLAUDE.md numerical lessons)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ipddp2tpu import Options
from ipddp2tpu.backward import costate_scan
from ipddp2tpu.derivatives import (contract_dynamics_hessian,
                                   evaluate_derivatives, relax_constraints)
from ipddp2tpu.parallel.priccati import (_stage_blocks, parallel_value_scan)
from ipddp2tpu.parallel.timeshard import value_scan_timesharded
from ipddp2tpu.problem import Problem
import pytest


def _problem(T):
    nx, nu, nc = 2, 3, 2

    def dynamics(x, u, t, theta):
        return jnp.array([
            x[0] + 0.1 * x[1] + 0.05 * u[0] + 0.01 * jnp.sin(u[1]),
            x[1] + 0.1 * u[0] - 0.02 * x[0] * u[2],
        ])

    def cost(x, u, t, theta):
        return (jnp.sum(x**2) + 0.1 * jnp.sum(u**2) + 0.01 * x[0] * u[1])

    def constraints(x, u, t, theta):
        return jnp.array([u[0] + u[1] + 0.1 * x[0] ** 2,
                          u[2] - 0.5 * u[0] * u[1]])

    return Problem(T=T, nx=nx, nu=nu, nc=nc, dynamics=dynamics,
                   stage_cost=cost,
                   terminal_cost=lambda x, theta: 2.0 * jnp.sum(x**2),
                   constraints=constraints)


def test_timesharded_value_scan_matches_single_device():
    T = 96                                   # 12 stages per device
    problem = _problem(T)
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    x = 0.5 * jax.random.normal(ks[0], (T + 1, problem.nx))
    u = 0.5 * jax.random.normal(ks[1], (T, problem.nu))
    phi = jax.random.normal(ks[2], (T, problem.nc))
    il = 0.5 + jax.random.uniform(ks[3], (T, problem.nu))
    iu = 0.5 + jax.random.uniform(ks[4], (T, problem.nu))
    zl = 0.1 + jax.random.uniform(ks[5], (T, problem.nu))
    zu = 0.1 + jax.random.uniform(ks[6], (T, problem.nu))
    c = 0.1 * jax.random.normal(ks[7], (T, problem.nc))

    deriv = evaluate_derivatives(problem, None, x, u, phi)
    lam = costate_scan(deriv, phi)
    second = contract_dynamics_hessian(problem, None, x, u,
                                       lam[1:]) + deriv.cH_phi
    mu = jnp.asarray(0.01)
    nominal = (c, il, iu, phi, zl, zu)
    elements = _stage_blocks(problem, deriv, nominal, mu, second,
                             jnp.zeros(()), jnp.zeros(()), Options())

    Vx_ref, Vxx_ref = parallel_value_scan(problem, elements,
                                          deriv.lTx, deriv.lTxx)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    Vx_sh, Vxx_sh = value_scan_timesharded(problem, elements,
                                           deriv.lTx, deriv.lTxx, mesh)

    np.testing.assert_allclose(np.asarray(Vx_sh), np.asarray(Vx_ref),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(Vxx_sh), np.asarray(Vxx_ref),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.slow
def test_solve_timesharded_long_horizon():
    """End-to-end backward_mode="timeshard": a T=1024 long-horizon solve with
    the value scan sharded over the 8-device mesh must follow the same
    iterate path as the single-device parallel mode (iterate parity at small
    k — the regime the mode exists for; full-convergence iteration counts
    may drift across compilation layouts, CLAUDE.md multi-host lesson)."""
    from ipddp2tpu.models import double_integrator as di
    from ipddp2tpu.parallel.timeshard import solve_timesharded
    from ipddp2tpu.problem import uniform_bounds
    from ipddp2tpu.solve import solve

    T = 1024                                 # 128 stages per device
    problem = Problem(T=T, nx=di.NX, nu=di.NU, nc=di.NC,
                      dynamics=di.dynamics, stage_cost=di.stage_cost,
                      terminal_cost=di.terminal_cost,
                      constraints=di.constraints)
    lo = jnp.array([-di.FORCE_LIMIT, 0.0, 0.0])
    hi = jnp.array([di.FORCE_LIMIT, jnp.inf, jnp.inf])
    bounds = uniform_bounds(T, lo, hi)
    x1 = di.initial_state()
    u0 = jnp.full((T, di.NU), 0.01)

    opts = Options(optimality_tolerance=1e-7, max_iterations=8)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    sh = solve_timesharded(problem, bounds, x1, u0, options=opts, mesh=mesh)
    ref = solve(problem, bounds, x1, u0,
                options=Options(optimality_tolerance=1e-7, max_iterations=8,
                                backward_mode="parallel"))
    np.testing.assert_allclose(np.asarray(sh.u), np.asarray(ref.u),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-10)
    # and against the sequential reference backward (same math, scan order)
    seq = solve(problem, bounds, x1, u0,
                options=Options(optimality_tolerance=1e-7, max_iterations=8,
                                backward_mode="scan"))
    np.testing.assert_allclose(np.asarray(sh.u), np.asarray(seq.u),
                               rtol=1e-6, atol=1e-8)
