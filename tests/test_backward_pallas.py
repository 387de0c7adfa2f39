"""Parity of the backward-sweep kernel vs the lax.scan sweep, through the
solver's own dispatch.

The kernel (`ops/backward_pallas.py`) must reproduce the scan backward pass
(`backward._run_pass`, reference: src/backward_pass.jl:58-189) — gains,
expected decrease, restart bookkeeping — on randomized inputs, including
randomized duals/trajectories (scan-order bugs can hide at uniform initial
states). Off the GPU the kernel runs in the Pallas interpreter, which these
tests ask for explicitly (the `interpret_kernel` fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipddp2tpu import Bounds, Options, Problem
from ipddp2tpu.backward import backward_pass
from ipddp2tpu.derivatives import (contract_dynamics_hessian,
                                   evaluate_derivatives, relax_constraints)
from ipddp2tpu.solve import initialize


def tiny_problem(nc=2):
    nx, nu, T = 2, 3, 6

    def dynamics(x, u, t, theta):
        return jnp.array([
            x[0] + 0.1 * x[1] + 0.05 * u[0] + 0.01 * jnp.sin(u[1]),
            x[1] + 0.1 * u[0] - 0.02 * x[0] * u[2],
        ])

    def cost(x, u, t, theta):
        return (jnp.sum(x**2) + 0.1 * jnp.sum(u**2)
                + 0.01 * x[0] * u[1] + 0.001 * u[0] ** 3)

    def terminal(x, theta):
        return 2.0 * jnp.sum(x**2) + 0.1 * x[0] * x[1]

    def constraints(x, u, t, theta):
        return jnp.array([u[0] + u[1] + 0.1 * x[0] ** 2,
                          u[2] - 0.5 * u[0] * u[1]])[:nc]

    return Problem(T=T, nx=nx, nu=nu, nc=nc, dynamics=dynamics,
                   stage_cost=cost, terminal_cost=terminal,
                   constraints=constraints if nc else None)


def random_inputs(problem, key, batch, dtype):
    ks = jax.random.split(key, 8)
    T, nx, nu, nc = problem.T, problem.nx, problem.nu, problem.nc
    shp = lambda *d: (batch,) + d
    x = 0.5 * jax.random.normal(ks[0], shp(T + 1, nx), dtype)
    u = 0.5 * jax.random.normal(ks[1], shp(T, nu), dtype)
    phi = jax.random.normal(ks[2], shp(T, nc), dtype)
    il = 0.5 + jax.random.uniform(ks[3], shp(T, nu), dtype)
    iu = 0.5 + jax.random.uniform(ks[4], shp(T, nu), dtype)
    zl = 0.1 + jax.random.uniform(ks[5], shp(T, nu), dtype)
    zu = 0.1 + jax.random.uniform(ks[6], shp(T, nu), dtype)
    c = jax.random.normal(ks[7], shp(T, nc), dtype)
    return x, u, phi, il, iu, zl, zu, c


def run_backward(problem, inputs, mu, options):
    x, u, phi, il, iu, zl, zu, c = inputs

    def one(x, u, phi, il, iu, zl, zu, c):
        deriv = evaluate_derivatives(problem, None, x, u, phi)
        nominal = (c, il, iu, phi, zl, zu)
        return backward_pass(problem, deriv, nominal,
                             jnp.asarray(mu, x.dtype),
                             jnp.zeros((), x.dtype), options)

    return jax.vmap(one)(x, u, phi, il, iu, zl, zu, c)


@pytest.mark.parametrize("nc", [2, 0])
@pytest.mark.kernels
def test_megakernel_matches_scan(nc, interpret_kernel):
    problem = tiny_problem(nc=nc)
    inputs = random_inputs(problem, jax.random.PRNGKey(0), 4, jnp.float64)
    ref = run_backward(problem, inputs, 0.1, Options(backward_kernel="xla"))
    out = run_backward(problem, inputs, 0.1,
                       Options(backward_kernel="pallas"))
    for a, b, name in zip(ref.gains, out.gains, ref.gains._fields):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-9, atol=1e-11, err_msg=name)
    np.testing.assert_allclose(np.asarray(out.dL), np.asarray(ref.dL),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.status),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(out.reg), np.asarray(ref.reg))


def test_megakernel_restart_ladder_parity(interpret_kernel):
    """Indefinite stage Hessians force inertia failures; the reg ladder must
    land on the same regularization and gains as the scan path."""
    problem = tiny_problem(nc=2)

    def bad_cost(x, u, t, theta):
        return (jnp.sum(x**2) - 0.8 * jnp.sum(u**2)
                + 0.01 * x[0] * u[1])

    import dataclasses
    problem = dataclasses.replace(problem, stage_cost=bad_cost)
    inputs = random_inputs(problem, jax.random.PRNGKey(1), 4, jnp.float64)
    ref = run_backward(problem, inputs, 0.1, Options(backward_kernel="xla"))
    out = run_backward(problem, inputs, 0.1,
                       Options(backward_kernel="pallas"))
    assert np.any(np.asarray(ref.reg) > 0)   # the ladder actually engaged
    np.testing.assert_allclose(np.asarray(out.reg), np.asarray(ref.reg))
    np.testing.assert_array_equal(np.asarray(out.status),
                                  np.asarray(ref.status))
    for a, b, name in zip(ref.gains, out.gains, ref.gains._fields):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


@pytest.mark.kernels
def test_megakernel_in_solver(interpret_kernel):
    """Full batched solve with the megakernel matches the scan solver."""
    from ipddp2tpu.batch import solve_batch
    from ipddp2tpu.models import double_integrator as di

    problem = di.problem()
    batch = 2
    x1 = jnp.broadcast_to(di.initial_state(), (batch, problem.nx))
    u0 = jnp.broadcast_to(di.initial_controls(),
                          (batch, problem.T, problem.nu))
    bounds = di.bounds()
    bb = Bounds(jnp.broadcast_to(bounds.lower, (batch,) + bounds.lower.shape),
                jnp.broadcast_to(bounds.upper, (batch,) + bounds.upper.shape))
    tol = 1e-7
    ref = solve_batch(problem, bb, x1, u0,
                      options=Options(optimality_tolerance=tol,
                                      backward_kernel="xla"))
    out = solve_batch(problem, bb, x1, u0,
                      options=Options(optimality_tolerance=tol,
                                      backward_kernel="pallas"))
    assert np.all(np.asarray(out.converged))
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(np.asarray(out.objective),
                               np.asarray(ref.objective), rtol=1e-9)


def test_auto_dispatch_takes_scan_off_gpu():
    from ipddp2tpu.backward import use_sweep_kernel

    assert jax.default_backend() != "gpu"
    assert not use_sweep_kernel(Options())
    assert not use_sweep_kernel(Options(backward_kernel="xla"))
    assert use_sweep_kernel(Options(backward_kernel="pallas"))


def test_forced_kernel_raises_off_gpu():
    """"pallas" never falls back to the interpreter silently: off the GPU
    Pallas refuses to lower the kernel unless `interpret=True` was passed."""
    problem = tiny_problem(nc=2)
    inputs = random_inputs(problem, jax.random.PRNGKey(0), 2, jnp.float64)
    with pytest.raises(ValueError, match="interpret mode"):
        run_backward(problem, inputs, 0.1, Options(backward_kernel="pallas"))
    with pytest.raises(ValueError, match="unknown backward_kernel"):
        run_backward(problem, inputs, 0.1, Options(backward_kernel="mosaic"))
