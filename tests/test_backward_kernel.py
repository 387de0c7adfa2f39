"""The backward-sweep kernel called directly, in the Pallas interpreter,
against one vmapped `backward._run_pass` attempt (the lax.scan sweep).

Covers both dtypes, every constraint count the kernel specialises on, a
batch that fills its tiles and one that leaves a ragged, masked last tile,
the graded barrier systems of the f64 endgame, and the fail / singular
flags of one attempt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipddp2tpu import Options
from ipddp2tpu.backward import _run_pass, costate_scan
from ipddp2tpu.derivatives import (contract_dynamics_hessian,
                                   evaluate_derivatives)
from ipddp2tpu.ops.backward_pallas import backward_sweep_pallas
from test_backward_pallas import random_inputs, tiny_problem

TILE = 4

# Relative to each instance's largest entry of the compared field: the two
# sweeps run the same recursion in another summation order, so they differ
# by unit roundoff times modest growth over T = 6 stages.
RTOL = {jnp.float64: 1e-10, jnp.float32: 1e-4}


def sweep_args(problem, inputs):
    x, u, phi, il, iu, zl, zu, c = inputs

    def prep(x, u, phi):
        deriv = evaluate_derivatives(problem, None, x, u, phi)
        lam = costate_scan(deriv, phi)
        second = deriv.cH_phi + contract_dynamics_hessian(
            problem, None, x, u, lam[1:])
        return deriv, second

    deriv, second = jax.vmap(prep)(x, u, phi)
    return deriv, (c, il, iu, phi, zl, zu), second


def both_sweeps(problem, deriv, nominal, second, mu, reg=0.0, dc=0.0):
    B = deriv.fx.shape[0]
    dt = deriv.fx.dtype
    full = lambda v: jnp.full((B,), v, dt)
    mu, reg, dc = full(mu), full(reg), full(dc)
    options = Options()
    ref = jax.vmap(lambda d, nom, s, m, r, q: _run_pass(
        problem, d, nom, m, r, q, options, second=s))(
        deriv, nominal, second, mu, reg, dc)
    c, il, iu, phi, zl, zu = nominal
    out = backward_sweep_pallas(
        deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
        deriv.luu, deriv.cx, deriv.cu, second, c, il, iu, phi, zl, zu,
        deriv.lTx, deriv.lTxx, mu, reg, dc, nx=problem.nx, nu=problem.nu,
        nc=problem.nc, refine=max(options.refine_steps, 1),
        rtol=options.kkt_residual_rtol, tile_b=TILE, interpret=True)
    return out, ref


def rel_err(a, b):
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    if a.shape[1] == 0:
        return 0.0
    scale = np.maximum(np.abs(b).max(axis=1), 1e-300)
    return float((np.abs(a - b).max(axis=1) / scale).max())


def assert_parity(out, ref, rtol):
    (gains, dL, fail, singular), (rg, rdL, rfail, rsing) = out, ref
    np.testing.assert_array_equal(np.asarray(fail), np.asarray(rfail))
    np.testing.assert_array_equal(np.asarray(singular), np.asarray(rsing))
    for name, a, b in zip(rg._fields, gains, rg):
        assert np.shape(a) == np.shape(b), name
        assert rel_err(a, b) <= rtol, (name, rel_err(a, b))
    assert rel_err(dL[:, None], rdL[:, None]) <= rtol


@pytest.mark.kernels
@pytest.mark.parametrize("batch", [2 * TILE, TILE + 2],
                         ids=["full_tiles", "ragged"])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nc", [0, 1, 2])
def test_kernel_matches_scan_sweep(nc, dtype, batch):
    problem = tiny_problem(nc=nc)
    inputs = random_inputs(problem, jax.random.PRNGKey(nc), batch, dtype)
    out, ref = both_sweeps(problem, *sweep_args(problem, inputs), mu=0.1)
    assert not np.asarray(ref[2]).any()      # every attempt succeeded
    assert_parity(out, ref, RTOL[dtype])


@pytest.mark.kernels
def test_kernel_graded_sigma_endgame():
    """mu = 1e-8 with slacks ~1e-8 below: Sigma_L ~ 1e8-1e10, the graded
    KKT systems the f64 endgame solves. Both sweeps pivot the large rows
    first; the gains agree to f64 roundoff amplified by the grading."""
    problem = tiny_problem(nc=2)
    x, u, phi, il, iu, zl, zu, c = random_inputs(
        problem, jax.random.PRNGKey(3), 6, jnp.float64)
    inputs = (x, u, phi, 1e-8 + 1e-9 * il, 0.5 + iu, zl, zu, c)
    out, ref = both_sweeps(problem, *sweep_args(problem, inputs), mu=1e-8)
    assert not np.asarray(ref[2]).any()
    # scaled by max(|field|, 1): the bound-dual gains carry Sigma ~ 1e10
    for name, a, b in zip(ref[0]._fields, out[0], ref[0]):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-11,
                                   err_msg=name)


@pytest.mark.kernels
def test_kernel_fail_and_singular_flags():
    """Instance 2 has an indefinite control Hessian (wrong inertia: fail,
    not singular); instance 3 has a control that enters nothing (an exact
    zero pivot: fail and singular). Both sweeps flag them alike."""
    problem = tiny_problem(nc=2)
    inputs = random_inputs(problem, jax.random.PRNGKey(5), 4, jnp.float64)
    deriv, nominal, second = sweep_args(problem, inputs)
    c, il, iu, phi, zl, zu = nominal
    nx = problem.nx
    deriv = deriv._replace(
        luu=deriv.luu.at[2].set(-10.0 * jnp.eye(problem.nu))
        .at[3, :, 2, :].set(0.0).at[3, :, :, 2].set(0.0),
        fu=deriv.fu.at[3, :, :, 2].set(0.0),
        lux=deriv.lux.at[3, :, 2, :].set(0.0),
        cu=deriv.cu.at[3, :, :, 2].set(0.0))
    second = (second.at[3, :, nx + 2, :].set(0.0)
              .at[3, :, :, nx + 2].set(0.0))
    il = il.at[3, :, 2].set(jnp.inf)
    iu = iu.at[3, :, 2].set(jnp.inf)
    zl = zl.at[3, :, 2].set(0.0)
    zu = zu.at[3, :, 2].set(0.0)
    out, ref = both_sweeps(problem, deriv, (c, il, iu, phi, zl, zu),
                           second, mu=0.1)
    np.testing.assert_array_equal(np.asarray(ref[2]),
                                  [False, False, True, True])
    np.testing.assert_array_equal(np.asarray(ref[3]),
                                  [False, False, False, True])
    np.testing.assert_array_equal(np.asarray(out[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(np.asarray(out[3]), np.asarray(ref[3]))
    ok = ~np.asarray(ref[2])
    for name, a, b in zip(ref[0]._fields, out[0], ref[0]):
        assert rel_err(np.asarray(a)[ok], np.asarray(b)[ok]) <= 1e-10, name


def test_kernel_outputs_carry_shard_vma():
    """Under shard_map with check_vma the kernel's outputs vary over the
    mesh axis its inputs vary over (its out_shape carries their vma).
    Traced and lowered for CUDA: the CPU cannot run the Triton kernel."""
    from jax.sharding import Mesh, PartitionSpec as P

    problem = tiny_problem(nc=2)
    n = 2 * len(jax.devices())
    inputs = random_inputs(problem, jax.random.PRNGKey(4), n, jnp.float64)
    deriv, nominal, second = sweep_args(problem, inputs)
    mu = jnp.full((n,), 0.1)
    seen = {}

    def shard(deriv, nominal, second, mu):
        c, il, iu, phi, zl, zu = nominal
        out = backward_sweep_pallas(
            deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
            deriv.luu, deriv.cx, deriv.cu, second, c, il, iu, phi, zl, zu,
            deriv.lTx, deriv.lTxx, mu, 0.0 * mu, 0.0 * mu, nx=problem.nx,
            nu=problem.nu, nc=problem.nc, refine=1, rtol=1e-6)
        gains, dL, fail, _ = out
        seen.update(alpha=jax.typeof(gains[0]).vma, dL=jax.typeof(dL).vma,
                    fail=jax.typeof(fail).vma)
        return out

    mesh = Mesh(np.asarray(jax.devices()), ("dp",))
    fn = jax.jit(jax.shard_map(shard, mesh=mesh, in_specs=P("dp"),
                               out_specs=P("dp"), check_vma=True))
    text = fn.trace(deriv, nominal, second, mu).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "backward_sweep" in text
    assert seen == {k: frozenset({"dp"}) for k in ("alpha", "dL", "fail")}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
def test_compiled_kernel_matches_scan_sweep(gpu, dtype):
    """The kernel as the GPU compiles it (no interpreter), ragged batch."""
    problem = tiny_problem(nc=2)
    inputs = random_inputs(problem, jax.random.PRNGKey(7), 37, dtype)
    deriv, nominal, second = sweep_args(problem, inputs)
    options = Options()
    mu = jnp.full((37,), 0.1, dtype)
    zero = jnp.zeros_like(mu)
    ref = jax.vmap(lambda d, nom, s, m: _run_pass(
        problem, d, nom, m, 0.0 * m, 0.0 * m, options, second=s))(
        deriv, nominal, second, mu)
    c, il, iu, phi, zl, zu = nominal
    out = backward_sweep_pallas(
        deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
        deriv.luu, deriv.cx, deriv.cu, second, c, il, iu, phi, zl, zu,
        deriv.lTx, deriv.lTxx, mu, zero, zero, nx=problem.nx,
        nu=problem.nu, nc=problem.nc, refine=1,
        rtol=options.kkt_residual_rtol)
    assert_parity(out, ref, RTOL[dtype])
