"""Every matrix product the solver traces runs at HIGHEST precision.

On a GPU an f32 `dot_general` at default precision may run in TF32 (about
three decimal digits), far short of the f32 phase's 3e-4 KKT target. The
solver's traced entries carry `solve.full_precision`, so no entry point's
program may hold a product at a lower precision.
"""

import jax
import jax.numpy as jnp
import pytest
from jax import lax
from jax.extend.core import ClosedJaxpr, Jaxpr

from ipddp2tpu import Bounds, Options, solve
from ipddp2tpu.batch import solve_batch
from ipddp2tpu.chunked import _chunk_runner
from ipddp2tpu.mixed import solve_mixed
from ipddp2tpu.models import concar
from ipddp2tpu.solve import initialize

HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
OPTS = Options(optimality_tolerance=1e-7, max_iterations=3,
               ls_speculative=2, ls_spec_continue=True)


def _subjaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def dot_precisions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive is lax.dot_general_p:
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from dot_precisions(sub)


def _instances(n, dtype=jnp.float64):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    thetas, f_lims, tau_lims, x1s = jax.vmap(concar.random_instance)(keys)
    cast = lambda t: jax.tree.map(lambda a: a.astype(dtype), t)
    u0 = jnp.broadcast_to(concar.initial_controls(dtype),
                          (n, concar.T, concar.NU))
    return (cast(concar.bounds(f_lims, tau_lims)), cast(x1s), u0,
            cast(thetas))


def _solve():
    b, x1, u0, th = jax.tree.map(lambda a: a[0], _instances(1))
    return jax.make_jaxpr(lambda x, u: solve(
        concar.problem(), b, x, u, theta=th, options=OPTS))(x1, u0)


def _solve_batch():
    b, x1, u0, th = _instances(2)
    return jax.make_jaxpr(lambda x, u: solve_batch(
        concar.problem(), b, x, u, theta=th, options=OPTS))(x1, u0)


def _solve_chunked_program():
    # the jitted chunk program solve_chunked(batched=True) runs
    problem = concar.problem()
    b, x1, u0, th = _instances(2)
    state = jax.vmap(lambda bb, x, u, t: initialize(problem, t, bb, x, u,
                                                    OPTS),
                     in_axes=(Bounds(0, 0), 0, 0, 0))(b, x1, u0, th)
    run_chunk = _chunk_runner(problem, OPTS, True, True)
    return jax.make_jaxpr(run_chunk)(state, b, th,
                                     jnp.full((2,), 3, jnp.int32))


def _mixed_phase1():
    b, x1, u0, th = jax.tree.map(lambda a: a[0],
                                 _instances(1, jnp.float32))
    return jax.make_jaxpr(lambda x, u: solve_mixed(
        concar.problem(), b, x, u, theta=th, options=OPTS))(x1, u0)


@pytest.mark.parametrize("build", [_solve, _solve_batch,
                                   _solve_chunked_program, _mixed_phase1],
                         ids=["solve", "solve_batch", "solve_chunked",
                              "mixed_phase1"])
def test_every_dot_is_highest(build):
    precisions = list(dot_precisions(build().jaxpr))
    assert precisions, "no matrix product traced"
    low = [p for p in precisions if p != HIGHEST]
    assert not low, f"{len(low)} of {len(precisions)} products: {low[:3]}"
