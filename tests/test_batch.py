"""Batched and sharded solving: vmap over instances, shard_map over the
8-virtual-device CPU mesh (the multi-chip analog of a fake backend,
SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np

from ipddp2tpu import Bounds, Options, solve
from ipddp2tpu.batch import batch_stats, solve_batch
from ipddp2tpu.models import concar
from ipddp2tpu.parallel import make_mesh, solve_sharded

OPTS = Options(optimality_tolerance=1e-6, max_iterations=600)


def _concar_batch(n, key=0):
    keys = jax.random.split(jax.random.PRNGKey(key), n)
    thetas, f_lims, tau_lims, x1s = jax.vmap(concar.random_instance)(keys)
    bounds = concar.bounds(f_lims, tau_lims)
    u0 = jnp.broadcast_to(concar.initial_controls(),
                          (n, concar.T, concar.NU))
    return thetas, bounds, x1s, u0


def test_vmap_batch_concar():
    n = 4
    thetas, bounds, x1s, u0 = _concar_batch(n)
    sol = solve_batch(concar.problem(), bounds, x1s, u0, theta=thetas,
                      options=OPTS)
    assert sol.converged.shape == (n,)
    stats = batch_stats(sol)
    assert int(stats.num_converged) == n, np.asarray(sol.status)
    assert float(stats.max_primal_inf) < 1e-6


def test_batch_matches_single():
    n = 3
    thetas, bounds, x1s, u0 = _concar_batch(n, key=7)
    batched = solve_batch(concar.problem(), bounds, x1s, u0, theta=thetas,
                          options=OPTS)
    one = solve(concar.problem(),
                jax.tree.map(lambda a: a[1], bounds),
                x1s[1], u0[1],
                theta=jax.tree.map(lambda a: a[1], thetas), options=OPTS)
    np.testing.assert_allclose(float(batched.objective[1]),
                               float(one.objective), rtol=1e-10)
    assert int(batched.iterations[1]) == int(one.iterations)


def test_shard_map_pallas_megakernel():
    """The backward-sweep kernel dispatches *inside* shard_map (sharded
    batch + fused backward) and the program type-checks under
    `solve_sharded`'s check_vma: the sharded solve with the kernel forced
    is traced and lowered for CUDA here (the CPU cannot run the Triton
    kernel, and the interpreter does not type-check under check_vma).
    Parity of the sharded solve on GPUs is `chip_smoke.py --four-cards`."""
    from ipddp2tpu.models import double_integrator as di

    n = 2 * len(jax.devices())
    x1 = di.initial_state() + 0.1 * jax.random.normal(
        jax.random.PRNGKey(11), (n, di.NX))
    u0 = jnp.broadcast_to(di.initial_controls(), (n, di.T, di.NU))
    b = di.bounds()
    bounds = Bounds(*(jnp.broadcast_to(a, (n,) + a.shape) for a in b))
    opts5 = Options(optimality_tolerance=1e-12, max_iterations=5,
                    backward_kernel="pallas")
    sharded = jax.jit(solve_sharded, static_argnames=("problem", "options",
                                                       "mesh"))
    lowered = sharded.trace(di.problem(), bounds, x1, u0, options=opts5,
                            mesh=make_mesh()).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "backward_sweep" in text and "triton" in text
    assert "all-reduce" in text or "all_reduce" in text


def test_shard_map_mesh():
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest should provide 8 virtual CPU devices"
    n = 2 * n_dev
    thetas, bounds, x1s, u0 = _concar_batch(n, key=3)
    sol, stats = solve_sharded(concar.problem(), bounds, x1s, u0,
                               theta=thetas, options=OPTS,
                               mesh=make_mesh())
    assert int(stats.num_instances) == n
    assert int(stats.num_converged) >= n - 1
    assert sol.converged.shape == (n,)
