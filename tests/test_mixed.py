"""Mixed-precision continuation must certify the same optimum as pure f64."""

import numpy as np

from ipddp2tpu import Options
from ipddp2tpu.mixed import solve_mixed
from ipddp2tpu.models import concar, double_integrator as di
import pytest


def test_mixed_double_integrator():
    sol = solve_mixed(di.problem(), di.bounds(), di.initial_state(),
                      di.initial_controls(),
                      options=Options(optimality_tolerance=1e-7))
    assert bool(sol.converged), int(sol.status)
    np.testing.assert_allclose(float(sol.objective), di.GOLDEN_OBJECTIVE,
                               rtol=1e-6)
    assert float(sol.dual_inf) < 1e-7


def test_mixed_concar():
    theta, f_lim, tau_lim, x1 = concar.seed1_instance()
    sol = solve_mixed(concar.problem(), concar.bounds(f_lim, tau_lim), x1,
                      concar.initial_controls(), theta=theta,
                      options=Options(optimality_tolerance=1e-7))
    assert bool(sol.converged), int(sol.status)
    # a 1e-7-KKT point within 1e-4 of the golden objective (the scaled dual
    # tolerance admits ~1e-5 objective spread on this L1-slack problem)
    np.testing.assert_allclose(float(sol.objective),
                               concar.SEED1_GOLDEN_OBJECTIVE, rtol=1e-4)
    assert float(sol.dual_inf) < 1e-7
    # total = f32 phase (~95) + short f64 endgame (~6)
    assert int(sol.iterations) < 130, int(sol.iterations)


@pytest.mark.slow
def test_mixed_chunked_phase2_compaction():
    """Endgame compaction (the bench's f64-phase batch shrinking) must
    certify the same instances to the same optima as the lockstep endgame."""
    import jax
    import jax.numpy as jnp

    from ipddp2tpu.mixed import solve_mixed_chunked

    opts = Options(optimality_tolerance=1e-7, max_iterations=600)
    n = 8
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    thetas, f_lims, tau_lims, x1s = jax.vmap(concar.random_instance)(keys)
    bounds = concar.bounds(f_lims, tau_lims)
    u0 = jnp.broadcast_to(concar.initial_controls(),
                          (n, concar.T, concar.NU))
    base = solve_mixed_chunked(concar.problem(), bounds, x1s, u0,
                               theta=thetas, options=opts, chunk=40,
                               phase2_max_iterations=40, batched=True)
    comp = solve_mixed_chunked(concar.problem(), bounds, x1s, u0,
                               theta=thetas, options=opts, chunk=40,
                               phase2_max_iterations=40, phase2_chunk=5,
                               phase2_compact=(4, 2), batched=True)
    # seed-4 instance 5 burns the whole 600-iteration budget in phase 1
    # (f32-stalled) in BOTH configurations — compaction must agree with
    # lockstep on which instances certify, and on their optima
    conv = np.asarray(base.converged)
    np.testing.assert_array_equal(np.asarray(comp.converged), conv)
    assert conv.sum() >= 6, np.asarray(base.status)
    np.testing.assert_allclose(np.asarray(comp.objective)[conv],
                               np.asarray(base.objective)[conv], rtol=2e-4)
    assert float(np.max(np.asarray(comp.dual_inf)[conv])) < 1e-7


@pytest.mark.slow
def test_mixed_chunked_restart_rescue():
    """rescue_failed="restart" must recover f32-stalled instances by
    re-solving them from scratch in pure f64 as a compacted batch — the
    success-parity mechanism of the bench's success rung."""
    import jax
    import jax.numpy as jnp

    from ipddp2tpu.mixed import solve_mixed_chunked

    opts = Options(optimality_tolerance=1e-7, max_iterations=600)
    n = 8
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    thetas, f_lims, tau_lims, x1s = jax.vmap(concar.random_instance)(keys)
    bounds = concar.bounds(f_lims, tau_lims)
    u0 = jnp.broadcast_to(concar.initial_controls(),
                          (n, concar.T, concar.NU))
    # abandoning config: seed-4 instance 5 stalls in f32 and is denied the
    # endgame
    deny = solve_mixed_chunked(concar.problem(), bounds, x1s, u0,
                               theta=thetas, options=opts, chunk=40,
                               phase2_max_iterations=40,
                               rescue_failed=False, batched=True)
    conv_deny = np.asarray(deny.converged)
    assert not conv_deny.all(), "expected at least one f32-stalled instance"
    resc, info = solve_mixed_chunked(concar.problem(), bounds, x1s, u0,
                                     theta=thetas, options=opts, chunk=40,
                                     phase2_max_iterations=40,
                                     rescue_failed="restart",
                                     rescue_max_iterations=1000,
                                     phase2_compact=(4, 2), batched=True,
                                     return_info=True)
    conv = np.asarray(resc.converged)
    # every instance certifies, healthy ones to the same optima as before
    assert conv.all(), np.asarray(resc.status)
    np.testing.assert_allclose(np.asarray(resc.objective)[conv_deny],
                               np.asarray(deny.objective)[conv_deny],
                               rtol=1e-9)
    assert float(np.max(np.asarray(resc.dual_inf))) < 1e-7
    # the info dict attributes every failure path: the denied instances
    # appear as p2 failures and as rescue indices, and the rescue solved them
    assert set(info) == {"p1", "p2", "rescue"}
    p2_failed = np.where(~info["p2"]["converged"])[0]
    np.testing.assert_array_equal(info["rescue"]["indices"], p2_failed)
    np.testing.assert_array_equal(p2_failed, np.where(~conv_deny)[0])
    assert info["rescue"]["converged"].all()
    # the rescue honored its own (reference-level) iteration budget
    assert int(info["rescue"]["k"].max()) <= 1000


@pytest.mark.kernels
def test_mixed_chunked_with_sweep_kernel_hits_golden(interpret_kernel):
    """The batched mixed solve with the backward-sweep kernel forced (both
    phases, so the f64 endgame runs it) certifies the golden
    double_integrator optimum."""
    import jax.numpy as jnp

    from ipddp2tpu import Bounds
    from ipddp2tpu.mixed import solve_mixed_chunked

    batch = 2
    bounds = di.bounds()
    bb = Bounds(*(jnp.broadcast_to(a, (batch,) + a.shape) for a in bounds))
    x1 = jnp.broadcast_to(di.initial_state(), (batch, di.NX))
    u0 = jnp.broadcast_to(di.initial_controls(), (batch,) + (di.T, di.NU))
    sol = solve_mixed_chunked(
        di.problem(), bb, x1, u0,
        options=Options(optimality_tolerance=1e-7,
                        backward_kernel="pallas"),
        chunk=40, batched=True)
    assert np.asarray(sol.converged).all(), np.asarray(sol.status)
    np.testing.assert_allclose(np.asarray(sol.objective),
                               di.GOLDEN_OBJECTIVE, rtol=1e-6)
    assert float(np.max(np.asarray(sol.dual_inf))) < 1e-7
