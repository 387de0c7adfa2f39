"""chip_smoke.py's phases at a tiny size on the CPU.

On the CPU the kernel runs in the Pallas interpreter and the times mean
nothing; what these tests pin is that every phase drives its path and
checks what it claims to check.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ipddp2tpu import Bounds, Options  # noqa: E402
from ipddp2tpu.models import concar  # noqa: E402
from ipddp2tpu.solve import initialize  # noqa: E402
from test_backward_pallas import random_inputs, tiny_problem  # noqa: E402


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()


@pytest.mark.kernels
def test_kernel_phase_tiny(interpret_kernel):
    problem = tiny_problem(nc=2)
    states = {}
    for name, dt in (("float32", jnp.float32), ("float64", jnp.float64)):
        x, u, *_ = random_inputs(problem, jax.random.PRNGKey(2), 6, dt)
        bounds = Bounds(jnp.full(u.shape, -2.0, dt),
                        jnp.full(u.shape, 2.0, dt))
        state = jax.vmap(lambda b, x1, u0: initialize(
            problem, None, b, x1, u0, Options()),
            in_axes=(Bounds(0, 0), 0, 0))(bounds, x[:, 0], u)
        states[name] = (state, None)
    out = chip_smoke.phase_kernel(problem, states, reps=1)
    for name in states:
        assert out[name]["max_rel_err"] <= chip_smoke.PARITY_RTOL[name]
        assert {"costate_seq", "costate_assoc"} <= set(out[name])


def test_compare_sweeps_catches_differences():
    from ipddp2tpu.backward import Gains

    g = Gains(*[np.ones((3, 2, 2)) for _ in Gains._fields])
    ok = (g, np.ones(3), np.zeros(3, bool), np.zeros(3, bool))
    assert chip_smoke.compare_sweeps(ok, ok, 1e-12)[0] == 0.0
    off = (g._replace(beta=g.beta * (1 + 1e-6)),) + ok[1:]
    with pytest.raises(AssertionError, match="kernel vs scan"):
        chip_smoke.compare_sweeps(off, ok, 1e-10)
    flagged = ok[:2] + (np.array([True, False, False]), ok[3])
    with pytest.raises(AssertionError, match="fail flags differ"):
        chip_smoke.compare_sweeps(flagged, ok, 1e-10)


def test_agreement_rule():
    """Pairs both certified agree to 1e-4, but for at most MAX_SPLITS on
    other local optima (either side the lower); uncertified pairs do not
    count, and no certified pair at all fails."""
    n, k = 64, chip_smoke.MAX_SPLITS
    b = np.linspace(1.0, 5.0, n)
    conv = np.ones(n, bool)
    a = b * (1 + 1e-5)
    chip_smoke.check_agreement(a, conv, b, conv)
    a[:k] = b[:k] * np.where(np.arange(k) % 2, 1.2, 0.8)
    chip_smoke.check_agreement(a, conv, b, conv)
    a[k] = b[k] * 1.01
    with pytest.raises(AssertionError, match="other optima"):
        chip_smoke.check_agreement(a, conv, b, conv)
    off = conv.copy()
    off[k] = False
    chip_smoke.check_agreement(a, off, b, conv)
    with pytest.raises(AssertionError, match="no instance"):
        chip_smoke.check_agreement(a, np.zeros(n, bool), b, conv)


def test_main_and_agreement_phases_tiny():
    problem = concar.problem()
    instances, sol = chip_smoke.phase_main(problem, batch=4)
    assert np.asarray(sol.converged).sum() >= 2
    chip_smoke.phase_agreement(problem, instances, sol, n=4)


def test_four_cards_phase_on_virtual_devices():
    chip_smoke.phase_four_cards(concar.problem(), per_card=1,
                                devices=jax.devices()[:4])
