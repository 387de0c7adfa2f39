"""Multi-host validation without a cluster: two CPU
processes x 4 virtual devices = an 8-device global mesh, host-sharded
instance generation, numerical parity against a single-process solve of the
same instances (BASELINE.md north star: multi-host scaling path exists and
is semantically transparent)."""

import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_parity():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    out = os.path.join(tempfile.mkdtemp(), "mh.npz")

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_driver.py"),
             coordinator, "2", str(pid), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"driver failed:\n{o[-3000:]}"
    assert "driver ok" in outs[0]

    got = np.load(out)
    assert got["num_instances"] == 8
    assert got["converged"].all(), got["iterations"]
    assert got["num_converged"] == 8

    # same instances solved in-process (this test session is already a
    # single-process 8-virtual-device CPU runtime via conftest)
    from ipddp2tpu import Options
    from ipddp2tpu.batch import solve_batch
    from ipddp2tpu.models import concar

    insts = [concar.random_instance(jax.random.PRNGKey(1000 + i))
             for i in range(8)]
    thetas = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[t for t, _, _, _ in insts])
    bounds = concar.bounds(jnp.stack([f for _, f, _, _ in insts]),
                           jnp.stack([t for _, _, t, _ in insts]))
    x1s = jnp.stack([x for _, _, _, x in insts])
    u0 = jnp.broadcast_to(concar.initial_controls(), (8,) + (concar.T, concar.NU))
    sol = solve_batch(concar.problem(), bounds, x1s, u0, theta=thetas,
                      options=Options(optimality_tolerance=1e-7,
                                      max_iterations=300))

    np.testing.assert_allclose(got["objective"], np.asarray(sol.objective),
                               rtol=1e-9)
    assert np.asarray(sol.converged).all()
