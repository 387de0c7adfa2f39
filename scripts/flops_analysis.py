"""FLOPs-per-iteration accounting for the speed-of-light (MFU) analysis.

Compiles one solver iteration (the XLA paths, which execute the same math
as the backward-sweep kernel) for batched concar and reads XLA's own HLO
cost analysis — the algorithmic FLOP count a utilization figure divides
by a measured device time. Runs on CPU; the count is backend-independent
(HLO-level).

Usage: python scripts/flops_analysis.py [batch ...]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=1"
                           ).strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from ipddp2tpu import Options
from ipddp2tpu.models import concar
from ipddp2tpu.problem import Bounds
from ipddp2tpu.solve import initialize, iteration

BATCHES = [int(a) for a in sys.argv[1:]] or [1, 64]


def flops_of(fn, *args):
    c = jax.jit(fn).lower(*args).compile()
    an = c.cost_analysis()
    if isinstance(an, list):
        an = an[0]
    return an.get("flops", float("nan"))


problem = concar.problem()
for batch in BATCHES:
    for dt_name, dtype, spec in (("f32", jnp.float32, 0),
                                 ("f64", jnp.float64, 8)):
        opts = Options(optimality_tolerance=1e-7, backward_kernel="xla",
                       ls_speculative=spec, ldlt_unroll=False)
        keys = jax.random.split(jax.random.PRNGKey(0), batch)
        thetas, f_lims, tau_lims, x1s = jax.vmap(
            lambda k: concar.random_instance(k))(keys)
        bounds = concar.bounds(f_lims, tau_lims)
        u0 = jnp.broadcast_to(concar.initial_controls(),
                              (batch, concar.T, concar.NU))
        cast = lambda a: (a.astype(dtype)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a)
        bounds, x1s, u0, thetas = jax.tree.map(
            cast, (bounds, x1s, u0, thetas))

        init = jax.vmap(
            lambda b, x, u, th: initialize(problem, th, b, x, u, opts),
            in_axes=(Bounds(0, 0), 0, 0, 0))
        state = init(bounds, x1s, u0, thetas)

        def one_iter(s, b, th):
            return jax.vmap(
                lambda si, bi, ti: iteration(problem, bi, si, ti, opts),
                in_axes=(0, Bounds(0, 0), 0))(s, b, th)

        f = flops_of(one_iter, state, bounds, thetas)
        print(f"b={batch} {dt_name} (ls_spec={spec}): "
              f"{f:.3e} flops/batch-iter = "
              f"{f / batch:.3e} per instance-iter", flush=True)
