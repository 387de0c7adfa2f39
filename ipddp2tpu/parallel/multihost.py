"""Multi-host entry: host-sharded instance generation over a global mesh.

The reference is single-process (SURVEY.md §2.3); this layer is new design.
Scaling across hosts follows the JAX SPMD recipe: every process runs this
same program, `jax.distributed.initialize` wires the processes into one
runtime, the mesh spans all hosts' devices, and each host materializes ONLY
its local shard of the instance batch (generation is by global index, so the
set of instances is independent of the process count). The solve itself is
`mesh.solve_sharded` unchanged — instances are embarrassingly parallel and
the only cross-host traffic is the psum/pmax convergence bookkeeping, which
rides ICI within a host and DCN across hosts.

Validated without a cluster by tests/test_multihost.py: two CPU processes x
4 virtual devices each, numerical parity against a single-process solve of
the same 8 instances.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..options import Options
from ..problem import Bounds, Problem
from .mesh import solve_sharded

Array = jax.Array


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           **kw) -> None:
    """Wire this process into the multi-host runtime (no-op if standalone).

    With no arguments, reads the standard JAX env/cluster autodetection
    (JAX_COORDINATOR_ADDRESS, cloud metadata, SLURM, ...)."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_sharded_instances(gen: Callable[[int], tuple], n_global: int,
                           mesh: Mesh, axis: str = "dp"):
    """Build globally-sharded instance arrays, generating only local shards.

    `gen(global_index) -> pytree` produces one instance's arrays (e.g.
    (bounds, x1, u0, theta)). Each process calls `gen` only for the global
    indices its addressable devices own, stacks them, and assembles global
    `jax.Array`s with `make_array_from_process_local_data` — generation cost
    and host memory scale 1/num_processes.
    """
    assert n_global % mesh.devices.size == 0, \
        "the device count must divide the global batch size"
    sharding = NamedSharding(mesh, P(axis))

    # global indices owned by this process, in device order
    per_dev = n_global // mesh.devices.size
    flat = list(mesh.devices.ravel())
    local_idx = [g for d in jax.local_devices()
                 for g in range(flat.index(d) * per_dev,
                                (flat.index(d) + 1) * per_dev)]

    examples = [gen(g) for g in local_idx]
    local = jax.tree.map(lambda *xs: jnp.stack(xs), *examples)
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            sharding, np.asarray(a)), local)


def solve_global(problem: Problem, gen: Callable[[int], tuple],
                 n_global: int, options: Optional[Options] = None,
                 mesh: Optional[Mesh] = None, axis: str = "dp"):
    """Host-sharded generate + sharded solve over the global mesh.

    `gen(i) -> (bounds, x1, u_init, theta)` for global instance i (theta may
    be None, but must be None for ALL i). Returns (Solution sharded over the
    batch axis, replicated BatchStats).
    """
    mesh = mesh or global_mesh(axis)
    bounds, x1, u0, theta = host_sharded_instances(
        gen, n_global, mesh, axis)
    return solve_sharded(problem, bounds, x1, u0, theta=theta,
                         options=options, mesh=mesh, axis=axis)
