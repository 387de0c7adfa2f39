"""Profiling hooks (SURVEY.md §5 tracing/profiling plan).

The reference hand-rolls wall/solver/fn-eval timers (reference:
src/solve.jl:19,41-43,86-87); the JAX equivalents are `jax.profiler`
traces viewable in XProf/TensorBoard plus host-side block timers.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace for the enclosed block:

        with profiling.trace("/tmp/ipddp2-trace"):
            sol = solve(...)
            np.asarray(sol.converged)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class BlockTimer:
    """Host-side timer that forces device completion at exit (async backends
    only block on host reads, so callers pass the arrays to materialize)."""

    def __init__(self):
        self.seconds = 0.0

    @contextlib.contextmanager
    def __call__(self, *arrays_to_block_on):
        import numpy as np

        t0 = time.time()
        yield
        for a in arrays_to_block_on:
            np.asarray(a)
        self.seconds += time.time() - t0
