"""Console reporting (the reference's L5 layer, src/print.jl:1-46).

Inside jit, per-iteration rows are emitted through `jax.debug.callback` —
the JAX analog of the reference's Printf-based table — rate-limited by
`print_frequency` like the reference (reference: src/options.jl:7,
src/print.jl:13-29). The wall/iter timing columns (reference:
src/print.jl:13-29 prints wall and solver ms) are stamped host-side when the
callback fires; on an async backend the callback flushes with device
execution, so they are accurate to the dispatch granularity.
"""

from __future__ import annotations

import time

import jax

from ..problem import STATUS_MESSAGES

_BANNER = r"""
 ipddp2tpu — interior-point DDP (IPDDP2, arXiv:2504.08278) in JAX
 stagewise equality constraints + control bounds | barrier + filter line search
"""

_HEADER = (" iter   objective     pr_inf    du_inf    cs_inf   lg(mu) "
           " lg(reg)   step    #ls  wall(ms)  iter(ms)")

# host-side timing state for the wall / per-iteration columns; reset by
# solver_banner() at the start of each verbose solve
_CLOCK = {"start": None, "last": None, "last_k": 0}


def solver_banner():
    print(_BANNER)
    print(_HEADER)
    _CLOCK["start"] = _CLOCK["last"] = time.perf_counter()
    _CLOCK["last_k"] = 0


def _row(k, objective, pr, du, cs, mu, reg, step, num_ls):
    import math

    now = time.perf_counter()
    if _CLOCK["start"] is None:          # logger used without the banner
        _CLOCK["start"] = _CLOCK["last"] = now
        _CLOCK["last_k"] = int(k)
    wall_ms = (now - _CLOCK["start"]) * 1e3
    dk = max(1, int(k) - _CLOCK["last_k"])
    iter_ms = (now - _CLOCK["last"]) * 1e3 / dk
    _CLOCK["last"], _CLOCK["last_k"] = now, int(k)

    lg = lambda v: math.log10(v) if v > 0 else float("-inf")
    print(f" {int(k):4d}  {float(objective): .4e}  {float(pr):.2e}  "
          f"{float(du):.2e}  {float(cs):.2e}  {lg(float(mu)):6.2f}  "
          f"{lg(float(reg)):6.2f}  {float(step):.1e}  {int(num_ls):3d}  "
          f"{wall_ms:8.1f}  {iter_ms:8.1f}")


def iteration_logger(state, options):
    """Emit one table row from inside a jitted iteration (host callback)."""
    jax.lax.cond(
        (state.k % options.print_frequency) == 0,
        lambda s: jax.debug.callback(
            _row, s.k, s.objective, s.primal_inf, s.dual_inf, s.cs_inf,
            s.mu, s.reg_last, s.step_size, s.num_ls),
        lambda s: None,
        state)


def exit_message(status: int, converged: bool) -> str:
    """(reference: src/print.jl:31-46)"""
    if converged:
        return STATUS_MESSAGES[0]
    return STATUS_MESSAGES.get(status, f"Terminated with status {status}")
