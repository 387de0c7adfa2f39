"""Headline benchmark: batched concar instances solved to KKT tolerance.

Run on the GPU:

    python bench.py [--batch 2048] [--reps 3] [--tol 1e-7]

One process runs the plan: an unreported warm solve (compilation), the
headline reps, then one success rep. It prints one JSON line per solve and
a summary line last; every line names the device it ran on. Without a GPU
it exits nonzero, unless `--cpu` asks for a rehearsal on the CPU, whose
lines say so.

Two rungs:
  * headline (throughput-max): b2048 mixed f32->f64 continuation with the
    hybrid line search; instances whose f32 phase stalls are abandoned and
    reported unsolved.
  * success: the same, but f32-stalled instances are re-solved from scratch
    in f64 as a compacted batch (rescue_failed="restart"); the reference
    solves concar 100/100.

Baseline: the reference solves one concar instance in a median 121.4 ms
single-threaded (BASELINE.md), 8.24 OCPs/s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

REFERENCE_MEDIAN_WALL_S = 0.1214  # BASELINE.md concar IPDDP2 median

# The certified headline configuration. Phase 1 (f32) and phase 2 (f64)
# both take the largest acceptable step of the backtracking sequence
# (hybrid line search: K speculative candidates, then sequential
# backtracking below 2^-K), so the accept semantics are the reference's.
CHUNK = 40
PHASE1_LS_SPECULATIVE = 4
PHASE2_LS_SPECULATIVE = 8
PHASE2_MAX_ITERATIONS = 40
PHASE2_CHUNK = 8
RESCUE_MAX_ITERATIONS = 1000    # the reference's max_iter (src/options.jl:5)


def headline_options(tol: float, **overrides):
    from ipddp2tpu import Options

    return Options(**{"optimality_tolerance": tol, "max_iterations": 600,
                      "ldlt_unroll": False,
                      "ls_speculative": PHASE1_LS_SPECULATIVE,
                      "ls_spec_continue": True, **overrides})


def make_instances(batch: int, seed: int):
    """(bounds, x1s, u0, thetas) of `batch` random concar instances."""
    import jax
    import jax.numpy as jnp

    from ipddp2tpu.models import concar

    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    thetas, f_lims, tau_lims, x1s = jax.vmap(concar.random_instance)(keys)
    u0 = jnp.broadcast_to(concar.initial_controls(),
                          (batch, concar.T, concar.NU))
    return concar.bounds(f_lims, tau_lims), x1s, u0, thetas


def solve_headline(problem, instances, options, rescue_failed=False,
                   return_info=False):
    """The bench's mixed-precision solve of one batch of instances."""
    from ipddp2tpu.mixed import solve_mixed_chunked

    bounds, x1s, u0, thetas = instances
    batch = int(x1s.shape[0])
    compact = tuple(s for s in (batch // 2, batch // 4, batch // 8,
                                batch // 16) if s >= 64) or False
    return solve_mixed_chunked(
        problem, bounds, x1s, u0, theta=thetas, options=options,
        chunk=CHUNK, phase2_max_iterations=PHASE2_MAX_ITERATIONS,
        phase2_ls_speculative=PHASE2_LS_SPECULATIVE,
        rescue_failed=rescue_failed,
        rescue_max_iterations=RESCUE_MAX_ITERATIONS,
        phase2_chunk=PHASE2_CHUNK, phase2_compact=compact,
        batched=True, return_info=return_info)


def _median_rep(reps):
    """The rep with the median value (keeps value and detail paired)."""
    byv = sorted(reps, key=lambda r: r["value"])
    return byv[(len(byv) - 1) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (numbers are not device "
                         "measurements)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from ipddp2tpu.batch import batch_stats
    from ipddp2tpu.models import concar
    from ipddp2tpu.utils.runtime import (configure_compile_cache,
                                         device_record, require_gpu)

    if not args.cpu:
        require_gpu()
    configure_compile_cache()
    device = device_record()
    problem = concar.problem()
    options = headline_options(args.tol)

    plan = ["warm"] + ["mixed"] * max(1, args.reps) + ["mixedr"]
    reps = {"mixed": [], "mixedr": []}
    for i, mode in enumerate(plan):
        seed = 1000 + i
        instances = make_instances(args.batch, seed)
        t0 = time.perf_counter()
        sol = solve_headline(problem, instances, options,
                             rescue_failed="restart" if mode == "mixedr"
                             else False)
        np.asarray(sol.converged)
        wall = time.perf_counter() - t0
        stats = batch_stats(sol)
        solved = int(stats.num_converged)
        line = {"value": solved / wall, "warm": mode == "warm",
                "detail": {"batch": args.batch,
                           "mode": "mixed" if mode == "warm" else mode,
                           "solved": solved, "seed": seed, "rep": i,
                           "wall_s": wall, "tol": args.tol,
                           "median_iterations":
                               float(stats.median_iterations),
                           "max_iterations": int(stats.max_iterations)},
                "device": device}
        print(json.dumps(line), flush=True)
        if mode != "warm":
            reps[mode].append(line)

    best = _median_rep(reps["mixed"])
    succ = reps["mixedr"][0]
    baseline = 1.0 / REFERENCE_MEDIAN_WALL_S
    print(json.dumps({
        "metric": "concar OCPs solved to KKT tol per second per device",
        "value": best["value"],
        "unit": "ocps_per_s_per_device",
        "vs_baseline": best["value"] / baseline,
        "detail": {"best": best["detail"],
                   "reps": [r["value"] for r in reps["mixed"]],
                   "success": succ["detail"],
                   "success_ocps_per_s": succ["value"],
                   "baseline_ocps_per_s": baseline},
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
