"""The backward-sweep kernel against the vmapped `lax.scan` sweep on the
bench's full headline solve, on one GPU.

Both sides solve the same instance set with the bench's headline
configuration; `backward_kernel` ("pallas" or "xla") is the only
difference. One warm (compiling) solve each, scan then kernel, then one
timed solve each in the mirrored order, kernel then scan: about 16
minutes at b2048 on an H100. One JSON line per solve, then a summary;
every line names the device. One sweep in isolation is timed by
`chip_smoke.py`'s kernel phase.

    python scripts/kernel_vs_scan.py [--batch 2048] [--tol 1e-7]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--tol", type=float, default=1e-7)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    import bench
    from ipddp2tpu.batch import batch_stats
    from ipddp2tpu.models import concar
    from ipddp2tpu.utils.runtime import (configure_compile_cache,
                                         device_record, require_gpu)

    require_gpu()
    configure_compile_cache()
    device = device_record()
    problem = concar.problem()
    options = {k: bench.headline_options(args.tol, backward_kernel=k)
               for k in ("xla", "pallas")}
    warm = bench.make_instances(args.batch, 1000)
    instances = bench.make_instances(args.batch, 1001)

    def run(kernel, inst):
        t0 = time.perf_counter()
        sol = bench.solve_headline(problem, inst, options[kernel])
        np.asarray(sol.converged)
        wall = time.perf_counter() - t0
        stats = batch_stats(sol)
        return {"kernel": kernel, "wall_s": wall,
                "solved": int(stats.num_converged),
                "median_iterations": float(stats.median_iterations),
                "objective": np.where(np.asarray(sol.converged),
                                      np.asarray(sol.objective), np.nan)}

    for kernel in ("xla", "pallas"):
        r = run(kernel, warm)
        r.pop("objective")
        print(json.dumps({"warm": True, **r, "device": device}), flush=True)
    walls, solved, objs = {}, {}, {}
    for kernel in ("pallas", "xla"):
        r = run(kernel, instances)
        walls[kernel] = r["wall_s"]
        solved[kernel] = r["solved"]
        objs[kernel] = r.pop("objective")
        print(json.dumps({**r, "batch": args.batch, "device": device}),
              flush=True)
    # instances both sides certified
    both = np.isfinite(objs["xla"]) & np.isfinite(objs["pallas"])
    rel = np.abs(objs["pallas"] - objs["xla"]) / np.abs(objs["xla"])
    print(json.dumps({
        "summary": "kernel vs scan, headline solve",
        "batch": args.batch, "wall_s": walls, "solved": solved,
        "kernel_faster": walls["pallas"] < walls["xla"],
        "max_objective_rel_diff": float(np.max(rel[both], initial=0.0)),
        "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
