"""bench.py and chip_smoke.py as a user runs them.

Both are measurement entry points for the GPU: without one they exit
nonzero and print no result, rather than measuring the CPU silently.
`bench.py --cpu` is the explicit rehearsal on the CPU.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(HERE, "bench.py")
SMOKE = os.path.join(HERE, "chip_smoke.py")
CPU_ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def _run(args, cwd=HERE, timeout=300):
    return subprocess.run([sys.executable, *args], env=CPU_ENV, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.slow
def test_bench_cpu_rehearsal_end_to_end():
    out = _run([BENCH, "--cpu", "--batch", "8", "--reps", "1"],
               timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    assert all(l["device"]["platform"] == "cpu" for l in lines)
    d = lines[-1]
    assert d["unit"] == "ocps_per_s_per_device"
    assert d["value"] > 0, d
    assert d["detail"]["best"]["solved"] >= 6
    assert d["detail"]["success"]["solved"] >= d["detail"]["best"]["solved"]


def test_bench_exits_nonzero_without_gpu():
    out = _run([BENCH, "--batch", "4", "--reps", "1"])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def test_chip_smoke_exits_nonzero_without_gpu():
    out = _run([SMOKE])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Without the rest of the repository there is nothing to smoke."""
    shutil.copy(SMOKE, tmp_path)
    out = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
