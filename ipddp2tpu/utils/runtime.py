"""Process set-up shared by the measurement entry points (`bench.py`,
`chip_smoke.py`): the persistent compile cache, the accelerator check and
the record of the device a number was taken on."""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and no
    other directory is set. Otherwise the cache lives at the fixed path
    `<repo>/.jax_cache`: the path is part of the cache key, so a
    temporary or per-process directory would never hit."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    "unavailable". Runs in a child process, which never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "unavailable"


def device_record() -> dict:
    """The device a measurement ran on, as JAX reports it, plus the card's
    name and power limit from nvidia-smi."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": card_name_and_power_limit()}


def require_gpu() -> None:
    """Raise unless JAX's default device is a GPU: a measurement never falls
    back to the CPU silently."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's default device is {platform!r}")
