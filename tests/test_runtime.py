"""The measurement entry points' process set-up (`utils/runtime.py`)."""

import os

import jax
import pytest

from ipddp2tpu.utils import runtime


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_defaults_to_repo_dir(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.configure_compile_cache()
    assert path == os.path.join(runtime.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isfile(os.path.join(runtime.REPO_ROOT, "bench.py"))


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
