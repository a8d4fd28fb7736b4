"""The persistent compile cache is placed from outside or at a fixed
checkout path (svtrek_tpu/compile_cache.py)."""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import pytest

from svtrek_tpu.compile_cache import CHECKOUT, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_dir_is_used(monkeypatch, tmp_path, restore_cache_dir):
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_default_dir_is_absolute_checkout_path(monkeypatch, tmp_path,
                                               restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    path = enable_compile_cache()
    assert os.path.isabs(path)
    assert path == os.path.join(REPO, ".jax_cache") == os.path.join(
        CHECKOUT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compiles_land_in_env_dir(tmp_path):
    """A fresh process that compiles after enable_compile_cache writes
    its cache entries into $JAX_COMPILATION_CACHE_DIR."""
    cache = tmp_path / "cache"
    code = (
        "from svtrek_tpu.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "import jax, jax.numpy as jnp\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
