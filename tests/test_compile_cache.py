"""utils/compile_cache.enable(): the package's only setter of the cache dir."""

import os
import subprocess
import sys

import jax

from onepiece_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_enable_honours_env_dir(tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_defaults_to_checkout_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable()
        assert got == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compiled_entry_lands_in_env_dir(tmp_path):
    """A fresh process with the variable set writes its executables there."""
    want = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(want), JAX_PLATFORMS="cpu")
    code = (
        "import jax, jax.numpy as jnp\n"
        "from onepiece_tpu.utils import compile_cache\n"
        "d = compile_cache.enable()\n"
        "jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()\n"
        "print(d)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str(want)
    assert os.listdir(want), "no executable was cached in JAX_COMPILATION_CACHE_DIR"
