"""Persistent XLA compile-cache wiring.

The reference pays no compile cost (ahead-of-time C++); this package pays
it in every fresh process. JAX's persistent compilation cache removes it
for every executable an earlier run with the same cache directory has
already compiled.

Call `enable()` before the first jit. It is the package's only setter of
the cache directory: tests/conftest.py, bench.py, chip_smoke.py and the CLI
tools (via tools/_common.py) call it.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Enable the persistent compile cache (idempotent). Returns the dir.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no
    other directory is set here. Otherwise the cache lives at the fixed
    path `<checkout>/.jax_cache` (listed in .gitignore): the path is part of
    the cache key, so a directory that moved would never hit.
    """
    import jax

    cache_dir = os.environ.get(ENV_VAR) or CHECKOUT_CACHE
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything: even sub-second executables add up across the suite
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
