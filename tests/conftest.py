"""Test configuration: CPU with an 8-device virtual mesh unless told otherwise.

The tests run on the CPU (`JAX_PLATFORMS=cpu`, the default set here);
multi-device sharding paths (parallel/) run on a virtual CPU mesh via
--xla_force_host_platform_device_count, per the multi-host test strategy in
SURVEY.md §4. Tests marked `gpu` need an NVIDIA card and skip elsewhere;
on a machine with one they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_ENABLE_X64", "0")

# persistent compile cache: a warm suite run skips ~all XLA compiles (the
# dominant cost of the compile-heavy system/parallel tests on CPU)
from onepiece_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu")
