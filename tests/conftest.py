"""Test configuration: an 8-device virtual CPU mesh and the shared
persistent compile cache.

The tier-1 suite runs on the CPU (`JAX_PLATFORMS=cpu`); sharding tests
use the virtual device mesh (SURVEY.md §4). Tests marked `gpu` need the
card and skip elsewhere (the `gpu` fixture decides at run time).
"""

import jax

from gmmloc.utils import jaxenv

jax.config.update("jax_num_cpu_devices", 8)
# the suite is dominated by jit compiles; repeat runs hit the cache
jaxenv.setup_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is the GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run with `python -m pytest -m gpu` on "
                    "the card)")
