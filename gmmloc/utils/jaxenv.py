"""Process set-up shared by every entry point: JAX's persistent
compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and
nothing here names another directory. Otherwise the cache goes to the
fixed path <checkout>/.jax_cache (listed in .gitignore): the path is part
of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The compile-cache directory this process uses."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at cache_dir(); call before
    the first compilation. Returns the directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path

