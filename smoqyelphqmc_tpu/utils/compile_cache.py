"""Placement of JAX's persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import jax

# <checkout>/.jax_cache (listed in .gitignore). A fixed path: a cache
# directory that moves between runs never hits.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Optional[str]:
    """Turn on the persistent compilation cache; returns the directory set here.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set in code (returns None). A directory already configured in this process
    is left as it is. Otherwise the cache goes to DEFAULT_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
