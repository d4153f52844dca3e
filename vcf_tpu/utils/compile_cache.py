"""Where the persistent XLA compile cache lives.

A compiled program is found again only under the same path, so the
path is fixed: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it
itself, and nothing here overrides it), else `.jax_cache` beside the
package, inside the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
