"""Where XLA's persistent compilation cache lives.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set nothing here
overrides it. Otherwise the cache goes to `<checkout>/.jax_cache`, found from
this package's own location: a fixed path, so that one run finds what an
earlier run of the same checkout compiled.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return it."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
