"""Persistent XLA compilation cache for the repository's scripts.

Compiling the flagship fit takes tens of seconds on a GPU; the persistent
cache lets a later process (or a later script of the same command) reuse
what an earlier one compiled.  Scripts call :func:`enable_compile_cache`
once at start-up; the library never calls it on import, and the test suite
does not use it.
"""

from __future__ import annotations

import os

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'

#: the checkout holding this package; the default cache lives beside it
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed.  Otherwise the cache is ``<checkout>/.jax_cache``:
    a fixed path, because the path is part of what a cache entry is found
    by.  The variable is exported too, so child processes share the cache.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax
    path = os.path.join(CHECKOUT, '.jax_cache')
    os.environ[ENV_VAR] = path
    jax.config.update('jax_compilation_cache_dir', path)
    return path
