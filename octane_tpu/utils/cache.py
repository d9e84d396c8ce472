"""JAX persistent compilation cache location.

A full-disk program takes tens of seconds to compile, so every entry point
(the CLI, bench.py, chip_smoke.py and the tools) keeps compiled executables
across processes.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here; otherwise the cache lives at a fixed path
in the checkout, so that every process of one checkout finds the same
cache.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
