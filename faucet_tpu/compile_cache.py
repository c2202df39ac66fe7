"""Persistent XLA compile cache shared by the CLI, bench.py and
chip_smoke.py.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here changes. Otherwise the cache lives at a fixed directory inside the
checkout (listed in .gitignore): the path is part of the cache key, so a
directory named after a temp file, a PID or a time would never hit.
"""
from __future__ import annotations

import os
from typing import Mapping

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """The directory the compile cache uses under `environ`."""
    return environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at cache_dir(); call before
    the first compile. Returns the directory."""
    path = cache_dir()
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
