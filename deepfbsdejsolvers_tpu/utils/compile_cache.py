"""Where the persistent XLA compilation cache lives.

A cold compile of the N=50 training epoch takes tens of seconds; the cache
keys are HLO hashes, so a run that finds a warm cache skips them exactly.

* ``JAX_COMPILATION_CACHE_DIR`` set in the environment: JAX reads it itself
  and this module sets nothing.
* Otherwise: one fixed directory of the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``).  A fixed path, never a temporary directory, a
  process id or a time, so that every run of the entry points finds the
  same cache.
"""

from __future__ import annotations

import os
from typing import Mapping, Tuple

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir(environ: Mapping[str, str] = os.environ) -> Tuple[str, bool]:
    """(directory, from_env): the cache directory the entry points use and
    whether it came from ``JAX_COMPILATION_CACHE_DIR``."""
    if ENV_VAR in environ:
        return environ[ENV_VAR], True
    return DEFAULT_DIR, False


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return the directory.  Call before the first compilation."""
    path, from_env = cache_dir()
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
