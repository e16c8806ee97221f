"""Where JAX keeps its persistent compilation cache.

The device steps take seconds to minutes to compile cold, so every entry
point that compiles (the CLI's ``--jax`` path, ``chip_smoke.py``,
``bench.py``, ``__graft_entry__.py``) calls :func:`use_compile_cache`
before its first compile.  A ``JAX_COMPILATION_CACHE_DIR`` set from
outside wins; otherwise the cache lives at a fixed ``.jax_cache/`` in the
checkout root (listed in ``.gitignore``) — a fixed path, because the
path is part of what the cache is keyed on.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Leaves an externally set
    ``JAX_COMPILATION_CACHE_DIR`` alone (JAX reads it itself)."""
    external = os.environ.get(ENV_VAR)
    if external:
        return external
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
