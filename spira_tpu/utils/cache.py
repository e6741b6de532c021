"""One persistent compile cache for every entry point.

Compiles of the full renders take minutes cold, so the CLI, ``bench.py``,
``chip_smoke.py`` and the benchmark scripts keep XLA's compiled programs in
JAX's persistent cache.  ``JAX_COMPILATION_CACHE_DIR``, when set, names the
directory and JAX reads it itself; otherwise the cache lives at a fixed
path inside the checkout (``<repo>/.jax_cache``, gitignored).  The path is
part of what a later run must find again, so it is never derived from a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

#: The checkout's own cache directory, used when the variable is unset.
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
