"""Persistent cache of the port's built kernels (the JAX package's
``utils/compile_cache.py``).

JAX's persistent compilation cache stores compiled XLA executables, so a
restarted host skips recompiling.  The port's compiled artifact is the
kernel library that ``ops/kernels/build.build_library`` builds with nvcc
and names by the digest of its sources and flags
(``libdeer_kernels_<digest>.so``): the cache is the directory it writes
and looks that library up in.  A host pointed at a directory that already
holds the library for its sources loads it without running nvcc.

Opt-in, as in JAX: the DEER_COMPILE_CACHE environment variable (a
directory) or an explicit ``enable_compile_cache(path)``; every CLI main
calls ``maybe_enable_compile_cache()`` through ``utils/errors.record``.
Unset, the library lives in ``build/torch_kernels/`` at the repository
root.  Nothing here probes for nvcc or builds: the first kernel launch on
a CUDA tensor does.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_ENV = "DEER_COMPILE_CACHE"


class _Cache:
    path: Optional[Path] = None


def enable_compile_cache(path: str, min_compile_secs: float = 1.0) -> str:
    """Make ``path`` (created if missing) the directory the kernel library
    is built into and loaded from.  ``min_compile_secs`` is accepted for
    the JAX signature and has no effect: the cache holds one library,
    and every build of it is an nvcc build of all the sources."""
    del min_compile_secs
    path = Path(path).expanduser().resolve()
    path.mkdir(parents=True, exist_ok=True)
    _Cache.path = path
    return str(path)


def maybe_enable_compile_cache() -> Optional[str]:
    """Enable the cache iff DEER_COMPILE_CACHE is set; returns the dir."""
    path = os.environ.get(_ENV, "").strip()
    if not path:
        return None
    return enable_compile_cache(path)


def cache_dir() -> Optional[Path]:
    """The enabled cache directory, or None."""
    return _Cache.path
