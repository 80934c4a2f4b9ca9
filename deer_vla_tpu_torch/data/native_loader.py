"""ctypes bindings for the native npz episode reader
(``deer_vla_tpu_torch/csrc/npz_reader.cpp``, a copy of the JAX package's
``native/npz_reader.cpp``; the JAX package's ``data/native_loader.py``).

Replaces per-frame ``np.load`` in the CALVIN window assembly
(data.py:660-685) with threaded C++ reads into a preallocated buffer.  The
library is built with g++ at first use (never at import) into
``build/torch_native/`` at the repository root.  A failed build falls back
to ``np.load``, as in the JAX package, but never silently: ``status()``
reports whether the library loaded, the build's error, and how many
windows each reader served (``count_window``, called by
``data/calvin.DiskCalvinDataset``).  STORED and DEFLATE
(``savez_compressed``) members are both read natively (zlib).

Two generations of API:
- v1 (``read_key`` / ``read_window``): one open and zip-directory scan per
  (file, key) for the probe and again for the read.
- v2 (``probe_keys`` / ``read_window_keys``): one mmap and one central
  directory parse per file serve every requested key; STORED payloads are
  copied out of the page cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "npz_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_counts = {"native_windows": 0, "numpy_windows": 0}

_DTYPES = {
    "<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
    "|u1": np.uint8, "<u1": np.uint8, "|i1": np.int8, "<f2": np.float16,
    "<u2": np.uint16, "<i2": np.int16, "|b1": np.bool_,
}


_STR, _PSTR, _PTR = ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), \
    ctypes.c_void_p
_PLONG, _PINT = ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)
# the C entry points (csrc/npz_reader.cpp) and their argument types
_SIGNATURES = {
    "npz_probe": [_STR, _STR, _PLONG, _PINT, _STR, _PLONG],
    "npz_read": [_STR, _STR, _PTR, ctypes.c_long],
    "npz_read_many": [_PSTR, ctypes.c_int, _STR, _PTR, ctypes.c_long,
                      ctypes.c_int],
    "npz_probe_keys": [_STR, _PSTR, ctypes.c_int, _PLONG, _PINT, _STR,
                       _PLONG],
    "npz_window_read_keys": [_PSTR, ctypes.c_int, _PSTR, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_void_p), _PLONG,
                             ctypes.c_int],
}


def _build() -> ctypes.CDLL:
    """Compile the reader (once per source digest) and load it."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libnpz_reader_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
        out = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp),
                              "-lz"], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{out.stderr}")
        os.replace(tmp, lib_path)  # concurrent builders never see half a file
    lib = ctypes.CDLL(str(lib_path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at the first call; None when the
    build failed (``status()["error"]`` says why)."""
    global _lib, _error
    if _lib is None and _error is None:
        with _lock:
            if _lib is None and _error is None:
                try:
                    _lib = _build()
                except (OSError, RuntimeError) as err:
                    _error = str(err)
    return _lib


def available() -> bool:
    return get_lib() is not None


def count_window(native: bool) -> None:
    """Record that one window was served by the native reader or by
    ``np.load``."""
    with _lock:
        _counts["native_windows" if native else "numpy_windows"] += 1


def reset_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0


def status() -> Dict:
    """{"available", "error", "native_windows", "numpy_windows"}: whether
    the library loaded (building it if it was not tried yet), the build's
    error, and the windows each reader served since the last
    ``reset_counts``."""
    ok = available()
    with _lock:
        return {"available": ok, "error": _error, **_counts}


def probe(path: str, key: str):
    """(shape, dtype, nbytes) or None if the native path can't serve it."""
    lib = get_lib()
    if lib is None:
        return None
    shape = (ctypes.c_long * 8)()
    ndim = ctypes.c_int()
    dtype = ctypes.create_string_buffer(8)
    nbytes = ctypes.c_long()
    rc = lib.npz_probe(path.encode(), key.encode(), shape,
                       ctypes.byref(ndim), dtype, ctypes.byref(nbytes))
    if rc != 0:
        return None
    dt = _DTYPES.get(dtype.value.decode())
    if dt is None:
        return None
    return tuple(shape[:ndim.value]), np.dtype(dt), int(nbytes.value)


def read_key(path: str, key: str) -> Optional[np.ndarray]:
    info = probe(path, key)
    if info is None:
        return None
    shape, dt, nbytes = info
    out = np.empty(nbytes, np.uint8)
    rc = get_lib().npz_read(path.encode(), key.encode(),
                            out.ctypes.data_as(ctypes.c_void_p), nbytes)
    if rc != 0:
        return None
    return out.view(dt).reshape(shape)


def probe_keys(path: str, keys: Sequence[str]):
    """One mmap and central-directory parse probing every key at once: a
    list of (shape, dtype, nbytes), or None."""
    lib = get_lib()
    if lib is None or not keys:
        return None
    n = len(keys)
    arr = (ctypes.c_char_p * n)(*[k.encode() for k in keys])
    shapes = (ctypes.c_long * (8 * n))()
    ndims = (ctypes.c_int * n)()
    dtypes = ctypes.create_string_buffer(8 * n)
    nbytes = (ctypes.c_long * n)()
    rc = lib.npz_probe_keys(path.encode(), arr, n, shapes, ndims, dtypes,
                            nbytes)
    if rc != 0:
        return None
    out = []
    for k in range(n):
        dt = _DTYPES.get(dtypes.raw[8 * k:8 * k + 8].split(b"\0")[0].decode())
        if dt is None:
            return None
        out.append((tuple(shapes[8 * k:8 * k + ndims[k]]), np.dtype(dt),
                    int(nbytes[k])))
    return out


def read_window_keys(paths: Sequence[str], keys: Sequence[str],
                     n_threads: int = 8) -> Optional[Dict[str, np.ndarray]]:
    """Every key stacked across a window of frame files, one file map and
    one zip-directory parse per file: {key: (len(paths), *shape)}, or None
    (the caller falls back)."""
    if not paths or not keys:
        return None
    infos = probe_keys(paths[0], keys)
    if infos is None:
        return None
    nf, nk = len(paths), len(keys)
    bufs = [np.empty((nf, info[2]), np.uint8) for info in infos]
    paths_c = (ctypes.c_char_p * nf)(*[p.encode() for p in paths])
    keys_c = (ctypes.c_char_p * nk)(*[k.encode() for k in keys])
    outs = (ctypes.c_void_p * nk)(
        *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
    item_nbytes = (ctypes.c_long * nk)(*[info[2] for info in infos])
    rc = get_lib().npz_window_read_keys(paths_c, nf, keys_c, nk, outs,
                                        item_nbytes, n_threads)
    if rc != 0:
        return None
    return {k: b.view(info[1]).reshape((nf,) + info[0])
            for k, b, info in zip(keys, bufs, infos)}


def read_window(paths: Sequence[str], key: str,
                n_threads: int = 8) -> Optional[np.ndarray]:
    """One key stacked across a window of frame files: (len(paths), *shape),
    or None (the caller falls back)."""
    if not paths:
        return None
    info = probe(paths[0], key)
    if info is None:
        return None
    shape, dt, nbytes = info
    n = len(paths)
    out = np.empty((n, nbytes), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = get_lib().npz_read_many(arr, n, key.encode(),
                                 out.ctypes.data_as(ctypes.c_void_p),
                                 nbytes, n_threads)
    if rc != 0:
        return None
    return out.view(dt).reshape((n,) + shape)
