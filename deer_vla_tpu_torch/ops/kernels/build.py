"""Build and load the port's CUDA kernels.

The sources under ``deer_vla_tpu_torch/csrc/`` have a plain C interface.
``nvcc`` compiles each one to an object file (all compiles start together),
links them into one shared library under ``build/torch_kernels/`` at the
repository root, and ``ctypes`` loads it.  Nothing here runs at import time:
the first wrapper call on a CUDA tensor builds the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
           "indexed_matmul.cu", "indexed_matmul_quant.cu")
HEADERS = ("hopper_mma.cuh",)  # included by the sources; part of the digest
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


class _Loaded:
    """The loaded library and what its build reported (one per process)."""
    lib: Optional[ctypes.CDLL] = None
    functions: Dict[str, ctypes._CFuncPtr] = {}
    build_seconds: float = 0.0
    build_log: str = ""


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile every source in parallel and link one shared library.  A
    library already built from the same sources and flags is reused."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libdeer_kernels_{_source_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs: List[subprocess.Popen] = []
    objs = []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + f".{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    failed = []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp),
                           "-lcudart"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    for obj in objs:
        obj.unlink()
    _Loaded.build_seconds = time.perf_counter() - t0
    _Loaded.build_log = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    if _Loaded.lib is None:
        _Loaded.lib = ctypes.CDLL(str(build_library()))
    return _Loaded.lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (pointers and the stream as c_void_p so ctypes never truncates them)."""
    fn = _Loaded.functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _Loaded.functions[name] = fn
    return fn


def build_info() -> dict:
    """Seconds the build took in this process (0 if it was reused) and the
    compiler's per-kernel register / shared-memory report."""
    return {"seconds": _Loaded.build_seconds, "log": _Loaded.build_log}
