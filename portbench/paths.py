"""Where the benchmark keeps what it builds: fixed directories under
``build/portbench/`` in the checkout (``build/`` is ignored by git), so
only the first run of a checkout builds the kernels."""

from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def kernel_cache() -> Path:
    """The program's kernel library (its ``DEER_COMPILE_CACHE``)."""
    return CACHE / "kernels"


def setup_env() -> None:
    """Point every build and kernel cache the program or its libraries
    may use into the checkout, before torch is imported."""
    os.environ["DEER_COMPILE_CACHE"] = str(kernel_cache())
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
