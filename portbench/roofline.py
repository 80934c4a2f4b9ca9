"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit) and the operations and bytes of the port's kernels,
from the shapes a launch was called with (the kernels' ``observer``
hooks).  A launch's least time is the larger of its operations over the
peak and its bytes over the bandwidth; each input byte is counted read
once and each output byte written once.  The arithmetic is
``chip_smoke.py``'s (``bound``, the K1 and K2 cases) copied.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12, "int8": 1979e12, "float8": 1979e12}


def bound(nbytes: float, flops: float, dtype: str) -> Dict[str, float]:
    """The least time (s) of a launch and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return {"seconds": max(t_bytes, t_ops), "bytes": nbytes, "flops": flops,
            "by_bytes": t_bytes >= t_ops}


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def k1_launch(q, k, v, bias=None, scale=None) -> Dict[str, float]:
    """K1 (flash attention): q, k, v and the output once, the bias's own
    elements once; QK^T and PV at 2 operations a multiply-add each."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    es = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    return bound(nbytes, 4 * b * h * sq * sk * d, dtype_name(q))


def k2_launch(x, w) -> Dict[str, float]:
    """K2 (layer-indexed product): x, the one layer's (K, N) weight and
    the (M, N) output once; 2 M K N operations."""
    k, n = w.shape[-2], w.shape[-1]
    m = x.numel() // k
    es = x.element_size()
    nbytes = m * k * es + k * n * w.element_size() + m * n * es
    return bound(nbytes, 2 * m * k * n, dtype_name(x))
