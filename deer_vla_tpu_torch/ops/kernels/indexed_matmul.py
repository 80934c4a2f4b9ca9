"""Layer-indexed matmul (kernel K2): ``y = x @ W[idx]`` over stacked
(L, K, N) weights.

Replaces the TPU kernel ``deer_vla_tpu/ops/pallas/indexed_matmul.py``
(``indexed_matmul`` -> ``_run`` -> ``_kernel``).  The CUDA source is
``deer_vla_tpu_torch/csrc/indexed_matmul.cu``; it reads ``idx`` from a 0-dim
int32 device tensor inside the kernel, so choosing a layer costs no host
sync.  Its bound on the card and what the design does about it are noted in
that file.

``indexed_matmul`` launches the kernel for CUDA tensors and raises for
anything it cannot take; for CPU tensors it runs
``indexed_matmul_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from deer_vla_tpu_torch.ops.kernels.build import function

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

_BM = 16        # bf16 row tile (x is zero-padded to a multiple)
_K_ALIGN = 64   # four warps x 16-deep MMA steps
_N_ALIGN = 16   # one 16-column fragment per block


def indexed_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``x @ W[idx]`` in x.dtype."""
    return x @ w[int(idx)].to(x.dtype)


def indexed_matmul(x: torch.Tensor, w: torch.Tensor,
                   idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``x (..., K) @ w (L, K, N)[idx] -> (..., N)``.  On the card ``idx``
    must be a 0-dim int32 tensor on the same device."""
    if w.ndim != 3 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match stacked w "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return indexed_matmul_reference(x, w, idx)
    if not x.is_cuda:
        raise ValueError(f"indexed_matmul: unsupported device {x.device}")
    if not (isinstance(idx, torch.Tensor) and idx.ndim == 0
            and idx.dtype == torch.int32 and idx.device == x.device):
        raise TypeError("idx must be a 0-dim int32 tensor on x's device")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x/w must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous on {x.device}")
    nl, kdim, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim)
    m = x2.shape[0]
    mp = m
    if x.dtype == torch.bfloat16:
        if kdim % _K_ALIGN or n % _N_ALIGN:
            raise ValueError(f"bf16 indexed_matmul needs K % {_K_ALIGN} == 0 "
                             f"and N % {_N_ALIGN} == 0, got K={kdim} N={n}")
        mp = -(-m // _BM) * _BM
        if mp != m:
            x2 = torch.cat([x2, x2.new_zeros(mp - m, kdim)])
    x2 = x2.contiguous()
    if x.dtype == torch.bfloat16 and (x2.data_ptr() % 32 or w.data_ptr() % 32):
        raise ValueError("bf16 indexed_matmul needs 32-byte aligned x and w")
    y = torch.empty(mp, n, dtype=x.dtype, device=x.device)
    err = function("deer_indexed_matmul", _ARGTYPES)(
        x2.data_ptr(), w.data_ptr(), idx.data_ptr(), y.data_ptr(), mp, kdim,
        n, nl, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"indexed_matmul launch failed: CUDA error {err}")
    indexed_matmul.launches += 1
    return y[:m].reshape(*lead, n)


indexed_matmul.launches = 0
