"""Layer-indexed matmuls over stacked (L, K, N) weights, with the layer
index ``idx`` read from a 0-dim int32 device tensor inside the kernel, so
choosing a layer costs no host sync:

  K2 ``indexed_matmul``     ``y = x @ W[idx]``;
  K3 ``indexed_matmul_q8``  ``y = (x @ Wq[idx]) * s[idx]``, Wq int8;
  K4 ``indexed_matmul_q4``  the same with Wq4 (L, K/2, N) nibble-packed
                            int4 (``ops.quant`` halves layout).

They replace the TPU kernels ``indexed_matmul``, ``indexed_matmul_q8`` and
``indexed_matmul_q4`` of ``deer_vla_tpu/ops/pallas/indexed_matmul.py``.  The
CUDA sources are ``deer_vla_tpu_torch/csrc/indexed_matmul.cu`` (K2) and
``indexed_matmul_quant.cu`` (K3, K4); their bounds on the card and what the
designs do about them are noted there.

Each wrapper launches its kernel for CUDA tensors and raises for anything
the kernel cannot take; for CPU tensors it runs its ``*_reference``, which
computes what the TPU kernel body computes (fp32 accumulation; for K3/K4
the scale applied in fp32 and one rounding to x.dtype).
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from deer_vla_tpu_torch.ops.kernels.build import function
from deer_vla_tpu_torch.ops.quant import unpack_nibbles

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


# ---------------------------------------------------------------------------
# K3 / K4: int8 and nibble-packed int4 weights with per-column fp32 scales
# ---------------------------------------------------------------------------

_Q_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_Q_CHUNK = 256  # bf16: eight warps x 32 weight rows staged a step


def indexed_matmul_q8_reference(x: torch.Tensor, wq: torch.Tensor,
                                s: torch.Tensor,
                                idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x @ Wq[idx]) * s[idx]``: fp32 products and sum, the scale in fp32,
    one rounding to x.dtype."""
    i = int(idx)
    return ((x.float() @ wq[i].float()) * s[i].float()).to(x.dtype)


def indexed_matmul_q4_reference(x: torch.Tensor, wq4: torch.Tensor,
                                s: torch.Tensor,
                                idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x @ unpack(Wq4[idx])) * s[idx]`` as two fp32 products against the
    x halves (low nibbles with x[..., :K/2], high with x[..., K/2:]), the
    scale in fp32, one rounding to x.dtype."""
    i = int(idx)
    kp = wq4.shape[1]
    lo, hi = unpack_nibbles(wq4[i])
    x32 = x.float()
    y = x32[..., :kp] @ lo.float() + x32[..., kp:] @ hi.float()
    return (y * s[i].float()).to(x.dtype)


def _launch_quantized(fn_name: str, x: torch.Tensor, wq: torch.Tensor,
                      s: torch.Tensor, idx: torch.Tensor,
                      kdim: int) -> torch.Tensor:
    """Checks and launch shared by K3 and K4 (``wq`` holds K or K/2 rows)."""
    if not x.is_cuda:
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    if not (isinstance(idx, torch.Tensor) and idx.ndim == 0
            and idx.dtype == torch.int32 and idx.device == x.device):
        raise TypeError("idx must be a 0-dim int32 tensor on x's device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn_name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    nl, rows, n = wq.shape
    if wq.dtype != torch.int8 or s.dtype != torch.float32 \
            or s.shape != (nl, n):
        raise TypeError(f"{fn_name}: want int8 weights and (L, N) float32 "
                        f"scales, got {wq.dtype} {tuple(wq.shape)} / "
                        f"{s.dtype} {tuple(s.shape)}")
    for t in (wq, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{fn_name}: weights and scales must be "
                             f"contiguous on {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim)
    m = x2.shape[0]
    mp = m
    if x.dtype == torch.bfloat16:
        if rows % _Q_CHUNK or n % _N_ALIGN:
            raise ValueError(f"bf16 {fn_name} needs {rows} weight rows % "
                             f"{_Q_CHUNK} == 0 and N % {_N_ALIGN} == 0 "
                             f"(N={n})")
        mp = -(-m // _BM) * _BM
        if mp != m:
            x2 = torch.cat([x2, x2.new_zeros(mp - m, kdim)])
    x2 = x2.contiguous()
    if x.dtype == torch.bfloat16 and (x2.data_ptr() % 32
                                      or wq.data_ptr() % 16):
        raise ValueError(f"bf16 {fn_name} needs 32-byte aligned x and "
                         "16-byte aligned weights")
    y = torch.empty(mp, n, dtype=x.dtype, device=x.device)
    err = function(f"deer_{fn_name}", _Q_ARGTYPES)(
        x2.data_ptr(), wq.data_ptr(), s.data_ptr(), idx.data_ptr(),
        y.data_ptr(), mp, kdim, n, nl, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return y[:m].reshape(*lead, n)


def indexed_matmul_q8(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                      idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x (..., K) @ wq (L, K, N)[idx]) * s (L, N)[idx] -> (..., N)`` with
    int8 weights.  On the card ``idx`` must be a 0-dim int32 tensor on the
    same device."""
    if wq.ndim != 3 or x.shape[-1] != wq.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match stacked int8 "
                         f"weights {tuple(wq.shape)}")
    if x.device.type == "cpu":
        return indexed_matmul_q8_reference(x, wq, s, idx)
    y = _launch_quantized("indexed_matmul_q8", x, wq, s, idx, wq.shape[1])
    indexed_matmul_q8.launches += 1
    return y


def indexed_matmul_q4(x: torch.Tensor, wq4: torch.Tensor, s: torch.Tensor,
                      idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x (..., K) @ unpack(wq4 (L, K/2, N)[idx])) * s (L, N)[idx]`` with
    nibble-packed int4 weights.  On the card ``idx`` must be a 0-dim int32
    tensor on the same device."""
    if wq4.ndim != 3 or x.shape[-1] != 2 * wq4.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match stacked packed "
                         f"int4 weights {tuple(wq4.shape)}")
    if x.device.type == "cpu":
        return indexed_matmul_q4_reference(x, wq4, s, idx)
    y = _launch_quantized("indexed_matmul_q4", x, wq4, s, idx,
                          2 * wq4.shape[1])
    indexed_matmul_q4.launches += 1
    return y


indexed_matmul_q8.launches = 0
indexed_matmul_q4.launches = 0
