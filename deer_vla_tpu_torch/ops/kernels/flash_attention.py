"""Fused attention (kernel K1): ``softmax(scale * q k^T + bias) v``.

Replaces the TPU kernel ``deer_vla_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` -> ``_run`` -> ``_kernel``).  The CUDA source is
``deer_vla_tpu_torch/csrc/flash_attention.cu``: a key-tiled online softmax
with fp32 accumulation on a (q-tile, head, batch) grid.  Its bound on the
card and what the design does about it are noted in that file.

``flash_attention`` launches the kernel for CUDA tensors and raises for
anything it cannot take; for CPU tensors it runs
``flash_attention_reference``, which repeats the TPU kernel's arithmetic
step by step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deer_vla_tpu_torch.ops.kernels.build import function

MAX_D = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
             + [ctypes.c_void_p])


def _check(q, k, v, bias):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d > MAX_D:
        raise ValueError(f"head dim {d} > {MAX_D}")
    if bias is not None:
        while bias.ndim < 4:
            bias = bias[None]
        if bias.shape[2] != sq or bias.shape[3] != sk:
            raise ValueError("bias q/k dims must match")
        if bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h):
            raise ValueError("bias batch/head dims must be 1 or full")
    return bias


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The TPU kernel's math: fp32 logits, max-subtracted exp, P cast to
    v.dtype before an fp32-accumulated P.V, division by the sum last."""
    bias = _check(q, k, v, bias)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D); ``bias`` broadcasts
    over B and/or H.  D <= 256 and D % 4 == 0 on the card."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    bias = _check(q, k, v, bias)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if bias is not None:
        if bias.device != q.device or bias.dtype not in _DTYPE_CODE:
            raise TypeError(f"bias must be float32/bfloat16 on {q.device}")
        bias = bias.expand(b, h, sq, sk)  # broadcast dims get stride 0
        bstr = bias.stride()
        bias_ptr, bias_code = bias.data_ptr(), _DTYPE_CODE[bias.dtype]
    else:
        bstr = (0, 0, 0, 0)
        bias_ptr, bias_code = None, -1
    out = torch.empty_like(q)
    err = function("deer_flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        b, h, sq, sk, d, float(scale), _DTYPE_CODE[q.dtype], bias_code,
        *bstr, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
