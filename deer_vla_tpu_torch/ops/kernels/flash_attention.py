"""Fused attention (kernel K1): ``softmax(scale * q k^T + bias) v``.

Replaces the TPU kernel ``deer_vla_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` -> ``_run`` -> ``_kernel``).  The CUDA source is
``deer_vla_tpu_torch/csrc/flash_attention.cu``: in bf16 a tensor-core
flash attention (one warpgroup of 64 query rows a block, 64-key tiles in a
cp.async ring, mma.sync with P kept in registers); in fp32 the first,
CUDA-core version.  Its bound on the card and what the design does about it
are noted in that file.

``flash_attention`` launches the kernel for CUDA tensors and raises for
anything it cannot take; for CPU tensors it runs
``flash_attention_reference``, which repeats the TPU kernel's arithmetic
step by step.

In bf16 the kernel reads q, k and v through their (batch, head, seq)
strides, so ``split_heads`` views of a fused qkv projection go in without a
copy, and it returns the (B, H, Sq, D) view of a (B, Sq, H, D) buffer, which
``merge_heads`` reshapes without a copy.  It needs unit stride on D and
16-byte aligned rows; a tensor that has neither is copied to a contiguous
layout first (a layout copy, not a fallback).  D must be a multiple of 16
up to 128; the kernel is built for D = 64 (the ViT, perceiver and
cross-attention heads) and D = 128 (MPT-1B's heads), and other multiples
of 16 are zero-padded to the next of those.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.ops.kernels.build import function
from deer_vla_tpu_torch.ops.kernels.guard import check_no_grad

MAX_D = 256
TC_HEAD_DIMS = (64, 128)  # the bf16 kernel's instantiations

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
_Strides12 = ctypes.c_longlong * 12


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


def kernel_head_dim(d: int) -> int:
    """The head dim the bf16 kernel runs a call of head dim ``d`` at (``d``
    zero-padded up to it)."""
    if d % 16 or d > TC_HEAD_DIMS[-1]:
        raise ValueError(f"bf16 flash_attention needs a head dim that is a "
                         f"multiple of 16 up to {TC_HEAD_DIMS[-1]}, got {d}")
    return next(t for t in TC_HEAD_DIMS if t >= d)


def strided_ok(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel can read ``t`` (B, H, S, D) in place: unit
    stride on D and every row start 16-byte aligned."""
    step = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % step == 0 for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D); ``bias`` broadcasts
    over B and/or H.  On the card: bf16 with D % 16 == 0, D <= 128, any
    strides (see the module note); fp32 with D % 4 == 0, D <= 256."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    bias = _check(q, k, v, bias)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_no_grad("flash_attention", q, k, v, bias)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
    if bias is not None:
        if bias.device != q.device or bias.dtype not in _DTYPE_CODE:
            raise TypeError(f"bias must be float32/bfloat16 on {q.device}")
        bias = bias.expand(b, h, sq, sk)  # broadcast dims get stride 0
        bstr = bias.stride()
        bias_ptr, bias_code = bias.data_ptr(), _DTYPE_CODE[bias.dtype]
    else:
        bstr = (0, 0, 0, 0)
        bias_ptr, bias_code = None, -1
    if q.dtype == torch.bfloat16:
        dk = kernel_head_dim(d)
        if dk != d:  # zero columns change neither q k^T nor the used outputs
            q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
        q, k, v = (t if strided_ok(t) else t.contiguous() for t in (q, k, v))
        buf = torch.empty(b, sq, h, dk, dtype=q.dtype, device=q.device)
        out = buf.transpose(1, 2)
        strides = _Strides12(*(s for t in (q, k, v, out)
                               for s in t.stride()[:3]))
    else:
        if d % 4:
            raise ValueError(f"fp32 head dim {d} must be a multiple of 4")
        q, k, v = (t.contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        strides = None
    err = function("deer_flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        b, h, sq, sk, out.shape[-1], float(scale), _DTYPE_CODE[q.dtype],
        bias_code, *bstr, strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out[..., :d] if out.shape[-1] != d else out


flash_attention.launches = 0
