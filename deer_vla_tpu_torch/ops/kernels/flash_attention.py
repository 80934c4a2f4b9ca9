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

On the card, with grad mode on and q, k or v requiring grad, the call goes
through an autograd function whose backward is the kernel pair of
``csrc/flash_attention_bwd.cu`` (``flash_attention_backward``; its plain
version ``flash_attention_backward_reference``).  The TPU kernel has no
backward; the port's decoder trains through K1 on text of 128 tokens or
more, and ``--unfreeze_vit`` trains the ViT through it.  A bias that
requires grad is refused: no model trains one.

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
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + [ctypes.c_int] * 2
                 + [ctypes.c_longlong] * 4
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
_Strides15 = ctypes.c_longlong * 15


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
    strides (see the module note); fp32 with D % 4 == 0, D <= 256.  With
    grad mode on and q, k or v requiring grad, differentiable through
    ``flash_attention_backward``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_no_grad("flash_attention", bias)
        return _FlashAttention.apply(q, k, v, bias, scale)
    return _forward(q, k, v, bias, scale)


flash_attention.launches = 0


def _forward(q, k, v, bias, scale):
    """K1's launch; counts on ``flash_attention``."""
    bias = _check(q, k, v, bias)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_no_grad("flash_attention", q, k, v, bias)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
    bias_ptr, bias_code, bstr = _bias_args(bias, q, b, h, sq, sk)
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


def _bias_args(bias, q, b, h, sq, sk):
    """(pointer, dtype code, 4 element strides) of a (broadcast) bias."""
    if bias is None:
        return None, -1, (0, 0, 0, 0)
    if bias.device != q.device or bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"bias must be float32/bfloat16 on {q.device}")
    bias = bias.expand(b, h, sq, sk)  # broadcast dims get stride 0
    return bias.data_ptr(), _DTYPE_CODE[bias.dtype], bias.stride()


class _FlashAttention(torch.autograd.Function):
    """K1 forward, ``flash_attention_backward`` backward; the bias takes
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out = _forward(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, bias, out, dout,
                                              ctx.scale)
        return dq, dk, dv, None, None


def _check_backward(q, k, v, bias, out, dout):
    bias = _check(q, k, v, bias)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} do not match q "
                         f"{tuple(q.shape)}")
    return bias


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor], out: torch.Tensor, dout: torch.Tensor,
        scale: Optional[float] = None) -> tuple:
    """(dq, dk, dv) of ``softmax(scale * q k^T + bias) v`` at ``out`` for
    ``dout``, in the backward kernel's arithmetic: fp32 throughout, the
    row max m and sum l recomputed, p = exp(s - m) / l kept in fp32, delta
    = rowsum(dout * out); each gradient in its input's dtype."""
    bias = _check_backward(q, k, v, bias, out, dout)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1 / e.sum(-1, keepdim=True))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: Optional[torch.Tensor],
                             out: torch.Tensor, dout: torch.Tensor,
                             scale: Optional[float] = None) -> tuple:
    """(dq, dk, dv), contiguous (B, H, S, D) in q's dtype, of K1 at its
    output ``out`` for the upstream gradient ``dout``; the kernel pair of
    ``csrc/flash_attention_bwd.cu`` for CUDA tensors (bf16 or fp32, D <=
    256, any strides with a unit last one), the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, bias, out, dout,
                                                  scale)
    bias = _check_backward(q, k, v, bias, out, dout)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_backward: unsupported device "
                         f"{q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    ts = (q, k, v, out, dout)
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _DTYPE_CODE:
        raise TypeError("q/k/v/out/dout must share float32 or bfloat16, got "
                        + "/".join(str(t.dtype) for t in ts))
    if any(t.device != q.device for t in ts):
        raise ValueError(f"q/k/v/out/dout must all be on {q.device}")
    q, k, v, out, dout = (t if t.stride(3) == 1 else t.contiguous()
                          for t in ts)
    bias_ptr, bias_code, bstr = _bias_args(bias, q, b, h, sq, sk)
    dq = torch.empty(b, h, sq, d, dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(b, h, sk, d, dtype=q.dtype, device=q.device)
              for _ in range(2))
    stats = torch.empty(3, b, h, sq, dtype=torch.float32, device=q.device)
    strides = _Strides15(*(s for t in (q, k, v, out, dout)
                           for s in t.stride()[:3]))
    err = function("deer_flash_attention_bwd", _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), bias_ptr, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), b, h, sq, sk, d, float(scale), _DTYPE_CODE[q.dtype], bias_code, *bstr,
        strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
