"""Fused attention (kernel K1): ``softmax(scale * q k^T + bias) v``.

Replaces the TPU kernel ``deer_vla_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` -> ``_run`` -> ``_kernel``).  The CUDA source is
``deer_vla_tpu_torch/csrc/flash_attention.cu``: in bf16 a tensor-core
flash attention (one warpgroup of 64 query rows a block, 64-key tiles in a
cp.async ring, mma.sync with P kept in registers); in fp32 the first,
CUDA-core version.  Its bound on the card and what the design does about it
are noted in that file.

The kernel is the operator ``torch.ops.deer.flash_attention`` (and
``deer::flash_attention_with_stats``, the same launch writing its row
statistics), so ``torch.export`` records it as one node; ``flash_attention``
and ``flash_attention_with_stats`` are its only Python entries.  Its CUDA
implementation launches the kernel and raises for anything it cannot take,
counts each launch on ``flash_attention.launches`` and hands the launch's
inputs (q, k, v, bias, scale, as given) to ``flash_attention.observer``
where a caller set one (``None`` by default; ``flash_attention_backward``
has the same pair); its CPU implementation is
``flash_attention_reference``, which repeats the TPU kernel's arithmetic
step by step; its fake implementation gives the output's shape, dtype and
strides.

With grad mode on and q, k or v requiring grad, ``flash_attention`` calls
``deer::flash_attention_with_stats``, whose gradient (registered on the
operator with ``torch.library.register_autograd``) is
``flash_attention_backward``: on the card the kernel pair of
``csrc/flash_attention_bwd.cu``, on the CPU its plain version
``flash_attention_backward_reference``.  The TPU kernel has no backward;
the port's decoder trains through K1 on text of 128 tokens or more, and
``--unfreeze_vit`` trains the ViT through it.  A bias that requires grad is
refused: no model trains one.  In bf16 the forward saves
each row's max m and 1 / l (``flash_attention_with_stats``: a (2, B, H, Sq)
fp32 tensor) and the backward reads them instead of recomputing them: a dQ
kernel (which also writes delta = rowsum(dout * out)) and a dK / dV kernel,
both on the tensor cores (mma.sync over 64-row tiles in shared memory,
cp.async rings, no atomics).  Its bound is bytes (12.5 us at the MMC4
decoder call); what holds it back is mma.sync's issue rate over the seven
products, the Q / dOut and K / V tiles re-read from L2 by every block, and
one 4-warp block an SM when the bias tile is staged (the source's note).
In fp32 (cross-checks only) the first, CUDA-core pair stays: it recomputes
the statistics, and the forward saves none.

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
from deer_vla_tpu_torch.ops.kernels.guard import check_device, check_no_grad

MAX_D = 256
TC_HEAD_DIMS = (64, 128)  # the bf16 kernel's instantiations

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
_Strides12 = ctypes.c_longlong * 12
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
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


def _logits(q, k, bias, scale):
    """fp32 ``scale * q k^T + bias``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return s if bias is None else s + bias.float()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              with_stats: bool = False):
    """The TPU kernel's math: fp32 logits, max-subtracted exp, P cast to
    v.dtype before an fp32-accumulated P.V, division by the sum last.
    With ``with_stats``, ``(out, stats)``: stats (2, B, H, Sq) fp32, each
    row's max m of the logits and 1 / l, l = sum exp(logits - m)."""
    bias = _check(q, k, v, bias)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _logits(q, k, bias, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (o / denom).to(q.dtype)
    if with_stats:
        return out, torch.stack([m[..., 0], 1 / denom[..., 0]])
    return out


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
    check_device("flash_attention", q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_no_grad("flash_attention", bias)
        return torch.ops.deer.flash_attention_with_stats(q, k, v, bias,
                                                         scale)[0]
    return torch.ops.deer.flash_attention(q, k, v, bias, scale)


flash_attention.launches = 0
flash_attention.observer = None


def flash_attention_with_stats(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None) -> tuple:
    """``(out, stats)``: K1's output and the row statistics the backward
    reads, (2, B, H, Sq) fp32 (m and 1 / l); on the card the bf16 kernel
    writes them in the same launch, and the fp32 kernel writes none (its
    backward recomputes them: ``stats`` is None)."""
    check_device("flash_attention", q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.ops.deer.flash_attention_with_stats(q, k, v, bias, scale)


def _forward(q, k, v, bias, scale, with_stats=False):
    """The operators' implementation: the plain version for CPU tensors,
    else K1's launch, counted on ``flash_attention``.  With
    ``with_stats``, ``(out, stats)`` (stats None in fp32 on the card)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale, with_stats)
    given = (q, k, v, bias, scale)
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
        stats = torch.empty(2, b, h, sq, dtype=torch.float32,
                            device=q.device) if with_stats else None
    else:
        if d % 4:
            raise ValueError(f"fp32 head dim {d} must be a multiple of 4")
        q, k, v = (t.contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        strides = stats = None
    err = function("deer_flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, h, sq, sk, out.shape[-1], float(scale), _DTYPE_CODE[q.dtype],
        bias_code, *bstr, strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    if flash_attention.observer is not None:
        flash_attention.observer(*given)
    out = out[..., :d] if out.shape[-1] != d else out
    return (out, stats) if with_stats else out


def _bias_args(bias, q, b, h, sq, sk):
    """(pointer, dtype code, 4 element strides) of a (broadcast) bias."""
    if bias is None:
        return None, -1, (0, 0, 0, 0)
    if bias.device != q.device or bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"bias must be float32/bfloat16 on {q.device}")
    bias = bias.expand(b, h, sq, sk)  # broadcast dims get stride 0
    return bias.data_ptr(), _DTYPE_CODE[bias.dtype], bias.stride()


def _fake_out(q):
    """The output as the implementation lays it out: on the card in bf16
    the (B, H, Sq, D) view of a (B, Sq, H, D) buffer (cut from the kernel's
    head dim), else contiguous."""
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        b, h, sq, d = q.shape
        dk = kernel_head_dim(d)
        out = q.new_empty(b, sq, h, dk).transpose(1, 2)
        return out[..., :d] if dk != d else out
    return q.new_empty(q.shape)


def _fake_stats(q):
    if q.device.type == "cuda" and q.dtype != torch.bfloat16:
        return None
    return q.new_empty((2,) + tuple(q.shape[:3]), dtype=torch.float32)


_LIB = torch.library.Library("deer", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, Tensor? bias, "
            "float scale) -> Tensor")
_LIB.define("flash_attention_with_stats(Tensor q, Tensor k, Tensor v, "
            "Tensor? bias, float scale) -> (Tensor, Tensor?)")
for _key in ("CPU", "CUDA"):
    # looked up at call time, so a test may stand in for the launch
    _LIB.impl("flash_attention",
              lambda q, k, v, bias, scale: _forward(q, k, v, bias, scale),
              _key)
    _LIB.impl("flash_attention_with_stats",
              lambda q, k, v, bias, scale: _forward(q, k, v, bias, scale,
                                                    with_stats=True),
              _key)


@torch.library.register_fake("deer::flash_attention")
def _flash_attention_fake(q, k, v, bias, scale):
    return _fake_out(q)


@torch.library.register_fake("deer::flash_attention_with_stats")
def _flash_attention_with_stats_fake(q, k, v, bias, scale):
    return _fake_out(q), _fake_stats(q)


def _setup_context(ctx, inputs, output):
    q, k, v, bias, scale = inputs
    out, stats = output
    ctx.save_for_backward(q, k, v, bias, out, stats)
    ctx.scale = scale


def _backward(ctx, dout, dstats):
    """K1's gradient: ``flash_attention_backward`` given the forward's row
    statistics; the bias and the statistics take none."""
    q, k, v, bias, out, stats = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(q, k, v, bias, out, dout,
                                          ctx.scale, stats)
    return dq, dk, dv, None, None


torch.library.register_autograd("deer::flash_attention_with_stats",
                                _backward, setup_context=_setup_context)


def _check_backward(q, k, v, bias, out, dout, stats):
    bias = _check(q, k, v, bias)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} do not match q "
                         f"{tuple(q.shape)}")
    want = (2,) + tuple(q.shape[:3])
    if stats is not None and (tuple(stats.shape) != want
                              or stats.dtype != torch.float32
                              or stats.device != q.device):
        raise ValueError(f"stats must be float32 {want} on {q.device}, got "
                         f"{stats.dtype} {tuple(stats.shape)} on "
                         f"{stats.device}")
    return bias


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor], out: torch.Tensor, dout: torch.Tensor,
        scale: Optional[float] = None,
        stats: Optional[torch.Tensor] = None) -> tuple:
    """(dq, dk, dv) of ``softmax(scale * q k^T + bias) v`` at ``out`` for
    ``dout``, in the backward kernel's arithmetic: fp32 throughout, p =
    exp(s - m) / l kept in fp32 from the forward's row max m and 1 / l
    (``stats``, as ``flash_attention_with_stats`` gives them; recomputed
    when None), delta = rowsum(dout * out); each gradient in its input's
    dtype."""
    bias = _check_backward(q, k, v, bias, out, dout, stats)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    s = _logits(qf, kf, bias, scale)
    if stats is None:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e * (1 / e.sum(-1, keepdim=True))
    else:
        p = torch.exp(s - stats[0, ..., None]) * stats[1, ..., None]
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: Optional[torch.Tensor],
                             out: torch.Tensor, dout: torch.Tensor,
                             scale: Optional[float] = None,
                             stats: Optional[torch.Tensor] = None) -> tuple:
    """(dq, dk, dv), contiguous (B, H, S, D) in q's dtype, of K1 at its
    output ``out`` for the upstream gradient ``dout``, given the forward's
    row statistics ``stats`` ((2, B, H, Sq) fp32, as
    ``flash_attention_with_stats`` returns them).  For CUDA tensors the
    kernel pair of ``csrc/flash_attention_bwd.cu``: bf16 (D a multiple of
    16 up to 128, 16-byte aligned rows, else copied) on the tensor cores,
    which needs ``stats``; fp32 (D <= 256, a unit last stride) on the CUDA
    cores, which recomputes them and does not read given ones.  For CPU
    tensors the plain version."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, bias, out, dout,
                                                  scale, stats)
    given = (q, k, v, bias, out, dout, scale, stats)
    bias = _check_backward(q, k, v, bias, out, dout, stats)
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
    kd = d
    if q.dtype == torch.bfloat16:
        if stats is None:
            raise ValueError("flash_attention_backward: the bf16 kernels read "
                             "the forward's row statistics; pass stats "
                             "(flash_attention_with_stats)")
        kd = kernel_head_dim(d)
        if kd != d:  # zero columns add nothing to s, dp or delta
            ts = tuple(F.pad(t, (0, kd - d)) for t in ts)
        ts = tuple(t if strided_ok(t) else t.contiguous() for t in ts)
        stats = stats.contiguous()
        scratch = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    else:
        ts = tuple(t if t.stride(3) == 1 else t.contiguous() for t in ts)
        stats = None
        scratch = torch.empty(3, b, h, sq, dtype=torch.float32,
                              device=q.device)
    q, k, v, out, dout = ts
    bias_ptr, bias_code, bstr = _bias_args(bias, q, b, h, sq, sk)
    dq = torch.empty(b, h, sq, kd, dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(b, h, sk, kd, dtype=q.dtype, device=q.device)
              for _ in range(2))
    strides = _Strides15(*(s for t in ts for s in t.stride()[:3]))
    err = function("deer_flash_attention_bwd", _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), bias_ptr, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if stats is None else stats.data_ptr(),
        scratch.data_ptr(), b, h, sq, sk, kd, float(scale),
        _DTYPE_CODE[q.dtype], bias_code, *bstr, strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_backward.launches += 1
    if flash_attention_backward.observer is not None:
        flash_attention_backward.observer(*given)
    if kd != d:
        return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.observer = None
