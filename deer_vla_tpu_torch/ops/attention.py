"""Core scaled-dot-product attention, routed by shape.

Query blocks of 128 rows or more (the ViT's 257 tokens) go to the fused
kernel (``ops/kernels/flash_attention``); shorter ones (decoder text 32,
perceiver latents 64, cross-attention text) use the plain einsum with an
fp32 softmax, as the JAX package's ``_xla_attention`` does.  A shape the
kernel cannot take on the card raises: there is no fallback.  The kernel
reads ``split_heads`` views through their strides and returns a view that
``merge_heads`` reshapes for free, so neither side copies.
"""

from __future__ import annotations

from typing import Optional

import torch

from deer_vla_tpu_torch.ops.kernels.flash_attention import flash_attention

KERNEL_MIN_SQ = 128


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, Sq, Dh) x (B, H, Sk, Dh) -> (B, H, Sq, Dh).
    ``bias`` broadcasts against (B, H, Sq, Sk)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[-2] >= KERNEL_MIN_SQ:
        return flash_attention(q, k, v, bias=bias, scale=scale)
    return plain_attention(q, k, v, bias, scale)


def plain_attention(q, k, v, bias, scale):
    """einsum + fp32 max-subtracted softmax, probabilities cast back to the
    input dtype before P.V (the JAX package's ``_xla_attention``)."""
    dt = q.dtype
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    logits = logits - logits.amax(-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D)"""
    b, s, hd = x.shape
    return x.reshape(b, s, n_heads, hd // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)"""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
