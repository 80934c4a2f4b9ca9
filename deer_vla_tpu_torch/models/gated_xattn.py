"""Gated cross-attention block (open_flamingo helpers.py:136-279).

Text token i attends to media t iff cumsum(media_locations)[i] == t + 1
(only_attend_immediate_media) or >= t + 1 otherwise.  The mask is a finite
``NEG_INF``: text before the first media token gets a fully masked row,
whose output is zeroed after the attention.  A -inf mask would give NaN in
that row instead.

Under tensor parallelism (``tp``) ``to_q`` and ``to_kv`` hold this rank's
heads' columns (``to_kv`` as [k_r | v_r]) and ``to_out`` their rows: the
rank attends over its heads, and ``to_out`` is summed over the group.  The
feed-forward ``ff`` matches no tp rule and stays replicated.
"""

from __future__ import annotations

from typing import Optional

import torch

from deer_vla_tpu_torch.models.perceiver import ff_forward, init_ff
from deer_vla_tpu_torch.ops.attention import dot_attention
from deer_vla_tpu_torch.ops.layers import (col_parallel_linear,
                                           init_layernorm, init_linear,
                                           layernorm, row_parallel_linear)

NEG_INF = -1e9


def init_gated_xattn(gen, dim: int, dim_visual: int, dim_head: int = 64,
                     heads: int = 8, ff_mult: int = 4, device="cpu",
                     dtype=torch.float32) -> dict:
    inner = dim_head * heads
    return {
        "norm": init_layernorm(dim, device=device, dtype=dtype),
        "to_q": init_linear(gen, dim, inner, False, device, dtype),
        "to_kv": init_linear(gen, dim_visual, 2 * inner, False, device, dtype),
        "to_out": init_linear(gen, inner, dim, False, device, dtype),
        "attn_gate": torch.zeros(1, device=device, dtype=dtype),
        "ff": init_ff(gen, dim, ff_mult, device, dtype),
        "ff_gate": torch.zeros(1, device=device, dtype=dtype),
    }


def masked_cross_attention(p: dict, x: torch.Tensor, media: torch.Tensor,
                           media_locations: Optional[torch.Tensor], *,
                           heads: int, dim_head: int,
                           only_attend_immediate_media: bool = True,
                           text_time: Optional[torch.Tensor] = None,
                           tp=None) -> torch.Tensor:
    """x: (B, T_txt, D); media: (B, T_img, n, D_vis)."""
    b, t_txt, _ = x.shape
    _, t_img, n_media, _ = media.shape
    if tp is not None and tp.size > 1:
        if heads % tp.size:
            raise ValueError(f"{heads} heads do not split over "
                             f"tp={tp.size}")
        heads //= tp.size
    q = col_parallel_linear(p["to_q"], layernorm(p["norm"], x), tp)
    media_f = media.reshape(b, t_img * n_media, media.shape[-1])
    k, v = col_parallel_linear(p["to_kv"], media_f, tp, 2).chunk(2, dim=-1)

    def to_heads(t):
        bb, s, _ = t.shape
        return t.reshape(bb, s, heads, dim_head).transpose(1, 2)

    bias = None
    zero_out = None
    if media_locations is not None or text_time is not None:
        if text_time is None:
            text_time = torch.cumsum(media_locations.int(), dim=-1)
        media_time = torch.arange(1, t_img + 1, device=x.device)
        media_time = media_time.repeat_interleave(n_media)
        if only_attend_immediate_media:
            allowed = text_time[:, :, None] == media_time[None, None, :]
            zero_out = text_time == 0
        else:
            allowed = text_time[:, :, None] >= media_time[None, None, :]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        bias = torch.where(allowed, zero, NEG_INF)[:, None]

    out = dot_attention(to_heads(q), to_heads(k), to_heads(v), bias=bias,
                        scale=dim_head ** -0.5)
    out = out.transpose(1, 2).reshape(b, t_txt, heads * dim_head)
    if zero_out is not None:
        out = out.masked_fill(zero_out[:, :, None], 0.0)
    return row_parallel_linear(p["to_out"], out, tp)


def gated_xattn_forward(p: dict, x: torch.Tensor, media: torch.Tensor,
                        media_locations: Optional[torch.Tensor], *,
                        heads: int = 8, dim_head: int = 64,
                        only_attend_immediate_media: bool = True,
                        text_time: Optional[torch.Tensor] = None,
                        tp=None) -> torch.Tensor:
    attn = masked_cross_attention(
        p, x, media, media_locations, heads=heads, dim_head=dim_head,
        only_attend_immediate_media=only_attend_immediate_media,
        text_time=text_time, tp=tp)
    x = attn * torch.tanh(p["attn_gate"].to(x.dtype)) + x
    return ff_forward(p["ff"], x) * torch.tanh(p["ff_gate"].to(x.dtype)) + x
