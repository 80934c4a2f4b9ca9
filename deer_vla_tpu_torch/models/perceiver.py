"""Perceiver resampler (open_flamingo helpers.py:25-132).

q from the latents; k/v from concat(media tokens, latents); q scaled by
dim_head**-0.5; bias-free projections; FeedForward = LN -> Linear -> exact
GELU -> Linear; residual after attention and after the feed-forward; final
LayerNorm.  Frames (T) fold into the batch.

Under tensor parallelism (``tp``) ``to_q`` / ``to_kv`` hold this rank's
heads' columns (``to_kv`` as [k_r | v_r]) and ``to_out`` their rows,
summed over the group; the feed-forward stays replicated.
"""

from __future__ import annotations

import torch

from deer_vla_tpu_torch.core.config import PerceiverConfig
from deer_vla_tpu_torch.ops.attention import dot_attention
from deer_vla_tpu_torch.ops.layers import (col_parallel_linear, gelu,
                                           init_layernorm, init_linear,
                                           layer_slice, layernorm, linear,
                                           normal, row_parallel_linear,
                                           stack_layer_tree)


def init_ff(gen, dim: int, mult: int, device="cpu",
            dtype=torch.float32) -> dict:
    inner = int(dim * mult)
    return {"ln": init_layernorm(dim, device=device, dtype=dtype),
            "fc1": init_linear(gen, dim, inner, False, device, dtype),
            "fc2": init_linear(gen, inner, dim, False, device, dtype)}


def ff_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], layernorm(p["ln"], x))))


def init_perceiver(gen, cfg: PerceiverConfig, device="cpu",
                   dtype=torch.float32) -> dict:
    inner = cfg.inner_dim
    params = {
        "latents": normal((cfg.num_latents, cfg.dim), 1.0, gen, device, dtype),
        "norm": init_layernorm(cfg.dim, device=device, dtype=dtype),
        "layers": [],
    }
    for _ in range(cfg.depth):
        params["layers"].append({
            "norm_media": init_layernorm(cfg.dim, device=device, dtype=dtype),
            "norm_latents": init_layernorm(cfg.dim, device=device,
                                           dtype=dtype),
            "to_q": init_linear(gen, cfg.dim, inner, False, device, dtype),
            "to_kv": init_linear(gen, cfg.dim, 2 * inner, False, device,
                                 dtype),
            "to_out": init_linear(gen, inner, cfg.dim, False, device, dtype),
            "ff": init_ff(gen, cfg.dim, cfg.ff_mult, device, dtype),
        })
    return params


def _perceiver_attn(p: dict, x: torch.Tensor, latents: torch.Tensor,
                    cfg: PerceiverConfig, tp=None) -> torch.Tensor:
    """x: (B, v, D) media tokens; latents: (B, n, D)."""
    n_heads = cfg.heads
    if tp is not None and tp.size > 1:
        if n_heads % tp.size:
            raise ValueError(f"{n_heads} perceiver heads do not split over "
                             f"tp={tp.size}")
        n_heads //= tp.size
    xm = layernorm(p["norm_media"], x)
    lt = layernorm(p["norm_latents"], latents)
    q = col_parallel_linear(p["to_q"], lt, tp)
    k, v = col_parallel_linear(p["to_kv"], torch.cat([xm, lt], dim=-2), tp,
                               2).chunk(2, dim=-1)

    def heads(t):
        b, s, _ = t.shape
        return t.reshape(b, s, n_heads, cfg.dim_head).transpose(1, 2)

    out = dot_attention(heads(q), heads(k), heads(v),
                        scale=cfg.dim_head ** -0.5)
    b, h, n, d = out.shape
    return row_parallel_linear(p["to_out"],
                               out.transpose(1, 2).reshape(b, n, h * d), tp)


def _layer_forward(layer: dict, x, latents, cfg, tp=None):
    latents = _perceiver_attn(layer, x, latents, cfg, tp) + latents
    return ff_forward(layer["ff"], latents) + latents


def perceiver_forward(params: dict, x: torch.Tensor,
                      cfg: PerceiverConfig, tp=None) -> torch.Tensor:
    """x: (B, T, F, v, D) image features -> (B, T, num_latents, D)."""
    b, t, f, v, d = x.shape
    x = x.reshape(b * t, f * v, d)
    latents = params["latents"].to(x.dtype).expand(b * t, cfg.num_latents, d)
    for layer in params["layers"]:
        latents = _layer_forward(layer, x, latents, cfg, tp)
    return layernorm(params["norm"], latents).reshape(b, t, cfg.num_latents, d)


def stack_perceiver_layers(params: dict, dtype=None) -> dict:
    return stack_layer_tree(params["layers"], dtype)


def perceiver_forward_stacked(params: dict, stacked_layers: dict,
                              x: torch.Tensor,
                              cfg: PerceiverConfig, tp=None) -> torch.Tensor:
    """perceiver_forward over stacked (depth, ...) layer weights.  The depth
    is read from a LayerNorm scale, which quantization leaves as it is (a
    quantized tree has ``q``/``q4`` where ``w`` was)."""
    b, t, f, v, d = x.shape
    x = x.reshape(b * t, f * v, d)
    latents = params["latents"].to(x.dtype).expand(b * t, cfg.num_latents, d)
    for i in range(stacked_layers["norm_latents"]["scale"].shape[0]):
        latents = _layer_forward(layer_slice(stacked_layers, i), x, latents,
                                 cfg, tp)
    return layernorm(params["norm"], latents).reshape(b, t, cfg.num_latents, d)
