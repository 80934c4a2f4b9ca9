"""CLIP ViT visual tower (open_clip "ViT-L-14").

The per-patch tokens after ``ln_post`` feed the perceiver.  The patch
embedding is the stride-14 convolution written as a (B, P, c*ph*pw) x
(c*ph*pw, width) matmul, with the JAX package's flatten order (c, ph, pw).
The self-attention goes through ``ops.attention.dot_attention``, which sends
the 257-token blocks to the fused kernel K1.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.core.config import ViTConfig
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.layers import (init_layernorm, init_linear,
                                           layer_slice, layernorm, linear,
                                           normal, quick_gelu,
                                           stack_layer_tree, trunc_normal)


def init_vit(gen, cfg: ViTConfig, device="cpu", dtype=torch.float32) -> dict:
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    scale = cfg.width ** -0.5
    hidden = int(cfg.width * cfg.mlp_ratio)
    params = {
        "patch_embed": {"w": trunc_normal((patch_dim, cfg.width), 0.02, gen,
                                          device, dtype)},
        "class_embedding": normal((cfg.width,), scale, gen, device, dtype),
        "positional_embedding": normal((cfg.seq_len, cfg.width), scale, gen,
                                       device, dtype),
        "ln_pre": init_layernorm(cfg.width, device=device, dtype=dtype),
        "ln_post": init_layernorm(cfg.width, device=device, dtype=dtype),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln_1": init_layernorm(cfg.width, device=device, dtype=dtype),
            "ln_2": init_layernorm(cfg.width, device=device, dtype=dtype),
            "qkv": init_linear(gen, cfg.width, 3 * cfg.width, True, device,
                               dtype),
            "out": init_linear(gen, cfg.width, cfg.width, True, device, dtype),
            "mlp_fc": init_linear(gen, cfg.width, hidden, True, device, dtype),
            "mlp_proj": init_linear(gen, hidden, cfg.width, True, device,
                                    dtype),
        })
    return params


def _patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, P, 3*patch*patch), flatten order (c, ph, pw)."""
    b, c, h, w = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * patch * patch)


def _block(p: dict, x: torch.Tensor, heads: int, act) -> torch.Tensor:
    h = layernorm(p["ln_1"], x)
    q, k, v = linear(p["qkv"], h).chunk(3, dim=-1)
    q, k, v = (split_heads(t, heads) for t in (q, k, v))
    x = x + linear(p["out"], merge_heads(dot_attention(q, k, v)))
    h = layernorm(p["ln_2"], x)
    return x + linear(p["mlp_proj"], act(linear(p["mlp_fc"], h)))


def _prologue(params: dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    if x.shape[-1] % cfg.patch_size:
        raise ValueError(f"input {x.shape[-1]} not a multiple of patch "
                         f"{cfg.patch_size}")
    b = x.shape[0]
    h = _patchify(x, cfg.patch_size) @ params["patch_embed"]["w"].to(x.dtype)
    cls = params["class_embedding"].to(x.dtype).expand(b, 1, cfg.width)
    h = torch.cat([cls, h], dim=1)
    pos = params["positional_embedding"]
    if pos.shape[0] != h.shape[1]:
        raise NotImplementedError(
            "variable-resolution input (resize_pos_embed) is not ported")
    return layernorm(params["ln_pre"], h + pos.to(x.dtype))


def _tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """The JAX tower's ``jax.nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _act(cfg: ViTConfig):
    return quick_gelu if cfg.use_quick_gelu else _tanh_gelu


def vit_forward(params: dict, x: torch.Tensor, cfg: ViTConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, 3, H, W) -> (pooled CLS, tokens (B, P, width)) after ln_post."""
    h = _prologue(params, x, cfg)
    for blk in params["blocks"]:
        h = _block(blk, h, cfg.heads, _act(cfg))
    h = layernorm(params["ln_post"], h)
    return h[:, 0], h[:, 1:]


def stack_vit_blocks(params: dict, dtype=None) -> dict:
    return stack_layer_tree(params["blocks"], dtype)


def vit_forward_stacked(params: dict, stacked_blocks: dict, x: torch.Tensor,
                        cfg: ViTConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """vit_forward over stacked (L, ...) block weights; ``params`` supplies
    the non-block leaves."""
    h = _prologue(params, x, cfg)
    n = stacked_blocks["ln_1"]["scale"].shape[0]
    for i in range(n):
        h = _block(layer_slice(stacked_blocks, i), h, cfg.heads, _act(cfg))
    h = layernorm(params["ln_post"], h)
    return h[:, 0], h[:, 1:]
