"""CLIP ViT visual tower (open_clip "ViT-L-14").

The per-patch tokens after ``ln_post`` feed the perceiver.  The patch
embedding is the stride-14 convolution written as a (B, P, c*ph*pw) x
(c*ph*pw, width) matmul, with the JAX package's flatten order (c, ph, pw).
The self-attention goes through ``ops.attention.dot_attention``, which sends
the 257-token blocks to the fused kernel K1.  ``vit_forward_tome`` merges
patch tokens between attention and MLP (``ops/tome.py``); its layers after
the first merge hand K1 a proportional-attention bias at a query length
that shrinks every layer.
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
from deer_vla_tpu_torch.ops.tome import (bipartite_merge,
                                         proportional_attn_bias,
                                         tome_schedule)


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


def resize_pos_embed(pos: torch.Tensor, new_patches: int) -> torch.Tensor:
    """(1+P0, D) position table -> (1+P, D): the patch rows bilinearly
    interpolated on the grid in fp32, antialiased when the grid shrinks, as
    ``jax.image.resize(method="linear")`` computes it; the CLS row kept.
    Lets the shared tower run the gripper camera at its native size
    (cfg.gripper_res)."""
    p0 = pos.shape[0] - 1
    g0 = int(round(p0 ** 0.5))
    g1 = int(round(new_patches ** 0.5))
    if g0 * g0 != p0 or g1 * g1 != new_patches:
        raise ValueError(f"position table of {p0} patches and {new_patches} "
                         "patches are not both square grids")
    grid = pos[1:].float().reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(g1, g1), mode="bilinear",
                         align_corners=False, antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(g1 * g1, -1)
    return torch.cat([pos[:1], grid.to(pos.dtype)], dim=0)


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
        # a camera at another resolution (the native-size gripper)
        pos = resize_pos_embed(pos, h.shape[1] - 1)
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


def _block_tome(p: dict, x: torch.Tensor, sizes: torch.Tensor, heads: int,
                act, r: int, any_merged: bool):
    """One block with ToMe merging between attention and MLP.  x (B, 1+n,
    D) with CLS at 0, sizes (B, n); returns (x', sizes') with n' = n - r.
    Until the first merge every size is 1, so ``any_merged`` False passes
    no bias and those layers equal ``_block`` bit for bit."""
    h = layernorm(p["ln_1"], x)
    q, k, v = linear(p["qkv"], h).chunk(3, dim=-1)
    q, k, v = (split_heads(t, heads) for t in (q, k, v))
    bias = None
    if any_merged:
        bias = proportional_attn_bias(
            torch.cat([torch.ones_like(sizes[:, :1]), sizes], dim=1),
            x.shape[1])
    x = x + linear(p["out"], merge_heads(dot_attention(q, k, v, bias=bias)))
    if r > 0:
        metric = k.mean(dim=1)  # (B, 1+n, head_dim): the mean attention key
        patches, sizes = bipartite_merge(x[:, 1:], metric[:, 1:], sizes, r)
        x = torch.cat([x[:, :1], patches], dim=1)
    h = layernorm(p["ln_2"], x)
    return x + linear(p["mlp_proj"], act(linear(p["mlp_fc"], h))), sizes


def vit_forward_tome(params: dict, x: torch.Tensor, cfg: ViTConfig,
                     stacked_blocks: dict = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vit_forward`` with ``cfg.tome_r`` patch tokens merged a layer;
    with ``stacked_blocks`` the (L, ...) serving stack is sliced a layer.
    Returns (pooled CLS, tokens (B, P - sum(schedule), width))."""
    h = _prologue(params, x, cfg)
    schedule = tome_schedule(cfg.num_patches, cfg.layers, cfg.tome_r)
    sizes = torch.ones(h.shape[0], cfg.num_patches, device=h.device)
    any_merged = False
    for i in range(cfg.layers):
        blk = (params["blocks"][i] if stacked_blocks is None
               else layer_slice(stacked_blocks, i))
        h, sizes = _block_tome(blk, h, sizes, cfg.heads, _act(cfg),
                               schedule[i], any_merged)
        any_merged = any_merged or schedule[i] > 0
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
