"""Analytic FLOPs accounting (a copy of the JAX package's ``eval/flops.py``
on the port's config; replaces the reference's thop/fvcore profiling,
flamingo_mpt.py:423-427 and mosaic_gpt_3b.py:401-407).

The compute of one exit is static, so GFLOPs per action is a closed-form
function of the config and the exit layer.  All counts are
multiply-accumulate x 2 (thop's convention for Linear).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from deer_vla_tpu_torch.core.config import (DeerConfig, MPTConfig,
                                            PerceiverConfig, ViTConfig)
from deer_vla_tpu_torch.ops.tome import tome_schedule


def linear_flops(tokens: int, d_in: int, d_out: int) -> int:
    return 2 * tokens * d_in * d_out


def attention_flops(tokens_q: int, tokens_kv: int, dim: int,
                    inner: int) -> int:
    # q/k/v/out projections + 2 * (QK^T and PV)
    proj = (linear_flops(tokens_q, dim, inner)
            + 2 * linear_flops(tokens_kv, dim, inner)
            + linear_flops(tokens_q, inner, dim))
    scores = 2 * tokens_q * tokens_kv * inner * 2
    return proj + scores


def vit_flops(cfg: ViTConfig) -> int:
    """Exact tower, or the ToMe-merged tower when cfg.tome_r > 0: layer i's
    attention runs on the pre-merge token count, its MLP on the post-merge
    count, plus the bipartite similarity matmul."""
    d = cfg.width
    inner = int(d * cfg.mlp_ratio)
    schedule = tome_schedule(cfg.num_patches, cfg.layers, cfg.tome_r)
    total = linear_flops(cfg.num_patches, 3 * cfg.patch_size ** 2, d)
    n = cfg.num_patches
    for r in schedule:
        s = n + 1  # + CLS
        total += attention_flops(s, s, d, d)
        if r > 0:
            total += 2 * ((n + 1) // 2) * (n // 2) * cfg.head_dim
        n -= r
        total += linear_flops(n + 1, d, inner) + linear_flops(n + 1, inner, d)
    return total


def final_vit_tokens(cfg: ViTConfig) -> int:
    """Patch tokens the tower emits: num_patches less the ToMe merges."""
    return cfg.num_patches - sum(tome_schedule(cfg.num_patches, cfg.layers,
                                               cfg.tome_r))


def perceiver_flops(cfg: PerceiverConfig, num_media_tokens: int) -> int:
    n, v, d, inner = cfg.num_latents, num_media_tokens, cfg.dim, cfg.inner_dim
    per_layer = (linear_flops(n, d, inner)              # to_q
                 + linear_flops(v + n, d, 2 * inner)    # to_kv
                 + 2 * 2 * n * (v + n) * inner          # scores + values
                 + linear_flops(n, inner, d)            # out
                 + linear_flops(n, d, d * cfg.ff_mult) * 2)
    return cfg.depth * per_layer


def mpt_layer_flops(cfg: MPTConfig, text_len: int) -> int:
    s, d = text_len, cfg.d_model
    return (linear_flops(s, d, 3 * d) + linear_flops(s, d, d)
            + 2 * 2 * s * s * d
            + linear_flops(s, d, cfg.mlp_ratio * d)
            + linear_flops(s, cfg.mlp_ratio * d, d))


def xattn_layer_flops(cfg: DeerConfig, text_len: int) -> int:
    s, d = text_len, cfg.lang_dim
    m = cfg.num_media_tokens
    inner = cfg.xattn_dim_head * cfg.xattn_heads
    return (linear_flops(s, d, inner) + linear_flops(m, cfg.vis_dim, 2 * inner)
            + 2 * 2 * s * m * inner + linear_flops(s, inner, d)
            + linear_flops(s, d, d * cfg.xattn_ff_mult) * 2)


def head_flops(cfg: DeerConfig) -> int:
    h = cfg.head
    lstm = 0
    d_in = h.in_features
    for _ in range(h.lstm_num_layers):
        lstm += 2 * (d_in + h.hidden_size) * 4 * h.hidden_size
        d_in = h.hidden_size
    dims = ((h.hidden_size,)
            + tuple(h.mlp_hidden_dims[:h.mlp_num_hidden_layers]))
    mlp = 0
    for i in range(len(dims) - 1):
        mlp += 2 * dims[i] * dims[i + 1]
    mlp = 2 * mlp + 2 * dims[-1] * (h.out_features + 1)
    return lstm + mlp


def llm_flops_per_exit(cfg: DeerConfig) -> Dict[int, float]:
    """{exit_layer: LLM GFLOPs}: the paper's headline metric counts only
    the decoder layers, cross-attention included."""
    per_layer = mpt_layer_flops(cfg.mpt, cfg.text_len)
    per_xattn = xattn_layer_flops(cfg, cfg.text_len)
    out = {}
    for e in range(cfg.n_layers):
        total = 0
        for i in range(e + 1):
            total += per_layer + (per_xattn if cfg.has_xattn(i) else 0)
        out[e] = total / 1e9
    return out


def gripper_vit_cfg(cfg: DeerConfig) -> ViTConfig:
    """The ViT config the wrist camera runs: cfg.vit, or with
    cfg.gripper_res the same tower at that resolution with ToMe off."""
    if cfg.gripper_res:
        return dataclasses.replace(cfg.vit, image_size=cfg.gripper_res,
                                   tome_r=0)
    return cfg.vit


def vision_flops(cfg: DeerConfig) -> int:
    """Dual-camera ViT + perceiver FLOPs for one frame."""
    gv = gripper_vit_cfg(cfg)
    return (vit_flops(cfg.vit) + vit_flops(gv)
            + perceiver_flops(cfg.perceiver, final_vit_tokens(cfg.vit))
            + perceiver_flops(cfg.perceiver, final_vit_tokens(gv)))


def full_step_flops(cfg: DeerConfig, exit_layer: int) -> float:
    """GFLOPs for one streaming action at a given exit (2 cameras)."""
    total = vision_flops(cfg)
    total += llm_flops_per_exit(cfg)[exit_layer] * 1e9
    total += head_flops(cfg)
    return total / 1e9


def avg_llm_gflops(cfg: DeerConfig, exit_histogram) -> float:
    """Average LLM GFLOPs per action from an exit-layer histogram
    (bayesian_optimization.py:76-79)."""
    per_exit = llm_flops_per_exit(cfg)
    return float(sum(per_exit[i] * p for i, p in enumerate(exit_histogram)))


def train_step_flops(cfg: DeerConfig) -> float:
    """Analytic GFLOPs per sample (one window_size-frame trajectory) of one
    multi-exit train step: 3 x forward, where the forward is W frames of
    dual-camera vision + full-depth LLM plus the head applications (final,
    the two random-exit samplings, one per internal exit).  Remat is not
    counted (the standard MFU definition)."""
    w = cfg.window_size
    fwd_frame = (vision_flops(cfg)
                 + llm_flops_per_exit(cfg)[cfg.n_layers - 1] * 1e9)
    n_heads = 3 + (len(cfg.exit_layer_ids()) if cfg.multi_exit else 0)
    fwd = w * (fwd_frame + n_heads * head_flops(cfg))
    return 3 * fwd / 1e9


def paper_convention_gflops(cfg: DeerConfig, exit_layer: int,
                            text_len: int = 13) -> float:
    """LLM GFLOPs in the paper's convention (Table 2): thop counts MACs and
    the rollout text is unpadded (about 13 tokens a CALVIN instruction)."""
    c = dataclasses.replace(cfg, text_len=text_len)
    return llm_flops_per_exit(c)[exit_layer] / 2.0
