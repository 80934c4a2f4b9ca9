"""Truncated MPT decoder blocks with interleaved gated cross-attention.

MPT block = pre-LN attention (fused Wqkv, ALiBi bias, no biases when
``no_bias``) + pre-LN exact-GELU MLP, residual both times.  The stacked
variant selects layer ``i`` of (L, ...) weights: its four big products go
through the layer-indexed kernels (K2, or K3 / K4 for int8 / int4 weights)
with a device-side index, the small LayerNorm leaves are sliced on the
host.  ``decoder_forward`` runs every layer over the unstacked weights and
returns all layer outputs (training and calibration); with
``cfg.remat_layers`` each layer's activations are recomputed in the
backward pass (``remat_layers_fn``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from deer_vla_tpu_torch.core.config import DeerConfig, MPTConfig
from deer_vla_tpu_torch.models.gated_xattn import (gated_xattn_forward,
                                                   init_gated_xattn)
from deer_vla_tpu_torch.ops.alibi import causal_padding_bias, full_attn_bias
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
    indexed_matmul, indexed_matmul_q4, indexed_matmul_q8)
from deer_vla_tpu_torch.ops.layers import (embedding, gelu, init_layernorm,
                                           init_linear, layer_slice,
                                           layernorm, linear, trunc_normal)


def init_mpt_block(gen, cfg: MPTConfig, device="cpu",
                   dtype=torch.float32) -> dict:
    bias = not cfg.no_bias
    d = cfg.d_model

    def lin(i, o):
        return init_linear(gen, i, o, bias, device, dtype, init="normal02")

    p = {"ln_1": init_layernorm(d, bias, device, dtype),
         "wqkv": lin(d, 3 * d),
         "out_proj": lin(d, d),
         "ln_2": init_layernorm(d, bias, device, dtype),
         "mlp_up": lin(d, cfg.mlp_ratio * d),
         "mlp_down": lin(cfg.mlp_ratio * d, d)}
    if cfg.qk_ln:
        p["q_ln"] = init_layernorm(d, bias, device, dtype)
        p["k_ln"] = init_layernorm(d, bias, device, dtype)
    return p


def init_decoder(gen, cfg: DeerConfig, device="cpu",
                 dtype=torch.float32) -> dict:
    """wte + [xattn?, block] * n_layers + ln_f (MPT arch only)."""
    mpt = cfg.mpt
    if mpt.arch != "mpt":
        raise NotImplementedError(f"decoder arch {mpt.arch!r} is not ported")
    params = {
        "wte": {"w": trunc_normal((mpt.vocab_size, mpt.d_model), 0.02, gen,
                                  device, dtype)},
        "ln_f": init_layernorm(mpt.d_model, not mpt.no_bias, device, dtype),
        "blocks": [],
        "xattn": [],
    }
    for i in range(mpt.n_layers):
        params["blocks"].append(init_mpt_block(gen, mpt, device, dtype))
        params["xattn"].append(
            init_gated_xattn(gen, mpt.d_model, cfg.vis_dim,
                             cfg.xattn_dim_head, cfg.xattn_heads,
                             cfg.xattn_ff_mult, device, dtype)
            if cfg.has_xattn(i) else None)
    return params


def _attn_mlp(p: dict, x: torch.Tensor, attn_bias: torch.Tensor,
              cfg: MPTConfig, mm) -> torch.Tensor:
    """The block body; ``mm(name, h)`` applies the named big product."""
    q, k, v = mm("wqkv", layernorm(p["ln_1"], x)).chunk(3, dim=-1)
    if "q_ln" in p:
        q = layernorm(p["q_ln"], q)
        k = layernorm(p["k_ln"], k)
    attn = merge_heads(dot_attention(
        split_heads(q, cfg.n_heads), split_heads(k, cfg.n_heads),
        split_heads(v, cfg.n_heads), bias=attn_bias,
        scale=cfg.head_dim ** -0.5))
    x = x + mm("out_proj", attn)
    h = mm("mlp_down", gelu(mm("mlp_up", layernorm(p["ln_2"], x))))
    return x + h


def mpt_block_forward(p: dict, x: torch.Tensor, attn_bias: torch.Tensor,
                      cfg: MPTConfig) -> torch.Tensor:
    return _attn_mlp(p, x, attn_bias, cfg, lambda name, h: linear(p[name], h))


def mpt_block_forward_stacked(stacked: dict, i: int, x: torch.Tensor,
                              attn_bias: torch.Tensor, cfg: MPTConfig,
                              layer_idx: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """mpt_block_forward over STACKED (L, ...) weights at layer ``i``.

    The four big products are routed by the stacked dict's keys, as the
    JAX package routes them: ``w`` -> K2 ``indexed_matmul``, ``q``/``s`` ->
    K3 ``indexed_matmul_q8``, ``q4``/``s4`` -> K4 ``indexed_matmul_q4``,
    each with ``layer_idx`` a 0-dim int32 tensor holding ``i`` on x's device
    (built here when not given); ``s8``/``s48`` (w8a8, w4a8) -> ``linear``
    on the host slice of layer ``i``.  The LayerNorm leaves and biases are
    host slices."""
    if layer_idx is None:
        layer_idx = torch.tensor(i, dtype=torch.int32, device=x.device)
    small = {k: layer_slice(v, i) for k, v in stacked.items()
             if k in ("ln_1", "ln_2", "q_ln", "k_ln")}

    def imm(name, h):
        p = stacked[name]
        if "s8" in p or "s48" in p:
            # w8a8 / w4a8: the layer's slice through linear's int8 products
            y = linear({k: v[i] for k, v in p.items() if k != "b"}, h)
        elif "q4" in p:
            y = indexed_matmul_q4(h, p["q4"], p["s4"], layer_idx)
        elif "q" in p:
            y = indexed_matmul_q8(h, p["q"], p["s"], layer_idx)
        else:
            y = indexed_matmul(h, p["w"], layer_idx)
        if p.get("b") is not None:
            y = y + p["b"][i].to(y.dtype)
        return y

    return _attn_mlp(small, x, attn_bias, cfg, imm)


def embed_tokens(params: dict, input_ids: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    return embedding(params["wte"], input_ids, compute_dtype)


def make_attn_bias(attention_mask: torch.Tensor, cfg: MPTConfig,
                   dtype) -> torch.Tensor:
    """(B, H|1, S, S) fused ALiBi + causal + padding bias in ``dtype``."""
    s = attention_mask.shape[-1]
    if cfg.alibi and cfg.arch == "mpt":
        return full_attn_bias(attention_mask, cfg.n_heads, s,
                              cfg.alibi_bias_max, dtype)
    return causal_padding_bias(attention_mask, s, dtype)


def _layer(params: dict, i: int, x: torch.Tensor, media: torch.Tensor,
           media_locations: Optional[torch.Tensor], attn_bias: torch.Tensor,
           cfg: DeerConfig) -> torch.Tensor:
    """Decoder layer i over the unstacked tree: gated cross-attention (where
    the layer has one), then the MPT block."""
    xp = params["xattn"][i]
    if xp is not None:
        x = gated_xattn_forward(
            xp, x, media, media_locations, heads=cfg.xattn_heads,
            dim_head=cfg.xattn_dim_head,
            only_attend_immediate_media=cfg.only_attend_immediate_media)
    return mpt_block_forward(params["blocks"][i], x, attn_bias, cfg.mpt)


def _save_unbatched_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy='dots'``: keep the
    outputs of matmuls without batch dims (``aten.mm`` / ``aten.addmm``,
    the weight products), recompute everything else (``aten.bmm`` of the
    attention included), as ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`` does."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_layers_fn(cfg: DeerConfig):
    """``_layer`` as ``decoder_forward`` runs it: as is, or (with
    ``cfg.remat_layers``) under ``torch.utils.checkpoint``, recomputing all
    of the layer in the backward ('full') or all but its weight products
    ('dots'); the JAX package's ``jax.checkpoint`` of each layer
    (models/mpt.py:242-247)."""
    if not cfg.remat_layers:
        return _layer
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one of "
                         "'full', 'dots'")
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _save_unbatched_matmuls)

    def layer(*args):
        if not torch.is_grad_enabled():
            return _layer(*args)
        return ckpt.checkpoint(_layer, *args, **kw)
    return layer


def decoder_forward(params: dict, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor, media: torch.Tensor,
                    cfg: DeerConfig,
                    media_locations: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer, as training and calibration run them: (hidden_states
    (n_layers, B, S, D), the last layer's output).  hidden_states[i] is the
    output of layer i (mosaic_gpt_3b.py:424-427); the exit heads read these
    raw outputs, so ``ln_f`` is not applied (flamingo_mpt.py:459,465).  The
    products run through ``linear`` on the unstacked weights, as the JAX
    package computes them outside any Pallas kernel."""
    if cfg.mpt.arch != "mpt":
        raise NotImplementedError(f"decoder arch {cfg.mpt.arch!r} is not "
                                  "ported")
    cdt = cfg.dtypes.cdt
    x = embed_tokens(params, input_ids, cdt)
    if media_locations is None:
        media_locations = input_ids == cfg.media_token_id
    attn_bias = make_attn_bias(attention_mask, cfg.mpt, cdt)
    layer = remat_layers_fn(cfg)
    outs = []
    for i in range(cfg.n_layers):
        x = layer(params, i, x, media, media_locations, attn_bias, cfg)
        outs.append(x)
    return torch.stack(outs), x


def decoder_segment_forward(params: dict, x: torch.Tensor,
                            attention_mask: torch.Tensor, media: torch.Tensor,
                            cfg: DeerConfig, start: int, stop: int,
                            media_locations: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers [start, stop) on the unstacked tree from an embedded input:
    (the input of layer stop-1, the output of layer stop-1).  The first is
    what the first exit's pseudo action reads (value_net.py:122-126).  The
    products run through ``linear`` on per-layer weights, as the JAX
    package's segment programs do, so none of K2-K4 runs here."""
    attn_bias = make_attn_bias(attention_mask, cfg.mpt, x.dtype)
    x_prev = x
    for i in range(start, stop):
        x_prev = x
        x = _layer(params, i, x, media, media_locations, attn_bias, cfg)
    return x_prev, x
