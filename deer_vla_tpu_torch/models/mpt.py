"""Truncated decoder blocks with interleaved gated cross-attention.

The decoder is an MPT stack or, for ``arch="llama"`` (BCFlamingo), a llama
stack (``models/llama.py``; RMSNorm, RoPE, SwiGLU, and an untied LM head
beside ``wte``). MPT block = pre-LN attention (fused Wqkv, ALiBi bias, no
biases when ``no_bias``) + pre-LN exact-GELU MLP, residual both times. The
stacked variant selects layer ``i`` of (L, ...) weights: its four big
products go through the layer-indexed kernels (K2, or K3 / K4 for int8 /
int4 weights) with a device-side index, the small LayerNorm leaves are
sliced on the host. ``decoder_forward`` runs every layer over the unstacked
weights and returns all layer outputs (training and calibration); with
``cfg.remat_layers`` each layer's activations are recomputed in the
backward pass (``remat_layers_fn``).

Tensor parallelism (``tp``, this rank's ``parallel.mesh.AxisGroup`` of the
tp axis, None for one process): the weights are the rank's local shards
(``parallel/sharding``): wqkv and mlp_up hold its output columns (wqkv
grouped by heads), out_proj and mlp_down its input rows.  The rank runs
its n_heads / tp heads with their slice of the ALiBi bias; out_proj and
mlp_down are summed over the group, their biases added once after the sum
(Megatron).  A llama block's leaves match no tp rule and stay replicated,
as in the JAX package; its cross-attention layers are split all the same.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from deer_vla_tpu_torch.core.config import DeerConfig, MPTConfig
from deer_vla_tpu_torch.models.gated_xattn import (gated_xattn_forward,
                                                   init_gated_xattn)
from deer_vla_tpu_torch.models.llama import (init_llama_block, init_rmsnorm,
                                             llama_block_forward, rmsnorm)
from deer_vla_tpu_torch.ops.alibi import causal_padding_bias, full_attn_bias
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
    indexed_matmul, indexed_matmul_q4, indexed_matmul_q8)
from deer_vla_tpu_torch.ops.layers import (embedding, gelu, init_layernorm,
                                           init_linear, layer_slice,
                                           layernorm, linear,
                                           row_parallel_linear, trunc_normal)
from deer_vla_tpu_torch.parallel.collectives import (copy_to_tp,
                                                     reduce_from_tp)
from deer_vla_tpu_torch.parallel.sharding import tp_local

# the block's column-parallel products under tp, with the number of
# products each fuses (out_proj and mlp_down are row-parallel)
_COL_PRODUCTS = {"wqkv": 3, "mlp_up": 1}


def tp_size(tp) -> int:
    return 1 if tp is None else tp.size


def local_heads(n_heads: int, tp) -> range:
    """The heads this tp rank runs (all of them without tp)."""
    n = tp_size(tp)
    if n_heads % n:
        raise ValueError(f"{n_heads} heads do not split over tp={n}")
    i = 0 if tp is None else tp.index
    return range(i * n_heads // n, (i + 1) * n_heads // n)


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
    """wte + [xattn?, block] * n_layers + ln_f; llama adds its final
    RMSNorm ``norm_f`` and the untied ``lm_head_w`` (JAX mpt.py:73-84)."""
    mpt = cfg.mpt
    if mpt.arch not in ("mpt", "llama"):
        raise ValueError(f"unknown decoder arch {mpt.arch!r}")
    llama = mpt.arch == "llama"
    params = {
        "wte": {"w": trunc_normal((mpt.vocab_size, mpt.d_model), 0.02, gen,
                                  device, dtype)},
        "ln_f": init_layernorm(mpt.d_model, not mpt.no_bias, device, dtype),
        "blocks": [],
        "xattn": [],
    }
    if llama:
        params["norm_f"] = init_rmsnorm(mpt.d_model, device, dtype)
        params["lm_head_w"] = init_linear(gen, mpt.d_model, mpt.vocab_size,
                                          False, device, dtype)
    for i in range(mpt.n_layers):
        params["blocks"].append(
            init_llama_block(gen, mpt, device, dtype) if llama
            else init_mpt_block(gen, mpt, device, dtype))
        params["xattn"].append(
            init_gated_xattn(gen, mpt.d_model, cfg.vis_dim,
                             cfg.xattn_dim_head, cfg.xattn_heads,
                             cfg.xattn_ff_mult, device, dtype)
            if cfg.has_xattn(i) else None)
    return params


def _attn_mlp(p: dict, x: torch.Tensor, attn_bias: torch.Tensor,
              cfg: MPTConfig, mm: "_Products", tp=None) -> torch.Tensor:
    """The block body; ``mm`` applies the named big products (under
    ``tp`` on this rank's shards)."""
    heads = len(local_heads(cfg.n_heads, tp))
    if tp_size(tp) > 1 and "q_ln" in p:
        raise NotImplementedError("qk_ln normalizes all of q's heads at "
                                  "once; it does not split over tp")
    q, k, v = mm.col("wqkv", layernorm(p["ln_1"], x)).chunk(3, dim=-1)
    if "q_ln" in p:
        q = layernorm(p["q_ln"], q)
        k = layernorm(p["k_ln"], k)
    attn = merge_heads(dot_attention(
        split_heads(q, heads), split_heads(k, heads),
        split_heads(v, heads), bias=attn_bias,
        scale=cfg.head_dim ** -0.5))
    x = x + mm.row("out_proj", attn)
    h = mm.row("mlp_down", gelu(mm.col("mlp_up", layernorm(p["ln_2"], x))))
    return x + h


class _Products:
    """A block's big products.  ``product(name, h)`` is the product without
    its bias and ``layer(name)`` the layer's linear dict (bias ``b``
    whole).  ``col`` is a column-parallel product: its input marked for
    the backward's tp sum, its rank's columns of the bias added.  ``row``
    a row-parallel one: summed over the tp group, then the bias; the w8a8
    modes through ``row_parallel_linear`` (the row's abs-max and the int32
    sum over the group).  Without tp both are the plain product."""

    def __init__(self, product, layer, tp):
        self.product, self.layer, self.tp = product, layer, tp

    def _bias(self, name, y, chunks=None):
        b = self.layer(name).get("b")
        if b is None:
            return y
        if chunks is not None:
            b = tp_local(b, self.tp, -1, chunks)
        return y + b.to(y.dtype)

    def col(self, name, h):
        return self._bias(name, self.product(name, copy_to_tp(h, self.tp)),
                          _COL_PRODUCTS[name])

    def row(self, name, h):
        lin = self.layer(name)
        if tp_size(self.tp) > 1 and ("s8" in lin or "s48" in lin):
            return row_parallel_linear(lin, h, self.tp)
        return self._bias(name, reduce_from_tp(self.product(name, h),
                                               self.tp))


def _no_bias(p: dict) -> dict:
    return {k: v for k, v in p.items() if k != "b"}


def mpt_block_forward(p: dict, x: torch.Tensor, attn_bias: torch.Tensor,
                      cfg: MPTConfig, tp=None) -> torch.Tensor:
    """One block over its own (this tp rank's) weights."""
    return _attn_mlp(p, x, attn_bias, cfg, _Products(
        lambda name, h: linear(_no_bias(p[name]), h), p.__getitem__, tp),
        tp)


def mpt_block_forward_stacked(stacked: dict, i: int, x: torch.Tensor,
                              attn_bias: torch.Tensor, cfg: MPTConfig,
                              layer_idx: Optional[torch.Tensor] = None,
                              tp=None) -> torch.Tensor:
    """mpt_block_forward over STACKED (L, ...) weights at layer ``i``.

    The four big products are routed by the stacked dict's keys, as the
    JAX package routes them: ``w`` -> K2 ``indexed_matmul``, ``q``/``s`` ->
    K3 ``indexed_matmul_q8``, ``q4``/``s4`` -> K4 ``indexed_matmul_q4``,
    each with ``layer_idx`` a 0-dim int32 tensor holding ``i`` on x's device
    (built here when not given); ``s8``/``s48`` (w8a8, w4a8) -> ``linear``
    on the host slice of layer ``i``.  The LayerNorm leaves and biases are
    host slices.  Under ``tp`` the stacks are the rank's local (L, K_loc,
    N_loc) stacks, fed to the same kernels."""
    if layer_idx is None:
        layer_idx = torch.tensor(i, dtype=torch.int32, device=x.device)
    small = {k: layer_slice(v, i) for k, v in stacked.items()
             if k in ("ln_1", "ln_2", "q_ln", "k_ln")}

    def imm(name, h):
        p = stacked[name]
        if "s8" in p or "s48" in p:
            # w8a8 / w4a8: the layer's slice through linear's int8 products
            return linear(_no_bias(layer(name)), h)
        if "q4" in p:
            return indexed_matmul_q4(h, p["q4"], p["s4"], layer_idx)
        if "q" in p:
            return indexed_matmul_q8(h, p["q"], p["s"], layer_idx)
        return indexed_matmul(h, p["w"], layer_idx)

    def layer(name):
        return {k: v[i] for k, v in stacked[name].items()}

    return _attn_mlp(small, x, attn_bias, cfg, _Products(imm, layer, tp), tp)


def embed_tokens(params: dict, input_ids: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    return embedding(params["wte"], input_ids, compute_dtype)


def make_attn_bias(attention_mask: torch.Tensor, cfg: MPTConfig,
                   dtype, tp=None) -> torch.Tensor:
    """(B, H|1, S, S) fused ALiBi + causal + padding bias in ``dtype``;
    under ``tp`` over this rank's heads (their slopes of the whole H)."""
    s = attention_mask.shape[-1]
    if cfg.alibi and cfg.arch == "mpt":
        return full_attn_bias(attention_mask, cfg.n_heads, s,
                              cfg.alibi_bias_max, dtype,
                              local_heads(cfg.n_heads, tp)
                              if tp_size(tp) > 1 else None)
    return causal_padding_bias(attention_mask, s, dtype)


def _layer(params: dict, i: int, x: torch.Tensor, media: torch.Tensor,
           media_locations: Optional[torch.Tensor], attn_bias: torch.Tensor,
           cfg: DeerConfig, tp=None) -> torch.Tensor:
    """Decoder layer i over the unstacked tree: gated cross-attention (where
    the layer has one), then the MPT or llama block."""
    xp = params["xattn"][i]
    if xp is not None:
        x = gated_xattn_forward(
            xp, x, media, media_locations, heads=cfg.xattn_heads,
            dim_head=cfg.xattn_dim_head,
            only_attend_immediate_media=cfg.only_attend_immediate_media,
            tp=tp)
    if cfg.mpt.arch == "llama":
        return llama_block_forward(params["blocks"][i], x, attn_bias,
                                   cfg.mpt)
    return mpt_block_forward(params["blocks"][i], x, attn_bias, cfg.mpt, tp)


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
                    media_locations: Optional[torch.Tensor] = None,
                    tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer, as training and calibration run them: (hidden_states
    (n_layers, B, S, D), the last layer's output).  hidden_states[i] is the
    output of layer i (mosaic_gpt_3b.py:424-427); the exit heads read these
    raw outputs, so ``ln_f`` is not applied (flamingo_mpt.py:459,465).  The
    products run through ``linear`` on the unstacked weights, as the JAX
    package computes them outside any Pallas kernel.  ``tp``: this rank's
    shards (the module docstring)."""
    cdt = cfg.dtypes.cdt
    x = embed_tokens(params, input_ids, cdt)
    if media_locations is None:
        media_locations = input_ids == cfg.media_token_id
    attn_bias = make_attn_bias(attention_mask, cfg.mpt, cdt, tp)
    layer = remat_layers_fn(cfg)
    outs = []
    for i in range(cfg.n_layers):
        x = layer(params, i, x, media, media_locations, attn_bias, cfg, tp)
        outs.append(x)
    return torch.stack(outs), x


def lm_logits(params: dict, hidden: torch.Tensor, compute_dtype=None,
              arch: str = "mpt") -> torch.Tensor:
    """Vocabulary logits from the last layer's output (JAX mpt.py:254-272):
    mpt applies ``ln_f`` and the tied ``wte`` transposed; llama its final
    RMSNorm ``norm_f`` and the untied ``lm_head_w`` (flamingo_bc.py:
    252-310).  The action path never calls it (its heads replaced the LM
    head); text generation and scoring do.  A plain product, as in JAX."""
    if arch == "llama" and "norm_f" in params:
        return linear(params["lm_head_w"], rmsnorm(params["norm_f"], hidden))
    h = layernorm(params["ln_f"], hidden)
    w = params["wte"]["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
    return h @ w.t().to(h.dtype)


def decoder_segment_forward(params: dict, x: torch.Tensor,
                            attention_mask: torch.Tensor, media: torch.Tensor,
                            cfg: DeerConfig, start: int, stop: int,
                            media_locations: torch.Tensor, tp=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers [start, stop) on the unstacked tree from an embedded input:
    (the input of layer stop-1, the output of layer stop-1).  The first is
    what the first exit's pseudo action reads (value_net.py:122-126).  The
    products run through ``linear`` on per-layer weights, as the JAX
    package's segment programs do, so none of K2-K4 runs here."""
    attn_bias = make_attn_bias(attention_mask, cfg.mpt, x.dtype, tp)
    x_prev = x
    for i in range(start, stop):
        x_prev = x
        x = _layer(params, i, x, media, media_locations, attn_bias, cfg, tp)
    return x_prev, x
