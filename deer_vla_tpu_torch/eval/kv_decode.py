"""KV-cached greedy decoding for the VL harness (the JAX package's
``eval/kv_decode.py``).

The recompute engine (``eval/vl_eval.greedy_generate``) re-runs the decoder
over the whole (S + T_new) buffer every step.  This engine runs one prefill
over the buffer that also keeps every layer's K / V, (B, H, T, Dh) a layer,
then attends each new token against that cache: per-token work O((S + T) L)
instead of O((S + T)^2 L).  The prefill's attention goes through
``ops.attention.dot_attention``, so a buffer of 128 tokens or more reaches
K1; the one-row decode stays on the plain path, as in JAX.

  - ALiBi's per-key form ``(j - S + 1) * slope`` (``ops/alibi.py``) does
    not depend on the query position under softmax's shift invariance, so
    the decode reuses one (1, H, 1, T) bias row.
  - Causality comes from the running validity mask: a buffer position is
    attended to once written (prompt or generated), which is the buffer
    protocol's ``mask``.
  - The cross-attention needs no cache: a generated token's media time is
    its row's media count (every <image> precedes the prompt's end), passed
    as ``text_time``.

llama decoders (RoPE rotates at absolute positions inside the block) stay on
the recompute engine: ``supports_kv_cache``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.eval.vl_eval import (generated_rows, prompt_buffer,
                                             write_token)
from deer_vla_tpu_torch.models.flamingo import encode_vision
from deer_vla_tpu_torch.models.gated_xattn import (NEG_INF,
                                                   gated_xattn_forward)
from deer_vla_tpu_torch.models.mpt import (embed_tokens, lm_logits,
                                           make_attn_bias)
from deer_vla_tpu_torch.ops.alibi import alibi_bias
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.layers import gelu, layernorm, linear


def supports_kv_cache(cfg: DeerConfig) -> bool:
    return cfg.mpt.arch == "mpt"


def _mpt_qkv(p: dict, h: torch.Tensor, cfg: DeerConfig):
    """The MPT block's fused QKV projection (+ qk_ln), split into heads."""
    q, k, v = linear(p["wqkv"], h).chunk(3, dim=-1)
    if "q_ln" in p:
        q = layernorm(p["q_ln"], q)
        k = layernorm(p["k_ln"], k)
    n = cfg.mpt.n_heads
    return split_heads(q, n), split_heads(k, n), split_heads(v, n)


def _block_rest(p: dict, x: torch.Tensor, attn: torch.Tensor
                ) -> torch.Tensor:
    """The block after its attention: output projection, residual, MLP."""
    x = x + linear(p["out_proj"], merge_heads(attn))
    h = layernorm(p["ln_2"], x)
    return x + linear(p["mlp_down"], gelu(linear(p["mlp_up"], h)))


def _block_prefill(p: dict, x: torch.Tensor, attn_bias: torch.Tensor,
                   cfg: DeerConfig):
    """``mpt_block_forward`` that also returns the layer's (k, v)."""
    q, k, v = _mpt_qkv(p, layernorm(p["ln_1"], x), cfg)
    attn = dot_attention(q, k, v, bias=attn_bias,
                         scale=cfg.mpt.head_dim ** -0.5)
    return _block_rest(p, x, attn), k, v


def _block_decode(p: dict, x_t: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, rows: torch.Tensor, pos_c: torch.Tensor,
                  bias: torch.Tensor, cfg: DeerConfig) -> torch.Tensor:
    """One-token block step: the token's k / v written into the cache at
    its position (in place), its q attended against the whole cache.
    x_t (B, 1, D); ck / cv (B, H, T, Dh); bias (B, H|1, 1, T)."""
    q, k, v = _mpt_qkv(p, layernorm(p["ln_1"], x_t), cfg)
    ck[rows, :, pos_c] = k[:, :, 0]
    cv[rows, :, pos_c] = v[:, :, 0]
    attn = dot_attention(q, ck, cv, bias=bias,
                         scale=cfg.mpt.head_dim ** -0.5)
    return _block_rest(p, x_t, attn)


def _alibi_key_bias(cfg: DeerConfig, total: int, dtype, device
                    ) -> Optional[torch.Tensor]:
    """(1, H, 1, T) per-key ALiBi row (query independent; module note)."""
    if not (cfg.mpt.alibi and cfg.mpt.arch == "mpt"):
        return None
    return alibi_bias(cfg.mpt.n_heads, total, cfg.mpt.alibi_bias_max, dtype,
                      device)


def _xattn(dec: dict, i: int, x: torch.Tensor, media: torch.Tensor,
           cfg: DeerConfig, media_locations=None, text_time=None
           ) -> torch.Tensor:
    xp = dec["xattn"][i]
    if xp is None:
        return x
    return gated_xattn_forward(
        xp, x, media, media_locations, heads=cfg.xattn_heads,
        dim_head=cfg.xattn_dim_head,
        only_attend_immediate_media=cfg.only_attend_immediate_media,
        text_time=text_time)


@torch.no_grad()
def greedy_generate_cached(params: dict, cfg: DeerConfig,
                           vision_x: torch.Tensor, prompt_ids, prompt_mask,
                           max_new_tokens: int = 10,
                           eos_id: Optional[int] = None,
                           logits_out: Optional[list] = None) -> np.ndarray:
    """``eval/vl_eval.greedy_generate``'s contract (the buffer, per-row
    decode starts, the eos trim, ``logits_out``) on the cached engine."""
    if not supports_kv_cache(cfg):
        raise ValueError("kv-cache decode supports the mpt arch; a "
                         f"{cfg.mpt.arch} decoder uses the recompute engine")
    dev = vision_x.device
    cdt = cfg.dtypes.cdt
    dec = params["decoder"]
    ids, mask, start_lens = prompt_buffer(prompt_ids, prompt_mask,
                                          max_new_tokens, dev)
    media = encode_vision(params, vision_x, None, cfg)
    b, total = ids.shape
    rows = torch.arange(b, device=dev)
    starts = torch.from_numpy(start_lens).to(dev)
    media_locations = ids == cfg.media_token_id
    n_media = media_locations.sum(-1)  # (B,) media a row

    # prefill: one forward over the buffer that keeps each layer's K / V
    attn_bias = make_attn_bias(mask, cfg.mpt, cdt)
    x = embed_tokens(dec, ids, cdt)
    cks, cvs = [], []
    for i in range(cfg.n_layers):
        x = _xattn(dec, i, x, media, cfg, media_locations=media_locations)
        x, k, v = _block_prefill(dec["blocks"][i], x, attn_bias, cfg)
        cks.append(k)
        cvs.append(v)
    logits = lm_logits(dec, x[rows, starts - 1], cdt, arch=cfg.mpt.arch)
    if logits_out is not None:
        logits_out.append(logits)
    write_token(ids, mask, rows, starts, logits.argmax(-1))

    alibi_row = _alibi_key_bias(cfg, total, cdt, dev)
    zero = torch.zeros((), dtype=cdt, device=dev)
    for j in range(1, max_new_tokens):
        pos_c = starts + j - 1  # the token written last step
        x_t = embed_tokens(dec, ids[rows, pos_c][:, None], cdt)
        bias = torch.where(mask[:, None, None, :] > 0, zero,
                           torch.tensor(NEG_INF, dtype=cdt, device=dev))
        if alibi_row is not None:
            bias = bias + alibi_row
        for i in range(cfg.n_layers):
            x_t = _xattn(dec, i, x_t, media, cfg, text_time=n_media[:, None])
            x_t = _block_decode(dec["blocks"][i], x_t, cks[i], cvs[i], rows,
                                pos_c, bias, cfg)
        logits = lm_logits(dec, x_t[:, 0], cdt, arch=cfg.mpt.arch)
        if logits_out is not None:
            logits_out.append(logits)
        write_token(ids, mask, rows, starts + j, logits.argmax(-1))
    return generated_rows(ids, start_lens, max_new_tokens, eos_id)
