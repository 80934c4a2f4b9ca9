"""The fc and gpt action heads (the JAX package's ``models/alt_heads.py``;
the reference's FCDecoder, action_head.py:317-405, and GPTDecoder,
:624-728, with its trajectory_gpt2.py backbone: 8 layers, 8 heads, learned
position embeddings, causal).

The gpt head's streaming mode keeps a history buffer of the last
``history_len`` frames' features with a per-stream frame count
(``GPTCarry``), so one stream can be reset without touching the others.
Its attention goes through ``ops/attention.dot_attention``: at the
history's 12 query rows that is the plain einsum path, as the JAX package
takes its XLA path below 128 rows.  Dropout masks come from an
``ops/dropout.Dropout``, asked for in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.core.config import HeadConfig
from deer_vla_tpu_torch.models.action_head import (HeadOutput,
                                                   _init_mlp_head,
                                                   _mlp_head_forward,
                                                   pool_tokens)
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.layers import (init_layernorm, init_linear,
                                           layernorm, linear, trunc_normal)


def _drop(x: torch.Tensor, rate: float, dropout: Optional[Dropout]
          ) -> torch.Tensor:
    return x if dropout is None or rate <= 0.0 else dropout(x, rate)


# ---------------------------------------------------------------------------
# FCDecoder (action_head.py:317-405)
# ---------------------------------------------------------------------------


def init_fc_decoder(gen, cfg: HeadConfig, device="cpu",
                    dtype=torch.float32) -> dict:
    """FCDecoder's tree.  With ``use_state`` it takes the JAX package's
    working semantics: fc_state (7 -> 1024 -> 512 -> 128) on the proprio
    rows, concatenated to the pooled features, and the action / gripper
    MLPs sized hidden + 128.  (The reference declares fc_state but its
    construction raises and its forward concatenates after the pool, so
    its fc + state path is dead code; the JAX docstring has the details.)"""
    mcfg = (dataclasses.replace(cfg, hidden_size=cfg.hidden_size + 128)
            if cfg.use_state else cfg)
    d = cfg.in_features
    p = {
        "fc1": init_linear(gen, d, d // 2, True, device, dtype),
        "fc2": init_linear(gen, d // 2, cfg.hidden_size, True, device, dtype),
        "actions": _init_mlp_head(
            gen, mcfg, cfg.out_features * cfg.multi_step_action, device,
            dtype),
        "gripper": _init_mlp_head(gen, mcfg, cfg.multi_step_action, device,
                                  dtype),
    }
    if cfg.use_state:
        p["fc_state"] = {
            "l1": init_linear(gen, 7, 1024, True, device, dtype),
            "l2": init_linear(gen, 1024, 512, True, device, dtype),
            "l3": init_linear(gen, 512, 128, True, device, dtype),
        }
    return p


def fc_decoder_forward(p: dict, feat: torch.Tensor, cfg: HeadConfig,
                       window: Optional[int] = None,
                       state: Optional[torch.Tensor] = None,
                       dropout: Optional[Dropout] = None) -> HeadOutput:
    """feat (B*W, lang_len, d): MLP, then max-pool over tokens (the
    reference pools after the MLP, action_head.py:387-388), then the heads.
    ``dropout`` (training) drops before fc1 and before fc2, then inside the
    arm MLP, then the gripper MLP."""
    w = window or cfg.window_size
    h = _drop(feat, cfg.dropout, dropout)
    h = torch.relu(linear(p["fc1"], h))
    h = _drop(h, cfg.dropout, dropout)
    h = pool_tokens(linear(p["fc2"], h), "max")
    h = h.reshape(-1, w, h.shape[-1])
    if cfg.use_state and state is not None and "fc_state" in p:
        s = state.reshape(-1, state.shape[-1])
        s7 = torch.cat([s[:, :6], s[:, -1:]], -1).to(h.dtype)
        fs = p["fc_state"]
        se = torch.relu(linear(fs["l1"], s7))
        se = torch.relu(linear(fs["l2"], se))
        se = linear(fs["l3"], se)
        h = torch.cat([h, se.reshape(-1, w, se.shape[-1])], -1)
    act = torch.tanh(_mlp_head_forward(p["actions"], h, cfg, dropout))
    glog = _mlp_head_forward(p["gripper"], h, cfg, dropout)
    return HeadOutput(act, torch.sigmoid(glog), glog)


# ---------------------------------------------------------------------------
# GPTDecoder (action_head.py:624-728 + trajectory_gpt2.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GPTDecoderConfig:
    head: HeadConfig = HeadConfig()
    hidden_size: Optional[int] = None
    n_layer: int = 8
    n_head: int = 8
    history_len: Optional[int] = None
    use_pe: bool = True
    # GPT2Config's embd / attn / resid_pdrop (trajectory_gpt2.py:730-744)
    dropout: float = 0.1

    @property
    def dim(self) -> int:
        return self.hidden_size or self.head.in_features

    @property
    def hist(self) -> int:
        return self.history_len or self.head.window_size


def _head_cfg_with_hidden(cfg: GPTDecoderConfig) -> HeadConfig:
    return dataclasses.replace(cfg.head, hidden_size=cfg.dim)


def init_gpt_decoder(gen, cfg: GPTDecoderConfig, device="cpu",
                     dtype=torch.float32) -> dict:
    """The GPT head's tree: ``wpe`` (None without ``use_pe``), ``ln_f``,
    ``blocks`` (a list), the arm / gripper MLPs and, when the backbone's
    width differs from the features', the ``fc`` projection."""
    d = cfg.dim
    hcfg = _head_cfg_with_hidden(cfg)
    p = {
        "wpe": (trunc_normal((cfg.hist, d), 0.02, gen, device, dtype)
                if cfg.use_pe else None),
        "ln_f": init_layernorm(d, device=device, dtype=dtype),
        "blocks": [],
        "actions": _init_mlp_head(
            gen, hcfg, cfg.head.out_features * cfg.head.multi_step_action,
            device, dtype),
        "gripper": _init_mlp_head(gen, hcfg, cfg.head.multi_step_action,
                                  device, dtype),
    }
    if cfg.dim != cfg.head.in_features:
        p["fc"] = init_linear(gen, cfg.head.in_features, d, True, device,
                              dtype)
    for _ in range(cfg.n_layer):
        p["blocks"].append({
            "ln_1": init_layernorm(d, device=device, dtype=dtype),
            "qkv": init_linear(gen, d, 3 * d, True, device, dtype),
            "out": init_linear(gen, d, d, True, device, dtype),
            "ln_2": init_layernorm(d, device=device, dtype=dtype),
            "mlp_fc": init_linear(gen, d, 4 * d, True, device, dtype),
            "mlp_proj": init_linear(gen, 4 * d, d, True, device, dtype),
        })
    return p


def _gpt_backbone(p: dict, x: torch.Tensor, cfg: GPTDecoderConfig,
                  valid: Optional[torch.Tensor] = None,
                  dropout: Optional[Dropout] = None) -> torch.Tensor:
    """x (B, T, d): the causal GPT-2 stack; ``valid`` (B, T) masks the
    history slots not filled yet.  Dropout as the JAX package places it:
    after the position add, on the attention output (the JAX package folds
    attn_pdrop there), after the output projection and after the MLP."""
    b, t, d = x.shape
    if p.get("wpe") is not None:
        x = x + p["wpe"][:t].to(x.dtype)
    x = _drop(x, cfg.dropout, dropout)
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    if valid is not None:
        causal = causal & valid[:, None, :]
        bias = torch.where(causal[:, None], 0.0, -1e9).float()
    else:
        bias = torch.where(causal, 0.0, -1e9).float()[None, None]
    for blk in p["blocks"]:
        h = layernorm(blk["ln_1"], x)
        q, k, v = linear(blk["qkv"], h).split(d, dim=-1)
        q, k, v = (split_heads(z, cfg.n_head) for z in (q, k, v))
        a = merge_heads(dot_attention(q, k, v, bias=bias))
        a = _drop(a, cfg.dropout, dropout)
        o = _drop(linear(blk["out"], a), cfg.dropout, dropout)
        x = x + o
        h = layernorm(blk["ln_2"], x)
        m = linear(blk["mlp_proj"],
                   F.gelu(linear(blk["mlp_fc"], h), approximate="tanh"))
        x = x + _drop(m, cfg.dropout, dropout)
    return layernorm(p["ln_f"], x)


def _heads(p: dict, y: torch.Tensor, cfg: GPTDecoderConfig,
           dropout: Optional[Dropout] = None) -> HeadOutput:
    hcfg = _head_cfg_with_hidden(cfg)
    act = torch.tanh(_mlp_head_forward(p["actions"], y, hcfg, dropout))
    glog = _mlp_head_forward(p["gripper"], y, hcfg, dropout)
    return HeadOutput(act, torch.sigmoid(glog), glog)


def gpt_decoder_forward(p: dict, feat: torch.Tensor, cfg: GPTDecoderConfig,
                        window: Optional[int] = None,
                        last_action: bool = False,
                        dropout: Optional[Dropout] = None) -> HeadOutput:
    """Window mode: feat (B*W, lang_len, d) or (B*W, d) -> per-step
    actions (B, W, .), the last step's only with ``last_action``."""
    w = window or cfg.head.window_size
    x = pool_tokens(feat, cfg.head.pooling) if feat.ndim == 3 else feat
    x = x.reshape(-1, w, x.shape[-1])
    if "fc" in p:
        x = linear(p["fc"], x)
    y = _gpt_backbone(p, x, cfg, dropout=dropout)
    if last_action:
        y = y[:, -1:, :]
    return _heads(p, y, cfg, dropout)


class GPTCarry(NamedTuple):
    history: torch.Tensor  # (B, hist_len, d)
    count: torch.Tensor    # (B,) int32 frames seen, per stream


def gpt_zero_carry(cfg: GPTDecoderConfig, batch: int, dtype=torch.float32,
                   device="cpu") -> GPTCarry:
    return GPTCarry(torch.zeros(batch, cfg.hist, cfg.dim, dtype=dtype,
                                device=device),
                    torch.zeros(batch, dtype=torch.int32, device=device))


def gpt_decoder_step(p: dict, feat: torch.Tensor, carry: GPTCarry,
                     cfg: GPTDecoderConfig) -> Tuple[HeadOutput, GPTCarry]:
    """Streaming: push the new frame into each stream's history (its own
    insert slot until the buffer is full, then a roll that drops the
    oldest frame), attend over the filled slots and act from each stream's
    last filled one (action_head.py:702-719)."""
    x = pool_tokens(feat, cfg.head.pooling) if feat.ndim == 3 else feat
    if "fc" in p:
        x = linear(p["fc"], x)
    hist, count = carry
    slots = torch.arange(cfg.hist, device=x.device)
    full = count >= cfg.hist                                   # (B,)
    shifted = torch.cat([hist[:, 1:], x[:, None].to(hist.dtype)], 1)
    pos = torch.clamp(count, max=cfg.hist - 1)                 # insert slot
    onehot = slots[None, :] == pos[:, None]
    inserted = torch.where(onehot[:, :, None], x[:, None].to(hist.dtype),
                           hist)
    hist = torch.where(full[:, None, None], shifted, inserted)
    count = torch.clamp(count + 1, max=cfg.hist)
    valid = slots[None, :] < count[:, None]                    # (B, hist)
    y = _gpt_backbone(p, hist, cfg, valid)
    idx = torch.clamp(count.long() - 1, 0, cfg.hist - 1)
    y_last = y[torch.arange(y.shape[0], device=y.device), idx][:, None]
    return _heads(p, y_last, cfg), GPTCarry(hist, count)
