"""Deterministic LSTM action head (action_head.py:408-611).

(B, lang_len, d) --max-pool over tokens--> (B, d) --LSTM--> (B, H)
--> MLP+tanh -> arm (B, ., 6k);  MLP+sigmoid -> gripper (B, ., k).
Two entry points over the same parameters: ``head_forward`` runs a whole
window from a zero carry (training, with dropout, and calibration),
``head_step`` one streaming frame with an explicit carry, which the caller
commits only for the exit that fires.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from deer_vla_tpu_torch.core.config import HeadConfig
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.layers import (init_layernorm, init_linear,
                                           layernorm, linear)
from deer_vla_tpu_torch.ops.lstm import (Carry, init_lstm, lstm_forward,
                                         lstm_step, zero_carry)


class HeadOutput(NamedTuple):
    actions: torch.Tensor        # (B, W, 6*multi_step) tanh arm action
    gripper_probs: torch.Tensor  # (B, W, multi_step) sigmoid
    gripper_logits: torch.Tensor


def _init_mlp_head(gen, cfg: HeadConfig, out_dim: int, device, dtype) -> dict:
    dims = ((cfg.hidden_size,)
            + tuple(cfg.mlp_hidden_dims[:cfg.mlp_num_hidden_layers])
            + (out_dim,))
    layers = [init_linear(gen, dims[i], dims[i + 1], True, device, dtype)
              for i in range(len(dims) - 1)]
    lns = [init_layernorm(dims[i + 1], device=device, dtype=dtype)
           if cfg.mlp_layernorm else None for i in range(len(dims) - 2)]
    return {"layers": layers, "lns": lns}


def init_head(gen, cfg: HeadConfig, device="cpu",
              dtype=torch.float32) -> dict:
    if cfg.use_state:
        raise NotImplementedError("proprio-state heads are not ported")
    return {
        "rnn": init_lstm(gen, cfg.in_features, cfg.hidden_size,
                         cfg.lstm_num_layers, cfg.lstm_layernorm, device,
                         dtype),
        "actions": _init_mlp_head(
            gen, cfg, cfg.out_features * cfg.multi_step_action, device, dtype),
        "gripper": _init_mlp_head(gen, cfg, cfg.multi_step_action, device,
                                  dtype),
    }


def _mlp_head_forward(p: dict, x: torch.Tensor,
                      cfg: Optional[HeadConfig] = None,
                      dropout: Optional[Dropout] = None) -> torch.Tensor:
    """Hidden Linear(+LN)+ReLU layers, then the final Linear
    (pre-activation).  With ``dropout`` (training; ``cfg`` then gives the
    rate and the mode, action_head.py:84-133): 'layerwise' drops before
    every hidden linear and after the last hidden ReLU, 'last' only after
    the last hidden ReLU, 'wo_last' before every hidden linear but not
    after the last ReLU."""
    n = len(p["layers"])
    on = dropout is not None and cfg.dropout > 0.0
    mode = cfg.dropout_mode if on else None
    if mode in ("layerwise", "wo_last"):
        x = dropout(x, cfg.dropout)
    for i in range(n - 1):
        x = linear(p["layers"][i], x)
        if p["lns"][i] is not None:
            x = layernorm(p["lns"][i], x)
        x = torch.relu(x)
        if (mode == "layerwise" or (mode == "wo_last" and i < n - 2)
                or (mode == "last" and i == n - 2)):
            x = dropout(x, cfg.dropout)
    return linear(p["layers"][-1], x)


def pool_tokens(feat: torch.Tensor, pooling: str = "max") -> torch.Tensor:
    """(..., lang_len, d) -> (..., d), padding positions included."""
    if pooling == "max":
        return feat.amax(dim=-2)
    return feat.mean(dim=-2)


def _prepare_input(feat: torch.Tensor, cfg: HeadConfig, window: int
                   ) -> torch.Tensor:
    """(B*W, lang_len, d) or (B*W, d) -> (B, W, d)."""
    if feat.ndim == 3:
        feat = pool_tokens(feat, cfg.pooling)
    return feat.reshape(-1, window, feat.shape[-1])


def head_forward(p: dict, feat: torch.Tensor, cfg: HeadConfig,
                 state: Optional[torch.Tensor] = None, *,
                 window: Optional[int] = None,
                 last_action: bool = False,
                 dropout: Optional[Dropout] = None) -> HeadOutput:
    """Full-window mode (the carry starts at zeros).  feat
    (B*W, lang_len, d) -> per-step actions (B, W, .), or the last step's
    only with ``last_action`` (action_head.py:593-594).  ``dropout``
    (training) is used by the LSTM, then the arm MLP, then the gripper MLP,
    in that order."""
    if state is not None or cfg.use_state:
        raise NotImplementedError("proprio-state heads are not ported")
    x = _prepare_input(feat, cfg, window if window is not None
                       else cfg.window_size)
    y, _ = lstm_forward(p["rnn"], x, dropout_rate=cfg.lstm_dropout,
                        dropout=dropout)
    if last_action:
        y = y[:, -1:, :]
    act = torch.tanh(_mlp_head_forward(p["actions"], y, cfg, dropout))
    glog = _mlp_head_forward(p["gripper"], y, cfg, dropout)
    return HeadOutput(act, torch.sigmoid(glog), glog)


def head_step(p: dict, feat: torch.Tensor, carry: Optional[Carry],
              cfg: HeadConfig, state: Optional[torch.Tensor] = None
              ) -> Tuple[HeadOutput, Carry]:
    """One frame: feat (B, lang_len, d) or (B, d) -> (output with W == 1,
    new carry)."""
    if state is not None:
        raise NotImplementedError("proprio-state heads are not ported")
    if feat.ndim == 3:
        feat = pool_tokens(feat, cfg.pooling)
    if carry is None:
        carry = zero_carry(cfg.lstm_num_layers, feat.shape[0],
                           cfg.hidden_size, feat.dtype, feat.device)
    y, new_carry = lstm_step(p["rnn"], feat, carry)
    y = y[:, None, :]
    act = torch.tanh(_mlp_head_forward(p["actions"], y))
    glog = _mlp_head_forward(p["gripper"], y)
    return HeadOutput(act, torch.sigmoid(glog), glog), new_carry
