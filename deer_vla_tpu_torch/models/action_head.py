"""Deterministic LSTM action head (action_head.py:408-611).

(B, lang_len, d) --max-pool over tokens--> (B, d) [+ the proprio state's
embedding] --LSTM--> (B, H)
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
                                           layernorm, linear, trunc_normal)
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


def init_head(gen, cfg: HeadConfig, device="cpu", dtype=torch.float32,
              features_only: bool = False) -> dict:
    """``features_only``: the diffusion head's variant, the LSTM as a
    feature extractor without the action and gripper MLPs (use_diff,
    action_head.py:364-371)."""
    p = {"rnn": init_lstm(gen, cfg.in_features, cfg.hidden_size,
                          cfg.lstm_num_layers, cfg.lstm_layernorm, device,
                          dtype)}
    if not features_only:
        p["actions"] = _init_mlp_head(
            gen, cfg, cfg.out_features * cfg.multi_step_action, device, dtype)
        p["gripper"] = _init_mlp_head(gen, cfg, cfg.multi_step_action, device,
                                      dtype)
    if cfg.use_state:
        # action_head.py:447-449: the arm state (6) through Linear+ReLU, the
        # gripper state {0, 1} through Embedding+ReLU, both concatenated
        # and projected back to in_features
        d = cfg.in_features
        p["embed_arm_state"] = init_linear(gen, 6, d, True, device, dtype)
        p["embed_gripper_state"] = {"w": trunc_normal((2, d), 0.02, gen,
                                                      device, dtype)}
        p["embed_state"] = init_linear(gen, 2 * d, d, True, device, dtype)
    return p


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


def embed_state(p: dict, state: torch.Tensor) -> torch.Tensor:
    """Proprio state (..., D): the arm pose state[..., :6] and the gripper
    state[..., -1] in {-1, 1} -> (..., in_features)
    (action_head.py:524-536).  The gripper row is looked up as
    ``jnp.take`` does: an index in [-2, 0) counts from the end, one outside
    [-2, 2) gives NaN."""
    arm = torch.relu(linear(p["embed_arm_state"], state[..., :6]))
    grip_idx = ((state[..., -1] + 1.0) / 2).to(torch.int64)
    table = p["embed_gripper_state"]["w"].to(state.dtype)
    n = table.shape[0]
    grip = table[grip_idx.remainder(n)]
    inside = ((grip_idx >= -n) & (grip_idx < n))[..., None]
    grip = torch.relu(torch.where(inside, grip, grip.new_tensor(float("nan"))))
    return linear(p["embed_state"], torch.cat([arm, grip], dim=-1))


def _add_state(p: dict, feat: torch.Tensor, state, cfg: HeadConfig
               ) -> torch.Tensor:
    """A pooled (B, d) frame plus its state embedding, when the head takes
    state."""
    if cfg.use_state and state is not None:
        feat = feat + embed_state(p, state.reshape(feat.shape[0], -1))
    return feat


def _prepare_input(p: dict, feat: torch.Tensor, state, cfg: HeadConfig,
                   window: int) -> torch.Tensor:
    """(B*W, lang_len, d) or (B*W, d) -> (B, W, d), plus the state
    embedding of each frame when the head takes state."""
    if feat.ndim == 3:
        feat = pool_tokens(feat, cfg.pooling)
    feat = feat.reshape(-1, window, feat.shape[-1])
    if cfg.use_state and state is not None:
        se = embed_state(p, state)
        feat = feat + se.reshape(-1, window, se.shape[-1])
    return feat


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
    x = _prepare_input(p, feat, state, cfg, window if window is not None
                       else cfg.window_size)
    y, _ = lstm_forward(p["rnn"], x, dropout_rate=cfg.lstm_dropout,
                        dropout=dropout)
    if last_action:
        y = y[:, -1:, :]
    act = torch.tanh(_mlp_head_forward(p["actions"], y, cfg, dropout))
    glog = _mlp_head_forward(p["gripper"], y, cfg, dropout)
    return HeadOutput(act, torch.sigmoid(glog), glog)


def head_features(p: dict, feat: torch.Tensor, cfg: HeadConfig,
                  state: Optional[torch.Tensor] = None, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """Full-window LSTM features (B, W, hidden) from a zero carry: the
    use_diff return path (action_head.py:602-603), the diffusion model's
    global conditioning."""
    x = _prepare_input(p, feat, state, cfg, window if window is not None
                       else cfg.window_size)
    return lstm_forward(p["rnn"], x)[0]


def head_step(p: dict, feat: torch.Tensor, carry: Optional[Carry],
              cfg: HeadConfig, state: Optional[torch.Tensor] = None
              ) -> Tuple[HeadOutput, Carry]:
    """One frame: feat (B, lang_len, d) or (B, d) -> (output with W == 1,
    new carry)."""
    y, new_carry = head_feature_step(p, feat, carry, cfg, state)
    y = y[:, None, :]
    act = torch.tanh(_mlp_head_forward(p["actions"], y))
    glog = _mlp_head_forward(p["gripper"], y)
    return HeadOutput(act, torch.sigmoid(glog), glog), new_carry


def head_feature_step(p: dict, feat: torch.Tensor, carry: Optional[Carry],
                      cfg: HeadConfig, state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Carry]:
    """The LSTM of one streaming frame: ((B, hidden) features, new carry),
    the carry contract of ``head_step``."""
    if feat.ndim == 3:
        feat = pool_tokens(feat, cfg.pooling)
    feat = _add_state(p, feat, state, cfg)
    if carry is None:
        carry = zero_carry(cfg.lstm_num_layers, feat.shape[0],
                           cfg.hidden_size, feat.dtype, feat.device)
    return lstm_step(p["rnn"], feat, carry)
