"""Action-head routing by ``cfg.head_type``.  The deterministic LSTM head is
ported; the fc, gpt and diffusion families raise NotImplementedError
(ROADMAP.md M10b)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.action_head import (HeadOutput, head_forward,
                                                   head_step)
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.lstm import zero_carry


def _check(cfg: DeerConfig) -> None:
    if cfg.head_type != "deterministic":
        raise NotImplementedError(
            f"head_type {cfg.head_type!r} is not ported (ROADMAP.md M10b)")


def any_head_forward(p: dict, feat: torch.Tensor, cfg: DeerConfig,
                     state: Optional[torch.Tensor] = None, *,
                     window: Optional[int] = None,
                     last_action: bool = False,
                     dropout: Optional[Dropout] = None) -> HeadOutput:
    """Full-window mode; ``dropout`` only in training."""
    _check(cfg)
    return head_forward(p, feat, cfg.head, state, window=window,
                        last_action=last_action, dropout=dropout)


def any_head_step(p: dict, feat: torch.Tensor, carry, cfg: DeerConfig,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[HeadOutput, object]:
    _check(cfg)
    return head_step(p, feat, carry, cfg.head, state)


def any_zero_carry(cfg: DeerConfig, batch: int, dtype=torch.float32,
                   device="cpu"):
    _check(cfg)
    return zero_carry(cfg.head.lstm_num_layers, batch, cfg.head.hidden_size,
                      dtype, device)


def head_action_width(cfg: DeerConfig) -> int:
    """Width of the arm vector the exit criterion compares (6k)."""
    _check(cfg)
    return cfg.head.out_features * cfg.head.multi_step_action
