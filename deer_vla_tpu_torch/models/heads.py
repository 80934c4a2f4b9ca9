"""Action-head routing by ``cfg.head_type`` (the JAX package's
``models/heads.py``; the reference's decoder_type / head_type choice,
flamingo_mpt.py:149-182).

The four families and their streaming carries:
  deterministic  the LSTM head (action_head.py), carry the LSTM (h, c);
  fc             the FCDecoder (alt_heads.py), stateless, carry ();
  gpt            the GPTDecoder (alt_heads.py), carry a ``GPTCarry``;
  diffusion      the LSTM as a feature extractor: the step's "action" is
                 the (hidden,) conditioning feature (zeros in the gripper
                 slot) and the DDPM sampler (eval/diffusion_policy.py)
                 turns it into a plan, so the exit criterion compares
                 features, as the reference's value net does with use_diff.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.action_head import (HeadOutput,
                                                   head_feature_step,
                                                   head_features,
                                                   head_forward, head_step,
                                                   init_head)
from deer_vla_tpu_torch.models.alt_heads import (GPTCarry, GPTDecoderConfig,
                                                 fc_decoder_forward,
                                                 gpt_decoder_forward,
                                                 gpt_decoder_step,
                                                 gpt_zero_carry,
                                                 init_fc_decoder,
                                                 init_gpt_decoder)
from deer_vla_tpu_torch.models.diffusion import DiffusionConfig
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.lstm import zero_carry

HEAD_TYPES = ("deterministic", "fc", "gpt", "diffusion")


def check_head_type(cfg: DeerConfig) -> None:
    """The JAX package's construction-time refusals (flamingo_mpt.py:
    157-165 and the diffusion head's window contract)."""
    if cfg.head_type not in HEAD_TYPES:
        raise ValueError(f"unknown head_type {cfg.head_type!r}; "
                         f"one of {HEAD_TYPES}")
    if cfg.head_type == "fc" and not (cfg.use_hist
                                      or cfg.fusion_mode == "vit_concat"):
        raise NotImplementedError(
            "head_type 'fc' requires --use_hist or --fusion_mode vit_concat "
            "(the FCDecoder has no temporal state; the window must already "
            "be folded into the features, flamingo_mpt.py:157-165)")
    if cfg.head_type == "gpt" and (cfg.use_state or cfg.head.use_state):
        raise NotImplementedError(
            "head_type 'gpt' does not consume proprio state (the reference "
            "GPTDecoder.forward takes no state argument and its use_state "
            "init path is dead code); drop --use_state or pick another head")
    if cfg.head_type == "diffusion":
        hist = cfg.n_obs_steps - 1
        if not 0 <= hist < cfg.window_size:
            raise ValueError(
                f"diffusion head needs 1 <= n_obs_steps <= window_size "
                f"(got n_obs_steps={cfg.n_obs_steps}, "
                f"window_size={cfg.window_size})")
        if cfg.diff_horizon < cfg.window_size:
            raise ValueError(
                f"diff_horizon ({cfg.diff_horizon}) must cover the training "
                f"window ({cfg.window_size})")
        if cfg.head.multi_step_action != 1:
            raise NotImplementedError(
                "diffusion head emits its own action plan; "
                "multi_step_action must be 1")
        if cfg.use_hist or cfg.fusion_mode == "vit_concat":
            raise NotImplementedError(
                "diffusion head needs the per-frame window (its loss and "
                "sampler condition on an in-window action history); "
                "use_hist / vit_concat fold the window away")


def gpt_head_config(cfg: DeerConfig) -> GPTDecoderConfig:
    return GPTDecoderConfig(head=cfg.head, hidden_size=cfg.gpt_hidden_size)


def diffusion_head_config(cfg: DeerConfig) -> DiffusionConfig:
    """DiffusionDecoder's construction (flamingo_mpt.py:168-176): the
    head's hidden width as the condition, 6 arm + 1 gripper dims."""
    return DiffusionConfig(
        input_dim=cfg.head.out_features + 1,
        horizon=cfg.diff_horizon,
        global_cond_dim=cfg.head.hidden_size,
        down_dims=tuple(cfg.diff_down_dims),
        n_groups=min(8, min(cfg.diff_down_dims)),
        n_timesteps=cfg.diff_timesteps,
        predict_epsilon=cfg.diff_predict_epsilon)


def init_any_head(gen, cfg: DeerConfig, device="cpu",
                  dtype=torch.float32) -> dict:
    ht = cfg.head_type
    if ht == "deterministic":
        return init_head(gen, cfg.head, device, dtype)
    if ht == "diffusion":
        return init_head(gen, cfg.head, device, dtype, features_only=True)
    if ht == "fc":
        return init_fc_decoder(gen, cfg.head, device, dtype)
    if ht == "gpt":
        return init_gpt_decoder(gen, gpt_head_config(cfg), device, dtype)
    raise ValueError(ht)


def head_uses_dropout(cfg: DeerConfig) -> bool:
    """Whether a training forward of the head draws dropout masks: the
    head's rates, or the gpt backbone's own (GPT2Config's 0.1)."""
    h = cfg.head
    return (h.dropout > 0 or h.lstm_dropout > 0
            or (cfg.head_type == "gpt" and gpt_head_config(cfg).dropout > 0))


def any_head_forward(p: dict, feat: torch.Tensor, cfg: DeerConfig,
                     state: Optional[torch.Tensor] = None, *,
                     window: Optional[int] = None,
                     last_action: bool = False,
                     dropout: Optional[Dropout] = None):
    """Full-window mode: a HeadOutput, or for diffusion the LSTM features
    (B, W, hidden).  ``dropout`` only in training."""
    ht = cfg.head_type
    if ht == "deterministic":
        return head_forward(p, feat, cfg.head, state, window=window,
                            last_action=last_action, dropout=dropout)
    if ht == "diffusion":
        y = head_features(p, feat, cfg.head, state, window=window)
        return y[:, -1:] if last_action else y
    if ht == "fc":
        out = fc_decoder_forward(p, feat, cfg.head, window=window,
                                 state=state, dropout=dropout)
        if last_action:
            out = HeadOutput(*(o[:, -1:] for o in out))
        return out
    if ht == "gpt":
        # no state: check_head_type refuses gpt with state
        return gpt_decoder_forward(p, feat, gpt_head_config(cfg),
                                   window=window, last_action=last_action,
                                   dropout=dropout)
    raise ValueError(ht)


def head_actions(out, cfg: DeerConfig) -> torch.Tensor:
    """The (B, W, .) vector the exit criterion compares, from
    ``any_head_forward``'s output: the arm actions, the features for
    diffusion."""
    return out if cfg.head_type == "diffusion" else out.actions


def any_head_step(p: dict, feat: torch.Tensor, carry, cfg: DeerConfig,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[HeadOutput, object]:
    """Streaming mode: one frame -> (HeadOutput with W == 1, new carry).
    For diffusion the output's ``actions`` hold the (B, 1, hidden) feature
    and its gripper slots zeros."""
    ht = cfg.head_type
    if ht == "deterministic":
        return head_step(p, feat, carry, cfg.head, state)
    if ht == "diffusion":
        y, new_carry = head_feature_step(p, feat, carry, cfg.head, state)
        z = y.new_zeros(y.shape[0], 1, 1)
        return HeadOutput(y[:, None, :], z, z), new_carry
    if ht == "fc":
        return fc_decoder_forward(p, feat, cfg.head, window=1,
                                  state=state), ()
    if ht == "gpt":
        gcfg = gpt_head_config(cfg)
        if carry is None:
            carry = gpt_zero_carry(gcfg, feat.shape[0], device=feat.device)
        return gpt_decoder_step(p, feat, carry, gcfg)
    raise ValueError(ht)


def any_zero_carry(cfg: DeerConfig, batch: int, dtype=torch.float32,
                   device="cpu"):
    ht = cfg.head_type
    if ht in ("deterministic", "diffusion"):
        return zero_carry(cfg.head.lstm_num_layers, batch,
                          cfg.head.hidden_size, dtype, device)
    if ht == "gpt":
        return gpt_zero_carry(gpt_head_config(cfg), batch, dtype, device)
    if ht == "fc":
        return ()
    raise ValueError(ht)


def select_carry(cfg: DeerConfig, take: torch.Tensor, cand, best):
    """The per-stream commit: ``cand`` where ``take`` (B,), else ``best``,
    by carry layout.  Every gpt candidate advances every stream's count by
    one this step, so the candidate's counts hold for all streams."""
    if cfg.head_type == "fc":
        return best
    if cfg.head_type == "gpt":  # (history, count), a GPTCarry or a tuple
        return GPTCarry(torch.where(take[:, None, None], cand[0], best[0]),
                        cand[1])
    return tuple(torch.where(take[None, :, None], c, bc)
                 for c, bc in zip(cand, best))


def reset_carry(cfg: DeerConfig, carry, mask: torch.Tensor):
    """``carry`` with the streams of ``mask`` (B,) back at zeros."""
    if cfg.head_type == "fc":
        return carry
    fresh = any_zero_carry(cfg, int(mask.shape[0]), device=mask.device)
    if cfg.head_type == "gpt":
        return GPTCarry(torch.where(mask[:, None, None], fresh.history,
                                    carry[0]),
                        torch.where(mask, fresh.count, carry[1]))
    return tuple(torch.where(mask[None, :, None], f, c)
                 for f, c in zip(fresh, carry))


def tile_carry(cfg: DeerConfig, carry, n: int):
    """The carry of B streams repeated n times along the stream dim (n*B
    streams, copy-major)."""
    if cfg.head_type == "fc":
        return ()
    if cfg.head_type == "gpt":
        return GPTCarry(carry.history.repeat(n, 1, 1), carry.count.repeat(n))
    return tuple(c.repeat(1, n, 1) for c in carry)


def pick_carry(cfg: DeerConfig, carry, n: int, k: int):
    """Copy k of a ``tile_carry``-laid carry of n copies."""
    if cfg.head_type == "fc":
        return ()
    if cfg.head_type == "gpt":
        b = carry.count.shape[0] // n
        return GPTCarry(carry.history[k * b:(k + 1) * b],
                        carry.count[k * b:(k + 1) * b])
    return tuple(c.reshape(c.shape[0], n, -1, c.shape[-1])[:, k]
                 for c in carry)


def head_action_width(cfg: DeerConfig) -> int:
    """Width of the vector the exit criterion compares: 6k arm dims, the
    feature width for diffusion."""
    if cfg.head_type == "diffusion":
        return cfg.head.hidden_size
    return cfg.head.out_features * cfg.head.multi_step_action


def head_gripper_width(cfg: DeerConfig) -> int:
    """Width of the step's gripper slot: k, one zero for diffusion."""
    return 1 if cfg.head_type == "diffusion" else cfg.head.multi_step_action
