"""The multi-exit imitation loss (the JAX package's ``train/losses.py``,
train_utils.py:487-558).

Per exit: huber on the arm actions (mean over the action dim) plus
``bin_coef`` times BCE-with-logits on the gripper; the exits' losses are
summed (every exit weighs 1, get_exit_weights train_utils.py:179).  The
diffusion head's loss is not ported (ROADMAP.md M10b).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from deer_vla_tpu_torch.models.flamingo import TrainOutputs


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    err = pred - target
    a = err.abs()
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def bce_with_logits(logits: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def multi_exit_loss(outputs: TrainOutputs, labels: torch.Tensor,
                    bin_coef: float = 0.01, last_step_only: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """labels (B, W, 7), or (B, W, k, 7) for multi_step_action k > 1:
    [..., :6] arm, [..., 6] gripper in {-1, 1}.  For k > 1 the heads' flat
    (B, W, 6k) / (B, W, k) outputs are reshaped to line up with the labels.
    ``last_step_only`` scores the window's last step only.  Exit order
    (train_utils.py:503): internal exits..., final, extra 1, extra 2."""
    if last_step_only:
        labels = labels[:, -1:]
    arm_t = labels[..., :6].float()
    grip_t = ((labels[..., 6:] + 1.0) / 2.0).float()
    all_outputs = list(outputs.exit_outputs) + [
        outputs.final_output, outputs.extra_output, outputs.extra_output2]
    num = torch.stack([o.actions.float() for o in all_outputs])  # (E,B,W,6k)
    logits = torch.stack([o.gripper_logits.float() for o in all_outputs])
    if last_step_only:
        num = num[:, :, -1:]
        logits = logits[:, :, -1:]
    if labels.ndim == 4:  # multi-step: (B, W, k, 7) labels
        k = labels.shape[2]
        num = num.reshape(*num.shape[:3], k, 6)
        logits = logits[..., None]
        loss_num = huber(num, arm_t[None]).mean((-1, -2))      # (E, B, W)
        loss_bin = bce_with_logits(logits, grip_t[None]).mean((-1, -2))
    else:
        loss_num = huber(num, arm_t[None]).mean(-1)            # (E, B, W)
        loss_bin = bce_with_logits(logits, grip_t[None]).mean(-1)
    per_exit = (loss_num + bin_coef * loss_bin).mean((1, 2))   # (E,)
    total = per_exit.sum()
    metrics = {
        "loss": total,
        "mse": loss_num.mean(),
        "bce": loss_bin.mean(),
        "extra_exit_loss_num": loss_num[-2].mean(),
        "extra_exit_loss_bin": loss_bin[-2].mean(),
        "extra_exit_loss2_num": loss_num[-1].mean(),
        "extra_exit_loss2_bin": loss_bin[-1].mean(),
        "per_exit_loss": per_exit,
    }
    return total, metrics
