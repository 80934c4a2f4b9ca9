"""The multi-exit imitation loss (the JAX package's ``train/losses.py``,
train_utils.py:487-558).

Per exit: huber on the arm actions (mean over the action dim) plus
``bin_coef`` times BCE-with-logits on the gripper; the exits' losses are
summed (every exit weighs 1, get_exit_weights train_utils.py:179).  The
diffusion head's multi-exit DDPM loss is ``multi_exit_diffusion_loss``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.models.diffusion import (ddpm_buffers, loss_draws,
                                                 q_sample, unet_forward)
from deer_vla_tpu_torch.models.flamingo import TrainOutputs
from deer_vla_tpu_torch.models.heads import diffusion_head_config


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


def multi_exit_diffusion_loss(outputs: TrainOutputs, labels: torch.Tensor,
                              diff_params: dict, cfg, *,
                              gen: Optional[torch.Generator] = None,
                              t: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """The JAX package's multi-exit DDPM epsilon loss for
    ``head_type='diffusion'`` (the reference implements no diffusion
    training; this objective matches its serving contract,
    eval_utils.py:400-415).

    Per exit: the normalized labels fill rows [0, W) of the horizon, the
    first hist = n_obs_steps - 1 rows are clamped (inpainted, no loss), the
    epsilon MSE is taken over rows [hist, W), and the U-Net is conditioned
    on the exit's LSTM feature at row hist.  One (t, noise) draw a batch
    row, shared by the E exits, and one U-Net call over E*B rows.  The
    normalizer gets no gradient.  ``t`` (B,) and ``noise`` (B, horizon, 7)
    standard normals come from the caller, or from ``gen``.

    outputs: TrainOutputs whose entries are (B, W, hidden) features;
    labels (B, W, 7)."""
    dcfg = diffusion_head_config(cfg)
    if labels.ndim != 3:
        raise ValueError("diffusion head: multi_step_action must be 1")
    b, w, adim = labels.shape
    hist = cfg.n_obs_steps - 1
    horizon = dcfg.horizon
    dev = labels.device
    buf = ddpm_buffers(dcfg)
    norm = {k: v.detach().float() for k, v in diff_params["norm"].items()}
    x_start = labels.float() * norm["scale"] + norm["offset"]
    x_full = F.pad(x_start, (0, 0, 0, horizon - w))
    rows = torch.arange(horizon, device=dev)
    cond_mask = (rows < hist)[None, :, None]
    loss_mask = ((rows >= hist) & (rows < w))[None, :, None]

    feats = torch.stack(list(outputs.exit_outputs) + [
        outputs.final_output, outputs.extra_output, outputs.extra_output2])
    e = feats.shape[0]
    global_cond = feats[:, :, hist].float()  # (E, B, H)
    if t is None or noise is None:
        if gen is None:
            raise ValueError("give the loss's draws (t, noise) or a "
                             "generator")
        t, noise = loss_draws(gen, b, x_full.shape, dcfg, dev)
    t, noise = t.to(dev), noise.to(dev).float()
    x_noisy = torch.where(cond_mask, x_full, q_sample(buf, x_full, t, noise))
    pred = unet_forward(diff_params["unet"], x_noisy.repeat(e, 1, 1),
                        t.repeat(e), dcfg, global_cond.reshape(e * b, -1))
    target = noise if dcfg.predict_epsilon else x_full
    err = (pred.reshape(e, b, horizon, adim) - target[None]).square()
    err = torch.where(loss_mask[None], err, 0.0)
    denom = (w - hist) * adim * b  # the loss rows, counted on the host
    per_exit = err.sum(dim=(1, 2, 3)) / max(denom, 1)  # (E,)
    total = per_exit.sum()
    metrics = {
        "loss": total,
        "diffusion_mse": per_exit.mean(),
        "extra_exit_loss_num": per_exit[-2],
        "extra_exit_loss2_num": per_exit[-1],
        "per_exit_loss": per_exit,
    }
    return total, metrics
