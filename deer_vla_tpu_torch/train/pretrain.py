"""Flamingo LM pretraining and the vision-language loss of co-training (the
JAX package's ``train/pretrain.py``; the upstream OpenFlamingo tree,
open_flamingo/train/train.py:51-350, and DeeR's ``--cotrain``,
train_calvin_post_strategy.py:296-302).

Images and text go through the same gated cross-attention decoder as the
policy; the loss is next-token cross-entropy with the media and padding
positions masked out (upstream masks the <image> and <PAD> labels).  The
ViT stays frozen and runs under ``no_grad`` (through K1 on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.flamingo import encode_vision
from deer_vla_tpu_torch.models.mpt import decoder_forward, lm_logits
from deer_vla_tpu_torch.train.optimizer import (GroupedAdamW, flat_leaves,
                                                global_norm)


def lm_loss(params: dict, cfg: DeerConfig, vision_x: torch.Tensor,
            input_ids: torch.Tensor, attention_mask: torch.Tensor,
            vision_gripper: Optional[torch.Tensor] = None,
            loss_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE.  vision_x (B, T_img, 1, 3, H, W), input_ids (B, S).
    ``loss_mask`` (B, S) restricts the loss further (VQA's answer tokens,
    vl_dataset.py:138-147); media and padding positions never count.
    Returns (loss, {lm_loss, lm_acc, tokens})."""
    media = encode_vision(params, vision_x, vision_gripper, cfg)
    hidden, _ = decoder_forward(params["decoder"], input_ids, attention_mask,
                                media, cfg)
    logits = lm_logits(params["decoder"], hidden[-1], cfg.dtypes.cdt,
                       arch=cfg.mpt.arch)[:, :-1].float()
    targets = input_ids[:, 1:].long()
    valid = attention_mask[:, 1:].bool() & (targets != cfg.media_token_id)
    if loss_mask is not None:
        valid = valid & loss_mask[:, 1:].bool()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    acc = (valid & (logits.argmax(-1) == targets)).sum() / denom
    return loss, {"lm_loss": loss, "lm_acc": acc, "tokens": denom}


def make_pretrain_step(cfg: DeerConfig, optimizer: GroupedAdamW):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    for interleaved or caption / VQA batches: {image (B, T, 1, 3, H, W),
    input_ids, attention_mask, [gripper], [answer_mask]}.  Only the
    optimizer's trainable leaves are differentiated and updated (in
    place), and ``grad_norm`` is their global norm, as the train step's.
    The JAX package's ``grad_norm`` also counts the frozen decoder's
    gradients, which it computes and drops (ROADMAP.md, "Found in the
    reference").  With a process group of more than one rank the gradients
    are averaged across ranks first (``train_step.average_across_ranks``)."""
    from deer_vla_tpu_torch.train.train_step import average_across_ranks
    keys = optimizer.trainable_keys()

    def step(params: dict, opt_state: dict, batch: Dict):
        flat = flat_leaves(params)
        leaves = [flat[k] for k in keys]
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = lm_loss(
                    params, cfg, batch["image"], batch["input_ids"],
                    batch["attention_mask"],
                    vision_gripper=batch.get("gripper"),
                    loss_mask=batch.get("answer_mask"))
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        grads = {k: (torch.zeros_like(flat[k], dtype=torch.float32)
                     if g is None else g.float())
                 for k, g in zip(keys, gs)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads, metrics = average_across_ranks(grads, metrics)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(params, grads, opt_state)
        return params, opt_state, metrics

    return step
