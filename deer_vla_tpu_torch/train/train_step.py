"""The multi-exit training step (the JAX package's ``train/train_step.py``,
the DDP loop body of train_utils.py:385-628).

bf16 compute over fp32 masters of the trainable leaves; the frozen leaves
need no gradient and get none.  ``grad_accum > 1`` splits the batch into
that many microbatches along the trajectory dim, runs them one after the
other and averages their gradients before the one update
(train_utils.py:573-583).  The vision-language co-training step waits for
ROADMAP.md M16.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.flamingo import forward_train
from deer_vla_tpu_torch.train.losses import (multi_exit_diffusion_loss,
                                             multi_exit_loss)
from deer_vla_tpu_torch.train.optimizer import GroupedAdamW, flat_leaves


# the diffusion loss's draws in a microbatch's ``draws`` entry: timesteps
# (B,) and standard-normal noise (B, horizon, 7)
DIFFUSION_DRAWS = ("diff_t", "diff_noise")


class TrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: int


def init_train_state(params: dict, optimizer: GroupedAdamW) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


def _split_micro(batch: Dict[str, torch.Tensor], grad_accum: int,
                 cfg: DeerConfig) -> List[Dict[str, torch.Tensor]]:
    """The microbatches: per-frame leaves (B*W, ...) -> k of (mb*W, ...),
    the per-window ones (B, ...) -> k of (mb, ...): the labels, and the text
    under 'vit_concat'."""
    bs = batch["labels"].shape[0]
    if bs % grad_accum:
        raise ValueError(f"batch {bs} is not divisible by grad_accum "
                         f"{grad_accum}")
    mb = bs // grad_accum
    w = cfg.window_size
    per_window = {"labels"}
    if cfg.fusion_mode == "vit_concat":
        per_window |= {"input_ids", "attention_mask"}

    def part(key, x, i):
        n = mb if key in per_window else mb * w
        return x[i * n:(i + 1) * n]

    return [{k: part(k, v, i) for k, v in batch.items()}
            for i in range(grad_accum)]


def loss_and_grads(params: dict, keys: Sequence[str], batch: Dict,
                   cfg: DeerConfig, *, phase: str = "joint",
                   bin_coef: float = 0.01, calvin_multiplier: float = 1.0,
                   grad_accum: int = 1,
                   gen: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[dict]] = None
                   ) -> Tuple[torch.Tensor, Dict, Dict[str, object]]:
    """(loss, metrics, {key: grad}) for the leaves named in ``keys``; a
    leaf the loss does not reach gets ``None``.  The random draws of each
    microbatch come from ``gen``, or from ``draws[i]``: keyword arguments of
    ``forward_train`` (``rand_layer_ids``, ``switch_layer_ids``,
    ``dropout``) and, for the diffusion head, the loss's ``diff_t`` and
    ``diff_noise``.  The diffusion head trains on the DDPM loss
    (``multi_exit_diffusion_loss``), the others on ``multi_exit_loss``."""
    flat = flat_leaves(params)
    leaves = [flat[k] for k in keys]
    micro = [batch] if grad_accum == 1 else _split_micro(batch, grad_accum,
                                                          cfg)
    if gen is None and draws is None:
        # forward_train's own default, shared with the diffusion loss
        gen = torch.Generator(device=batch["labels"].device).manual_seed(0)
    grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
    losses, metrics = [], []
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        for i, mb in enumerate(micro):
            with torch.enable_grad():
                out = forward_train(
                    params, mb["image"], mb["input_ids"],
                    mb["attention_mask"], cfg, gen,
                    vision_gripper=mb.get("gripper"),
                    state_tensor=mb.get("state"),
                    no_backbone_grad=phase == "exit_only", train=True,
                    **({k: v for k, v in draws[i].items()
                        if k not in DIFFUSION_DRAWS}
                       if draws is not None else {}))
                if cfg.head_type == "diffusion":
                    d = draws[i] if draws is not None else {}
                    loss, m = multi_exit_diffusion_loss(
                        out, mb["labels"], params["diffusion"], cfg,
                        gen=gen, t=d.get("diff_t"),
                        noise=d.get("diff_noise"))
                else:
                    loss, m = multi_exit_loss(
                        out, mb["labels"], bin_coef,
                        last_step_only=cfg.use_hist
                        or cfg.fusion_mode == "vit_concat")
                loss = calvin_multiplier * loss
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [g if acc is None else (acc if g is None else acc + g)
                     for acc, g in zip(grads, gs)]
            losses.append(loss.detach())
            metrics.append({k: v.detach() for k, v in m.items()})
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    k = len(micro)
    if k > 1:
        grads = [None if g is None else g / k for g in grads]
        metrics = [{key: torch.stack([m[key] for m in metrics]).mean(0)
                    for key in metrics[0]}]
    return (torch.stack(losses).sum() / k, metrics[0],
            dict(zip(keys, grads)))


def _apply_update(optimizer: GroupedAdamW, state: TrainState,
                  grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                  metrics: Dict) -> Tuple[TrainState, Dict]:
    """The optimizer update (in place on ``state.params``) and the shared
    metrics: ``loss`` and ``grad_norm``, the global norm of the trainable
    gradients (what the reference's clip_grad_norm_ returns)."""
    metrics = dict(metrics)
    metrics["loss"] = loss
    metrics["grad_norm"] = optimizer.update(state.params, grads,
                                            state.opt_state)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_train_step(cfg: DeerConfig, optimizer: GroupedAdamW, *,
                    phase: str = "joint", bin_coef: float = 0.01,
                    calvin_multiplier: float = 1.0, grad_accum: int = 1):
    """``step(state, batch, gen=None, draws=None) -> (state, metrics)``.

    batch: image, gripper (B*W, 1, 1, 3, H, W); input_ids, attention_mask
    (B*W, S), or (B, S) under 'vit_concat'; labels (B, W, 7) or
    (B, W, k, 7); state (B*W, 1, 1, state_dim) for a state model.  The trainable leaves are the optimizer's
    non-frozen ones; they hold fp32 masters and are updated in place, so
    the state passed in is the state returned.  ``calvin_multiplier``
    scales the loss before the gradient; the logged loss is the scaled
    one (train_utils.py:549)."""
    keys = optimizer.trainable_keys()

    def step(state: TrainState, batch: Dict,
             gen: Optional[torch.Generator] = None,
             draws: Optional[Sequence[dict]] = None
             ) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = loss_and_grads(
            state.params, keys, batch, cfg, phase=phase, bin_coef=bin_coef,
            calvin_multiplier=calvin_multiplier, grad_accum=grad_accum,
            gen=gen, draws=draws)
        flat = flat_leaves(state.params)
        grads = {k: torch.zeros_like(flat[k]) if g is None else g
                 for k, g in grads.items()}
        return _apply_update(optimizer, state, grads, loss, metrics)

    return step
