"""The multi-exit training step (the JAX package's ``train/train_step.py``,
the DDP loop body of train_utils.py:385-628).

bf16 compute over fp32 masters of the trainable leaves; the frozen leaves
need no gradient and get none.  ``grad_accum > 1`` splits the batch into
that many microbatches along the trajectory dim, runs them one after the
other and averages their gradients before the one update
(train_utils.py:573-583).  ``make_cotrain_step`` adds the
vision-language LM loss of a caption / VQA batch to the same update
(``--cotrain``, train_calvin_post_strategy.py:296-302).

With a ``torch.distributed`` group of more than one rank the step is data
parallel, as the reference's DDP wrap is (train_calvin_post_strategy.py:
464): each rank holds the weights whole and a contiguous slice of the
global batch, and the trainable gradients and scalar metrics are averaged
across ranks by one ``all_reduce`` over a flat fp32 buffer before the
update.  The random draws are the global batch's when the caller hands a
``ops.draws.RowShard`` of a generator seeded alike on every rank.

With a ``parallel.sharding.Layout`` (``layout=``) the step is fsdp x tp x
dp over a tree of this rank's shards (``shard_params``), and so are the
masters and the Adam moments (ZeRO-3):
  * each microbatch's forward gathers the fsdp shards
    (``sharding.gather_fsdp``), whose backward reduce-scatters, and runs
    the model on its tp shards (``tp=``);
  * the gradients of fsdp-sharded leaves, already summed over fsdp, are
    summed over dp; every other leaf's over dp x fsdp (the data shards;
    tp ranks hold equal gradients of the replicated leaves); all are then
    divided by the data shards, as ``average_across_ranks`` averages;
  * ``grad_norm`` is the norm of the global gradients: each shard's
    squares summed over fsdp x tp, a leaf replicated on an axis counted
    on that axis's rank 0 only, as JAX's norm over the global arrays.
The clip and the weight-decay masks keep optax's order.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.flamingo import forward_train
from deer_vla_tpu_torch.ops.draws import RowShard
from deer_vla_tpu_torch.parallel.collectives import all_reduce
from deer_vla_tpu_torch.parallel.multihost import process_count
from deer_vla_tpu_torch.parallel.sharding import Layout, gather_fsdp
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


def _split_vl(vl_batch: Dict[str, torch.Tensor], grad_accum: int
              ) -> List[Dict[str, torch.Tensor]]:
    """The vision-language batch's microbatches along its batch dim."""
    bs = next(iter(vl_batch.values())).shape[0]
    if bs % grad_accum:
        raise ValueError(f"vl batch {bs} is not divisible by grad_accum "
                         f"{grad_accum}")
    mb = bs // grad_accum
    return [{k: v[i * mb:(i + 1) * mb] for k, v in vl_batch.items()}
            for i in range(grad_accum)]


def loss_and_grads(params: dict, keys: Sequence[str], batch: Dict,
                   cfg: DeerConfig, *, phase: str = "joint",
                   bin_coef: float = 0.01, calvin_multiplier: float = 1.0,
                   grad_accum: int = 1,
                   gen: Optional[Union[torch.Generator, RowShard]] = None,
                   draws: Optional[Sequence[dict]] = None,
                   vl_batch: Optional[Dict] = None, vl_weight: float = 1.0,
                   layout: Optional[Layout] = None
                   ) -> Tuple[torch.Tensor, Dict, Dict[str, object]]:
    """(loss, metrics, {key: grad}) for the leaves named in ``keys``; a
    leaf the loss does not reach gets ``None``.  The random draws of each
    microbatch come from ``gen``, or from ``draws[i]``: keyword arguments of
    ``forward_train`` (``rand_layer_ids``, ``switch_layer_ids``,
    ``dropout``) and, for the diffusion head, the loss's ``diff_t`` and
    ``diff_noise``.  The diffusion head trains on the DDPM loss
    (``multi_exit_diffusion_loss``), the others on ``multi_exit_loss``.
    With ``vl_batch`` (co-training) each microbatch's loss adds
    ``vl_weight`` times ``pretrain.lm_loss`` on the matching microbatch
    of the vision-language batch, and its metrics join the step's.
    ``layout``: ``params`` are this rank's shards (the module docstring);
    the gradients are of the shards, before any reduce over the mesh."""
    if layout is not None and (vl_batch is not None
                               or cfg.head_type == "diffusion"):
        raise NotImplementedError("the sharded step trains the action "
                                  "heads without co-training; the "
                                  "diffusion head and the VL loss take "
                                  "no layout")
    tp = None if layout is None else layout.tp
    flat = flat_leaves(params)
    leaves = [flat[k] for k in keys]
    micro = [batch] if grad_accum == 1 else _split_micro(batch, grad_accum,
                                                          cfg)
    vl_micro = (None if vl_batch is None else [vl_batch] if grad_accum == 1
                else _split_vl(vl_batch, grad_accum))
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
                model = (params if layout is None
                         else gather_fsdp(params, layout))
                out = forward_train(
                    model, mb["image"], mb["input_ids"],
                    mb["attention_mask"], cfg, gen,
                    vision_gripper=mb.get("gripper"),
                    state_tensor=mb.get("state"),
                    no_backbone_grad=phase == "exit_only", train=True,
                    tp=tp,
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
                if vl_micro is not None:
                    from deer_vla_tpu_torch.train.pretrain import lm_loss
                    vb = vl_micro[i]
                    vl, vm = lm_loss(params, cfg, vb["image"],
                                     vb["input_ids"], vb["attention_mask"],
                                     loss_mask=vb.get("answer_mask"))
                    loss = loss + vl_weight * vl
                    m = dict(m, **vm)
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
        metrics = [{key: torch.stack([m[key] for m in metrics])
                    .float().mean(0) for key in metrics[0]}]
    return (torch.stack(losses).sum() / k, metrics[0],
            dict(zip(keys, grads)))


def average_across_ranks(grads: Dict[str, torch.Tensor], metrics: Dict
                         ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """The mean over the process group's ranks of every gradient and every
    scalar metric: one ``all_reduce`` (sum) over a flat fp32 buffer, then
    a division by the group's size.  Every rank gets the same bits, so
    weights updated from them stay equal across ranks.  The identity
    without a group of more than one."""
    world = process_count()
    if world == 1:
        return grads, metrics
    gkeys = list(grads)
    mkeys = [k for k, v in metrics.items() if v.ndim == 0]
    parts = [grads[k].float().reshape(-1) for k in gkeys]
    dev = parts[0].device if parts else metrics[mkeys[0]].device
    parts += [torch.stack([metrics[k].to(dev, torch.float32)
                           for k in mkeys])] if mkeys else []
    flat = torch.cat(parts)
    torch.distributed.all_reduce(flat)
    flat.div_(world)
    out, pos = {}, 0
    for k in gkeys:
        n = grads[k].numel()
        out[k] = flat[pos:pos + n].view(grads[k].shape)
        pos += n
    metrics = dict(metrics)
    for j, k in enumerate(mkeys):
        metrics[k] = flat[pos + j]
    return out, metrics


def _flat_reduce(tensors: List[torch.Tensor], g) -> List[torch.Tensor]:
    """The sums over ``g`` of fp32 tensors, by one all-reduce of a flat
    buffer."""
    if not tensors:
        return []
    flat = all_reduce(torch.cat([t.float().reshape(-1) for t in tensors]),
                      g)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].view(t.shape))
        pos += t.numel()
    return out


def average_sharded(grads: Dict[str, torch.Tensor], metrics: Dict,
                    layout: Layout) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """The mean over the data shards (dp x fsdp) of every shard's gradient
    and every scalar metric (the module docstring)."""
    specs = layout.specs
    n = layout.mesh.data_shards
    split = [k for k in grads if "fsdp" in specs[k]]
    whole = [k for k in grads if "fsdp" not in specs[k]]
    mkeys = [k for k, v in metrics.items() if v.ndim == 0]
    dev = next(iter(grads.values())).device
    summed = _flat_reduce([grads[k] for k in split], layout.groups["dp"])
    rest = _flat_reduce([grads[k] for k in whole]
                        + ([torch.stack([metrics[k].to(dev, torch.float32)
                                         for k in mkeys])] if mkeys else []),
                        layout.groups["data"])
    out = {k: g / n for k, g in zip(split + whole, summed + rest)}
    metrics = dict(metrics)
    if mkeys:
        for j, k in enumerate(mkeys):
            metrics[k] = rest[-1][j] / n
    return {k: out[k] for k in grads}, metrics


def sharded_norm(grads: Dict[str, torch.Tensor],
                 layout: Layout) -> torch.Tensor:
    """The norm of the global gradients from this rank's shards: each
    leaf's squares on the ranks that hold a distinct piece of it (rank 0
    of an axis it is replicated on), summed over fsdp x tp."""
    specs = layout.specs
    _, f, t = layout.mesh.coords(layout.rank)
    sq = [g.float().square().sum() for k, g in grads.items()
          if ("fsdp" in specs[k] or f == 0) and ("tp" in specs[k] or t == 0)]
    dev = next(iter(grads.values())).device
    total = torch.stack(sq).sum() if sq else torch.zeros((), device=dev)
    return all_reduce(total, layout.groups["model"]).sqrt()


def _apply_update(optimizer: GroupedAdamW, state: TrainState,
                  grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                  metrics: Dict, layout: Optional[Layout] = None
                  ) -> Tuple[TrainState, Dict]:
    """The optimizer update (in place on ``state.params``) and the shared
    metrics: ``loss`` and ``grad_norm``, the global norm of the trainable
    gradients (what the reference's clip_grad_norm_ returns), both of the
    global batch under data parallelism (and over the mesh with a
    ``layout``)."""
    metrics = dict(metrics, loss=loss)
    if layout is None:
        grads, metrics = average_across_ranks(grads, metrics)
        metrics["grad_norm"] = optimizer.update(state.params, grads,
                                                state.opt_state)
    else:
        grads, metrics = average_sharded(grads, metrics, layout)
        metrics["grad_norm"] = optimizer.update(
            state.params, grads, state.opt_state,
            sharded_norm(grads, layout))
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def _make_step(cfg: DeerConfig, optimizer: GroupedAdamW, *, phase: str,
               bin_coef: float, calvin_multiplier: float, grad_accum: int,
               vl_weight: float = 1.0, layout: Optional[Layout] = None):
    """``step(state, batch, vl_batch, gen, draws)``: the update of
    ``make_train_step`` (``vl_batch`` None) and of ``make_cotrain_step``."""
    keys = optimizer.trainable_keys()

    def step(state: TrainState, batch: Dict, vl_batch: Optional[Dict],
             gen: Optional[Union[torch.Generator, RowShard]],
             draws: Optional[Sequence[dict]]) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = loss_and_grads(
            state.params, keys, batch, cfg, phase=phase, bin_coef=bin_coef,
            calvin_multiplier=calvin_multiplier, grad_accum=grad_accum,
            gen=gen, draws=draws, vl_batch=vl_batch, vl_weight=vl_weight,
            layout=layout)
        flat = flat_leaves(state.params)
        grads = {k: torch.zeros_like(flat[k]) if g is None else g
                 for k, g in grads.items()}
        return _apply_update(optimizer, state, grads, loss, metrics, layout)

    return step


def make_train_step(cfg: DeerConfig, optimizer: GroupedAdamW, *,
                    phase: str = "joint", bin_coef: float = 0.01,
                    calvin_multiplier: float = 1.0, grad_accum: int = 1,
                    layout: Optional[Layout] = None):
    """``step(state, batch, gen=None, draws=None) -> (state, metrics)``.

    batch: image, gripper (B*W, 1, 1, 3, H, W); input_ids, attention_mask
    (B*W, S), or (B, S) under 'vit_concat'; labels (B, W, 7) or
    (B, W, k, 7); state (B*W, 1, 1, state_dim) for a state model.  The
    trainable leaves are the optimizer's non-frozen ones; they hold fp32
    masters and are updated in place, so the state passed in is the state
    returned.  ``calvin_multiplier`` scales the loss before the gradient;
    the logged loss is the scaled one (train_utils.py:549).  ``gen`` may be
    a ``RowShard`` (data parallel: the global batch's draws).  ``layout``:
    the fsdp x tp step over this rank's shards (the module docstring); the
    batch is this rank's data shard, equal on the ranks of a tp group."""
    inner = _make_step(cfg, optimizer, phase=phase, bin_coef=bin_coef,
                       calvin_multiplier=calvin_multiplier,
                       grad_accum=grad_accum, layout=layout)

    def step(state: TrainState, batch: Dict,
             gen: Optional[Union[torch.Generator, RowShard]] = None,
             draws: Optional[Sequence[dict]] = None
             ) -> Tuple[TrainState, Dict]:
        return inner(state, batch, None, gen, draws)

    return step


def make_cotrain_step(cfg: DeerConfig, optimizer: GroupedAdamW, *,
                      phase: str = "joint", bin_coef: float = 0.01,
                      vl_weight: float = 1.0, calvin_multiplier: float = 1.0,
                      grad_accum: int = 1):
    """The co-training step (``--cotrain``, train_calvin_post_strategy.py:
    296-302; JAX ``make_cotrain_step``): one update from
    ``calvin_multiplier`` times the imitation loss plus ``vl_weight`` times
    the LM loss of a caption / VQA batch,
    ``step(state, batch, vl_batch, gen=None, draws=None)``.  vl_batch:
    {image (B, 1, 1, 3, H, W), input_ids, attention_mask, [answer_mask]};
    ``grad_accum`` splits both batches, so it divides both batch sizes.
    The logged ``loss`` is the combined one; ``lm_loss``, ``lm_acc`` and
    ``tokens`` join the metrics."""
    inner = _make_step(cfg, optimizer, phase=phase, bin_coef=bin_coef,
                       calvin_multiplier=calvin_multiplier,
                       grad_accum=grad_accum, vl_weight=vl_weight)

    def step(state: TrainState, batch: Dict, vl_batch: Dict,
             gen: Optional[Union[torch.Generator, RowShard]] = None,
             draws: Optional[Sequence[dict]] = None
             ) -> Tuple[TrainState, Dict]:
        return inner(state, batch, vl_batch, gen, draws)

    return step
