"""AdamW with the reference's parameter groups (the JAX package's
``train/optimizer.py``, get_grouped_params train_calvin_post_strategy.py:
466-525), written as a plain-tensor update that repeats the JAX package's
optax chain step for step:

  1. frozen leaves get no gradient at all;
  2. the global norm of the trainable gradients is clipped to ``clip_norm``
     as optax does, ``g / |g| * clip_norm`` when ``|g| >= clip_norm``
     (``torch.nn.utils.clip_grad_norm_`` divides by ``|g| + 1e-6``);
  3. Adam moments and bias correction (b1 0.9, b2 0.999, eps 1e-8);
  4. weight decay added after the Adam scaling, on the pre-update
     parameter, only where ``apply_decay_path`` says (gated x-attn matrices,
     and the heads with ``exit_decay``);
  5. the step times the schedule's learning rate at the update count
     (step 0 of a warmup has lr 0), heads times ``exit_lr_scale`` in the
     joint phase.

The groups key off the tree's path names, as in the JAX package.  The
state is kept flat (``{"count", "mu", "nu"}`` over the trainable leaves);
``GroupedAdamW.state_dict`` lays it out as flax's ``to_state_dict`` lays
out the state of the JAX package's chain, and ``moments_of_state_dict``
reads that layout back, so either package resumes the other's moments.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.ops.layers import (flat_key, keystr,
                                           tree_leaves_with_path,
                                           tree_map_with_path)

B1, B2, EPS = 0.9, 0.999, 1e-8
# the labels of the JAX chain's multi_transform, each an AdamW chain but
# 'frozen' (set_to_zero)
ADAMW_LABELS = ("wd", "nowd", "wd_scaled", "nowd_scaled")


# ---------------------------------------------------------------------------
# path predicates (the reference's name rules, on jax keystr paths)
# ---------------------------------------------------------------------------


def is_head_path(ps: str) -> bool:
    return ("'lm_head'" in ps) or ("'lm_exits'" in ps) \
        or ("'extra_exit'" in ps) or ("'diffusion'" in ps)


def is_xattn_path(ps: str) -> bool:
    return "'xattn'" in ps


def apply_decay_path(ps: str, exit_decay: bool = False) -> bool:
    base = is_xattn_path(ps) or (exit_decay and is_head_path(ps))
    return (base
            and "ff_gate" not in ps
            and "attn_gate" not in ps
            and "norm" not in ps and "'ln" not in ps and "ln'" not in ps
            and "bias" not in ps and "'b'" not in ps
            and "scale" not in ps)


# ---------------------------------------------------------------------------
# schedules (optax's, evaluated on the host)
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init
    return lambda count: ((init - end) * (1 - min(max(count, 0), steps)
                                          / steps) + end)


def _join(first, second, boundary: int) -> Callable[[int], float]:
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_schedule(kind: str, base_lr: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """Learning rate at an update count: a linear warmup from 0, then
    'linear' decay to 0 at ``total_steps``, 'cosine' decay to 0, or
    (anything else) the constant ``base_lr``."""
    warm = _linear(0.0, base_lr, warmup_steps)
    if kind == "linear":
        return _join(warm, _linear(base_lr, 0.0,
                                   max(1, total_steps - warmup_steps)),
                     warmup_steps)
    if kind == "cosine":
        decay = max(total_steps, warmup_steps + 1) - warmup_steps

        def cosine(count):
            c = min(count, decay)
            return base_lr * 0.5 * (1 + math.cos(math.pi * c / decay))
        return _join(warm, cosine, warmup_steps)
    return _join(warm, lambda count: base_lr, warmup_steps)


def adaptive_lr(base_lr: float, batch_size: int, world_size: int) -> float:
    """base_lr * (batch / 6) * (world_size / 8)
    (train_calvin_post_strategy.py:527-529)."""
    return base_lr * (batch_size / 6.0) * (world_size / 8.0)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in fp32."""
    return torch.stack([g.float().square().sum()
                        for g in grads.values()]).sum().sqrt()


class GroupedAdamW:
    """The phase optimizer.  ``labels`` maps every leaf's flat key to its
    group: 'wd' / 'nowd' (with or without weight decay), '_scaled' for
    the heads' ``exit_lr_scale``, or 'frozen'.  The state is a dict
    ``{"count": int, "mu": {key: tensor}, "nu": {key: tensor}}`` over the
    non-frozen leaves, which ``update`` changes in place."""

    def __init__(self, labels: Dict[str, str],
                 schedule: Callable[[int], float], weight_decay: float,
                 exit_lr_scale: float, clip_norm: float = 1.0):
        self.labels = labels
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.exit_lr_scale = exit_lr_scale
        self.clip_norm = clip_norm

    def trainable_keys(self):
        return [k for k, lab in self.labels.items() if lab != "frozen"]

    def init(self, params: dict) -> dict:
        flat = flat_leaves(params)
        mu = {k: torch.zeros_like(flat[k]) for k in self.trainable_keys()}
        return {"count": 0, "mu": mu,
                "nu": {k: torch.zeros_like(v) for k, v in mu.items()}}

    def lr(self, count: int, label: str) -> float:
        scale = self.exit_lr_scale if label.endswith("_scaled") else 1.0
        # optax evaluates the schedule and multiplies by the scale in fp32
        lr32 = torch.tensor(self.schedule(count), dtype=torch.float32)
        return float(lr32 * torch.tensor(scale, dtype=torch.float32))

    @torch.no_grad()
    def update(self, params: dict, grads: Dict[str, torch.Tensor],
               state: dict) -> torch.Tensor:
        """One step on the leaves of ``params`` named in ``grads`` (every
        non-frozen leaf, fp32).  Returns the unclipped global norm."""
        flat = flat_leaves(params)
        gnorm = global_norm(grads)
        clip = not bool(gnorm < self.clip_norm)
        count = state["count"] + 1
        bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** count)
        lrs = {label: self.lr(state["count"], label)
               for label in set(self.labels.values())}
        for key, g in grads.items():
            label = self.labels[key]
            p, mu, nu = flat[key], state["mu"][key], state["nu"][key]
            if clip:
                g = (g / gnorm.to(g.device)) * self.clip_norm
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * g.square())
            u = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
            if label.startswith("wd"):
                u = u + self.weight_decay * p
            p.add_(-lrs[label] * u)
        state["count"] = count
        return gnorm

    def state_dict(self, state: dict, params: dict) -> dict:
        """``state`` in the layout ``flax.serialization.to_state_dict``
        gives the state of the JAX package's chain ``masked(set_to_zero)``
        -> ``clip_by_global_norm`` -> ``multi_transform`` over the labels
        (train/optimizer.py:86-140): under each AdamW label
        ``{"inner_state": {"0": ScaleByAdamState, "1": {}, "2":
        ScaleByScheduleState}}``, its ``mu`` / ``nu`` shaped like
        ``params`` (lists as {"0": ...}), a leaf of another label as ``{}``
        (optax's MaskedNode).  Counts are int32 tensors, the moments the
        state's own tensors."""
        count = torch.tensor(state["count"], dtype=torch.int32)

        def moments(label, which):
            return _state_dict_of(tree_map_with_path(
                lambda path, _: (state[which][flat_key(path)]
                                 if self.labels[flat_key(path)] == label
                                 else {}), params))

        inner = {label: {"inner_state": {
            "0": {"count": count, "mu": moments(label, "mu"),
                  "nu": moments(label, "nu")},
            "1": {}, "2": {"count": count}}} for label in ADAMW_LABELS}
        inner["frozen"] = {"inner_state": {}}
        return {"0": {"inner_state": {}}, "1": {},
                "2": {"inner_states": inner}}


def _state_dict_of(tree):
    """A tree as flax's ``to_state_dict`` gives it: lists and tuples as
    dicts keyed "0", "1", ..."""
    if isinstance(tree, dict):
        return {str(k): _state_dict_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict_of(v) for i, v in enumerate(tree)}
    return tree


def moments_of_state_dict(sd: dict) -> Tuple[int, dict, dict]:
    """(count, {key: mu leaf}, {key: nu leaf}) of an optax-layout state
    dict (``GroupedAdamW.state_dict``'s, or the JAX package's), the leaves
    as stored; the AdamW labels' counts must agree."""
    inner = sd["2"]["inner_states"]
    counts, mu, nu = set(), {}, {}

    def collect(node, out, prefix=()):
        if isinstance(node, dict):  # a subtree, or {} for a MaskedNode
            for k, v in node.items():
                collect(v, out, prefix + (k,))
        elif node is not None:
            out["/".join(prefix)] = node

    for label in ADAMW_LABELS:
        adam = inner[label]["inner_state"]["0"]
        counts.add(int(np.asarray(adam["count"])))
        collect(adam["mu"], mu)
        collect(adam["nu"], nu)
    if len(counts) != 1:
        raise ValueError(f"the optimizer state's labels disagree on the "
                         f"update count: {sorted(counts)}")
    return counts.pop(), mu, nu


def flat_leaves(params: dict) -> Dict[str, torch.Tensor]:
    """{flat key: leaf} of a parameter tree (the leaves themselves)."""
    return {flat_key(path): leaf
            for path, leaf in tree_leaves_with_path(params)}


def make_optimizer(params: dict, cfg: DeerConfig, *, phase: str,
                   learning_rate: float, warmup_steps: int, total_steps: int,
                   scheduler: str = "constant", weight_decay: float = 0.1,
                   exit_lr_scale: float = 1.0, exit_decay: bool = False,
                   trainable: Optional[dict] = None,
                   clip_norm: float = 1.0) -> GroupedAdamW:
    """The phase optimizer: phase='joint' trains the backbone's trainable
    leaves and the heads (lr-scaled), 'exit_only' the heads alone;
    ``trainable`` (a boolean tree) freezes every leaf it marks False."""
    del cfg  # the groups depend on the tree's names only
    mask = (None if trainable is None
            else dict(tree_leaves_with_path(trainable)))
    labels = {}
    for path, _ in tree_leaves_with_path(params):
        ps = keystr(path)
        head = is_head_path(ps)
        if (phase == "exit_only" and not head) \
                or (mask is not None and not mask[path]):
            labels[flat_key(path)] = "frozen"
            continue
        decay = apply_decay_path(ps, exit_decay)
        scaled = head and phase == "joint" and exit_lr_scale != 1.0
        labels[flat_key(path)] = ("wd" if decay else "nowd") \
            + ("_scaled" if scaled else "")
    return GroupedAdamW(labels, make_schedule(scheduler, learning_rate,
                                              warmup_steps, total_steps),
                        weight_decay, exit_lr_scale, clip_norm)
