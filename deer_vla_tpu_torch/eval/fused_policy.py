"""Cond-chain dynamic-exit engine (the JAX package's
``eval/fused_policy.py``): an EQUIVALENCE ORACLE, not a serving path.

The serving engine is ``eval/scan_policy.ScanDeerPolicy`` (what
``cli/eval --engine fused`` and every serving surface run).  This engine
computes the same dynamic exit through an independent structure: one chain
of exit buckets, each bucket (decoder layers (prev_exit, exit_k], the
speculative head and the delta compare) run only while the batch has not
exited.  It is kept to hold the other engines to on small configurations
(tests/test_torch_fused_policy.py); new engine features land on the scan
engine and are not required here.  It is wired into no CLI or server.

Semantics, as in the JAX package:
  * the buckets are (prev_exit, exit_k], cut at ``max_layer``;
  * ``done`` is ONE flag for the whole batch, and a bucket's delta is
    ``get_delta(...).mean()`` over the batch (the scan engine exits per
    stream: that difference is what makes this an independent oracle);
  * the first bucket compares against the pseudo action from the layer
    below it, each later bucket against the previous bucket's action;
  * ``take = ~done & (delta <= thresholds[k] | last)``, and the action,
    gripper, carry and exit layer are selected where ``take``; the head
    and its carry run in fp32;
  * ``multi_step_action`` k > 1 gives a flat 6k arm, and ``step`` emits a
    (k, 7) plan;
  * ``steps_per_stage`` reuse swaps the runtime threshold row (-inf below
    the previous step's exit, +inf at it).

JAX's ``lax.cond`` runs only the taken branch; here each bucket reads
``done`` on the host once and a plain branch runs the bucket or its skip.
The decoder runs ``linear`` on the unstacked per-layer weights
(``models/mpt.decoder_segment_forward``), as the JAX engine's does, so
K2-K4 do not run here; K1 runs in the ViT of the encode prefix.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.eval.scan_policy import (HostInputs,
                                                 check_serving_supported,
                                                 host_actions)
from deer_vla_tpu_torch.models.action_head import head_step
from deer_vla_tpu_torch.models.flamingo import encode_vision
from deer_vla_tpu_torch.models.mpt import decoder_segment_forward, embed_tokens
from deer_vla_tpu_torch.models.value_net import get_delta
from deer_vla_tpu_torch.ops.lstm import zero_carry


def build_fused_step(cfg: DeerConfig, exit_ids: List[int],
                     threshold_type: str = "L2",
                     max_layer: Optional[int] = None):
    """Returns (step, exits): ``step(params, img, grip, ids, mask, carry,
    thresholds)`` -> (arm (B, 6k), gripper_prob (B, k), new carry,
    exit_layer () int32, deltas (n_exits,)), ``thresholds`` one value an
    exit.  ``deltas`` holds each bucket's batch-mean delta, +inf where the
    bucket was skipped (what JAX's skip branch returns)."""
    ml = (max_layer if max_layer is not None else cfg.n_layers) - 1
    exits = [e for e in exit_ids if e <= ml] or [exit_ids[0]]
    segments = []
    prev = 0
    for e in exits:
        segments.append((prev, e + 1))
        prev = e + 1
    head_key = "lm_head" if cfg.share_exit else "extra_exit"
    # multi_step_action k > 1: arm width 6k, gripper width k (the flat head
    # output); the exit delta spans the whole plan, as in DeerPolicy
    adim = cfg.head.out_features * cfg.head.multi_step_action
    gdim = cfg.head.multi_step_action

    def step(params, img, grip, ids, mask, carry, thresholds):
        media = encode_vision(params, img, grip, cfg)
        x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
        mloc = ids == cfg.media_token_id
        head = params[head_key]
        b, dev = x.shape[0], x.device

        def zeros(width):
            return torch.zeros(b, width, dtype=torch.float32, device=dev)

        done = torch.zeros((), dtype=torch.bool, device=dev)
        best_arm, best_grip, best_carry = zeros(adim), zeros(gdim), carry
        exit_layer = torch.zeros((), dtype=torch.int32, device=dev)
        # the reference chain within a step (value_net.py:120-133): the
        # first bucket's pseudo action, then each bucket's own action
        ref_action = zeros(adim)
        deltas = []

        def run(k, start, stop, x, ref_action):
            x_prev, x_out = decoder_segment_forward(
                params["decoder"], x, mask, media, cfg, start, stop, mloc)
            # head and carry in fp32: the LSTM carry lives for the whole
            # episode, bf16 accumulation would drift
            out, cand = head_step(head, x_out.float(), carry, cfg.head)
            action = out.actions[:, 0].float()
            if k == 0:
                # the first exit compares with the pseudo action from the
                # layer below it, every step (value_net.py:121-126)
                pseudo, _ = head_step(head, x_prev.float(), carry, cfg.head)
                ref = pseudo.actions[:, 0].float()
            else:
                ref = ref_action
            delta = get_delta(action, ref, threshold_type).mean()
            return (x_out, action, out.gripper_probs[:, 0].float(), cand,
                    delta)

        def skip(x):
            return (x, zeros(adim), zeros(gdim), carry,
                    torch.full((), float("inf"), device=dev))

        for k, (start, stop) in enumerate(segments):
            if bool(done):  # lax.cond's predicate: the one host read
                # the skip branch commits nothing (take is false), so its
                # +inf delta never meets a threshold
                deltas.append(skip(x)[4])
                continue
            x, action, grip_k, cand, delta = run(k, start, stop, x,
                                                 ref_action)
            deltas.append(delta)
            take = delta <= thresholds[k]
            if k == len(segments) - 1:
                take = torch.ones_like(take)
            best_arm = torch.where(take, action, best_arm)
            best_grip = torch.where(take, grip_k, best_grip)
            best_carry = tuple(torch.where(take, c, bc)
                               for c, bc in zip(cand, best_carry))
            exit_layer = torch.where(take, torch.tensor(
                stop - 1, dtype=torch.int32, device=dev), exit_layer)
            ref_action = action
            done = take

        return (best_arm, best_grip, best_carry, exit_layer,
                torch.stack(deltas))

    return step, exits


class FusedDeerPolicy(HostInputs):
    """Single-stream policy over the cond-chain step, with the public
    surface of ``eval/policy.DeerPolicy`` (``reset`` / ``set_timestep`` /
    ``step`` / ``last_exit_layer``) and ``set_thresholds`` (a list or a
    dict by exit).  ``steps_per_stage`` reuse goes through the runtime
    threshold row, as in the scan engine.  ``last_deltas`` holds the last
    step's per-bucket deltas (+inf where skipped).  The device is the card
    unless given; the refusals are ``check_serving_supported``'s with the
    JAX engine's arguments (no window-folded variant, the LSTM head
    only)."""

    def __init__(self, params: dict, cfg: DeerConfig,
                 exit_ids: Optional[List[int]] = None,
                 thresholds=None, threshold_type: str = "L2",
                 max_layer: Optional[int] = None, steps_per_stage: int = 1,
                 device=None):
        check_serving_supported(cfg)
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device)
        self.cfg = cfg
        exit_ids = list(exit_ids or cfg.all_exit_ids())
        self._step, self.exits = build_fused_step(cfg, exit_ids,
                                                  threshold_type, max_layer)
        if thresholds is None:
            thresholds = [1e8] * len(self.exits)
        self.set_thresholds(thresholds)
        self.steps_per_stage = steps_per_stage
        self.reset()

    def set_thresholds(self, thresholds) -> None:
        if isinstance(thresholds, dict):
            thresholds = [thresholds[e] for e in self.exits]
        if len(thresholds) != len(self.exits):
            raise ValueError(f"{len(thresholds)} thresholds for exits "
                             f"{self.exits}")
        self.thresholds = self._upload(np.asarray(thresholds, np.float32))

    def reset(self) -> None:
        self.carry = None
        self.cur_step = 0
        self.last_exit_layer = -1
        self.last_deltas: Optional[np.ndarray] = None

    def set_timestep(self, t: int) -> None:
        self.cur_step = t

    def _stage_thresholds(self) -> torch.Tensor:
        """steps_per_stage reuse (value_net.py:284-286): mid-stage, force
        the exit at the previous step's bucket through the runtime row
        (-inf below it, +inf at it)."""
        if (self.steps_per_stage <= 1
                or self.cur_step % self.steps_per_stage == 0
                or self.last_exit_layer < 0):
            return self.thresholds
        full = np.full(len(self.exits), -np.inf, np.float32)
        full[self.exits.index(self.last_exit_layer)] = np.inf
        return self._upload(full)

    @torch.inference_mode()
    def step(self, image, gripper, input_ids, attention_mask,
             state=None) -> np.ndarray:
        """One env step: the first stream's 7-dof action, or its (k, 7)
        plan for multi_step_action k > 1.  ``state`` is accepted and not
        read, as in the JAX engine."""
        img = self._image(image)
        if self.carry is None:
            self.carry = zero_carry(self.cfg.head.lstm_num_layers,
                                    img.shape[0], self.cfg.head.hidden_size,
                                    torch.float32, self.device)
        arm, grip, self.carry, exit_layer, deltas = self._step(
            self.params, img, self._image(gripper), self._ids(input_ids),
            self._upload(attention_mask), self.carry,
            self._stage_thresholds())
        self.last_exit_layer = int(exit_layer)
        self.last_deltas = deltas.cpu().numpy()
        return host_actions(arm[:1].cpu().numpy(), grip[:1].cpu().numpy(),
                            self.cfg.head.multi_step_action)[0]
