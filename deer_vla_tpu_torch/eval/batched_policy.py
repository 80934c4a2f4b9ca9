"""Batched host-sequenced serving: the port of the JAX package's
``eval/batched_policy.BatchedDeerPolicy``.

B streams share the weights and keep their own carries and exit state.
Each exit segment runs for the whole batch; a stream whose delta passes its
threshold keeps that segment's action and carry (a masked commit), and the
later segments still run for the batch, but no longer update it.  The host
reads one bool a segment, "has every stream exited?", and issues no further
segment once it has.  The batch therefore runs to its slowest stream's
exit; ``DeerPolicy`` at B=1 keeps each stream's own depth.

``steps_per_stage`` holds each stream's exit for that many of its steps:
mid-stage its threshold is +inf at the held exit and -inf before it.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

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


class BatchedDeerPolicy(HostInputs):
    """``batch`` parallel streams over one set of weights on ``device`` (the
    card unless given)."""

    def __init__(self, params: dict, cfg: DeerConfig, batch: int,
                 exit_ids: Optional[List[int]] = None,
                 thresholds: Optional[List[float]] = None,
                 threshold_type: str = "L2", steps_per_stage: int = 1,
                 device=None):
        check_serving_supported(cfg)
        self.device = resolve_device(device)
        self.params = to_torch(params, self.device)
        self.cfg = cfg
        self.batch = batch
        self.exit_ids = list(exit_ids or cfg.all_exit_ids())
        if thresholds is None:
            thresholds = [0.0] * (len(self.exit_ids) - 1) + [1e8]
        self.thresholds = list(thresholds)
        self.threshold_type = threshold_type
        self.steps_per_stage = steps_per_stage
        self._build()
        self.reset()

    def set_thresholds(self, thresholds: List[float]):
        self.thresholds = list(thresholds)

    def _build(self):
        cfg = self.cfg
        head_key = "lm_head" if cfg.share_exit else "extra_exit"

        def segment(start, stop, first_exit, params, x, mask, media, mloc,
                    carry, prev_action, done, best_out, best_carry,
                    exit_layers, thr):
            x_prev, x_out = decoder_segment_forward(
                params["decoder"], x, mask, media, cfg, start, stop, mloc)
            head = params[head_key]
            out, cand_carry = head_step(head, x_out.float(), carry, cfg.head)
            action = out.actions[:, 0]
            if first_exit:
                # the pseudo action from the layer below, every timestep
                # (value_net.py:121-126)
                pseudo, _ = head_step(head, x_prev.float(), carry, cfg.head)
                ref = pseudo.actions[:, 0]
            else:
                ref = prev_action
            delta = get_delta(action, ref, self.threshold_type).reshape(-1)
            exits_now = ~done & ((delta <= thr) | (stop >= cfg.n_layers))
            em = exits_now[:, None, None]
            best_out = tuple(torch.where(em, n, b) for n, b in
                             zip((out.actions, out.gripper_probs), best_out))
            best_carry = tuple(torch.where(exits_now[None, :, None], n, b)
                               for n, b in zip(cand_carry, best_carry))
            done = done | exits_now
            exit_layers = exit_layers.masked_fill(exits_now, stop - 1)
            return (x_out, done, best_out, best_carry, done.all(),
                    exit_layers, action)

        self._segments = []
        prev = 0
        for k, e in enumerate(self.exit_ids):
            self._segments.append(
                (e, functools.partial(segment, prev, e + 1, k == 0)))
            prev = e + 1

    def reset(self, stream_mask: Optional[np.ndarray] = None):
        """Every stream (or those where ``stream_mask`` is true) back to
        the start of an episode."""
        b = self.batch
        fresh = zero_carry(self.cfg.head.lstm_num_layers, b,
                           self.cfg.head.hidden_size, torch.float32,
                           self.device)
        if stream_mask is None or not hasattr(self, "carry"):
            self.carry = fresh
            self._t = np.zeros(b, np.int64)
            self._stage_exit = np.full(b, -1, np.int64)
        else:
            m = torch.as_tensor(np.asarray(stream_mask, bool),
                                device=self.device)
            self.carry = tuple(torch.where(m[None, :, None], f, c)
                               for f, c in zip(fresh, self.carry))
            self._t = np.where(stream_mask, 0, self._t)
            self._stage_exit = np.where(stream_mask, -1, self._stage_exit)

    @torch.inference_mode()
    def step(self, image, gripper, input_ids, attention_mask
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Every stream one env step: image / gripper (B, 1, 1, 3, H, W).
        Returns (actions (B, 7) or (B, k, 7), exit_layers (B,) int64)."""
        cfg = self.cfg
        ids = self._ids(input_ids)
        mask = self._upload(attention_mask)
        media = encode_vision(self.params, self._image(image),
                              self._image(gripper), cfg)
        x = embed_tokens(self.params["decoder"], ids, cfg.dtypes.cdt)
        mloc = ids == cfg.media_token_id
        b, dev = self.batch, self.device
        adim = cfg.head.out_features * cfg.head.multi_step_action
        gdim = cfg.head.multi_step_action
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        best_out = (torch.zeros(b, 1, adim, device=dev),
                    torch.zeros(b, 1, gdim, device=dev))
        best_carry = self.carry
        exit_layers = torch.full((b,), -1, dtype=torch.int64, device=dev)
        prev_action = torch.zeros(b, adim, device=dev)
        k_stage = self.steps_per_stage
        reuse = ((self._t % k_stage != 0) & (self._stage_exit >= 0)
                 if k_stage > 1 else np.zeros(b, bool))
        for j, (e, fn) in enumerate(self._segments):
            base = (1e30 if j == len(self._segments) - 1
                    else float(self.thresholds[j]))
            thr = np.where(reuse,
                           np.where(e >= self._stage_exit, 1e30, -1e30),
                           base).astype(np.float32)
            (x, done, best_out, best_carry, all_done, exit_layers,
             action) = fn(self.params, x, mask, media, mloc, self.carry,
                          prev_action, done, best_out, best_carry,
                          exit_layers, torch.as_tensor(thr, device=dev))
            prev_action = action
            if bool(all_done):  # the one host read of the segment
                break
        self.carry = best_carry
        el = exit_layers.cpu().numpy().astype(np.int64)
        if k_stage > 1:
            self._stage_exit = np.where(reuse, self._stage_exit, el)
        self._t += 1
        return (host_actions(best_out[0][:, 0].cpu().numpy(),
                             best_out[1][:, 0].cpu().numpy(),
                             cfg.head.multi_step_action), el)
