"""DDPM / DDIM plan sampling for ``head_type='diffusion'`` serving (the JAX
package's ``eval/diffusion_policy.py``; the reference's ModelWrapper
use_diff branch, eval_utils.py:388-419).

Each env step the wrapped policy returns the chosen exit's conditioning
feature (the diffusion head's LSTM output).  The sampler then:
  1. normalizes the executed-action history (n_obs_steps - 1 actions, zero
     at episode start, eval_utils.py:257-258);
  2. inpaints it into the first rows of a horizon-long ``cond`` under a
     ``mask`` (:402-410);
  3. samples the plan with the U-Net: the full DDPM chain, or a DDIM
     subsequence of ``sample_steps`` evaluations;
  4. unnormalizes, keeps the supervised rows [hist, window) (or the first
     ``future_act_len``), binarizes the gripper (:411-419) and records the
     plan as history.

A plan's draws come from a generator seeded from (seed, counter): the
sequential wrapper's counter counts its steps, the batched one keeps a
counter a lane, so a lane's plan depends only on its features, its history
and its own counter, never on the lanes beside it.
"""

from __future__ import annotations

import copy
import functools
from collections import deque
from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.eval.step_worker import run_inline
from deer_vla_tpu_torch.models.diffusion import (conditional_sample,
                                                 conditional_sample_ddim,
                                                 ddpm_buffers, sampler_noise)
from deer_vla_tpu_torch.models.heads import diffusion_head_config


def plan_generator(seed: int, count: int, device) -> torch.Generator:
    """The generator of the plan numbered ``count`` under ``seed``."""
    state = np.random.SeedSequence([int(seed), int(count)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class _PlanSampler:
    """The U-Net, the schedule and the normalizer of a diffusion model on
    ``device``, and the one sampling call both wrappers make."""

    def __init__(self, cfg, params: dict, device, sample_steps: int,
                 ddim_eta: float):
        if cfg.head_type != "diffusion":
            raise ValueError(f"head_type {cfg.head_type!r} is not diffusion")
        self.dcfg = diffusion_head_config(cfg)
        self.hist_len = cfg.n_obs_steps - 1
        self.window = cfg.window_size
        self.adim = self.dcfg.input_dim
        self.device = torch.device(device)
        norm = params["diffusion"]["norm"]
        self.scale, self.offset = (
            torch.as_tensor(norm[k]).float().cpu().numpy()
            for k in ("scale", "offset"))
        self.unet = to_torch(params["diffusion"]["unet"], self.device,
                             torch.float32)
        self.buf = ddpm_buffers(self.dcfg)
        self.sample_steps = sample_steps
        self.eta = ddim_eta

    def cond(self, hist: np.ndarray):
        """(B, hist_len, adim) raw history -> the normalized, inpainted
        (cond, mask), each (B, horizon, adim), on the device."""
        b = hist.shape[0]
        cond = np.zeros((b, self.dcfg.horizon, self.adim), np.float32)
        cond[:, :self.hist_len] = hist * self.scale + self.offset
        mask = np.zeros(cond.shape, bool)
        mask[:, :self.hist_len] = True
        return (torch.as_tensor(cond, device=self.device),
                torch.as_tensor(mask, device=self.device))

    def noise(self, seed: int, counts) -> torch.Tensor:
        """(1 + steps, B, horizon, adim): each lane's draws from its own
        generator."""
        shape = (self.dcfg.horizon, self.adim)
        return torch.stack([sampler_noise(
            plan_generator(seed, c, self.device), shape, self.dcfg,
            self.sample_steps) for c in counts], dim=1)

    def sample(self, cond, mask, feats, noise) -> torch.Tensor:
        if self.sample_steps and self.sample_steps > 0:
            return conditional_sample_ddim(
                self.unet, self.buf, cond, mask, self.dcfg, feats,
                noise=noise, steps=self.sample_steps, eta=self.eta)
        return conditional_sample(self.unet, self.buf, cond, mask, self.dcfg,
                                  feats, noise=noise)

    def plans(self, x: np.ndarray, future_act_len: int) -> np.ndarray:
        """Sampled (B, horizon, adim) -> executed (B, k, adim) plans:
        unnormalized, the supervised rows only (training masks the loss to
        rows [hist, window)) or the first ``future_act_len``, the gripper
        at +-1."""
        plans = (x[:, self.hist_len:] - self.offset) / self.scale
        if future_act_len > 0:
            plans = plans[:, :future_act_len]
        else:
            plans = plans[:, :max(1, self.window - self.hist_len)]
        plans[..., -1] = np.where(plans[..., -1] > 0.5, 1.0, -1.0)
        return plans.astype(np.float32)


class DiffusionSamplerPolicy:
    """The policy surface of ``DeerPolicy`` (step / reset / set_timestep /
    cfg / last_exit_layer) around a diffusion model's ``DeerPolicy`` or
    ``ScanDeerPolicy``: ``step`` returns a (k, 7) plan for the rollout's
    queue.  The U-Net runs on the wrapped policy's device."""

    def __init__(self, policy, params: dict, future_act_len: int = -1,
                 seed: int = 0, sample_steps: int = 0,
                 ddim_eta: float = 0.0):
        self.policy = policy
        self.cfg = policy.cfg
        self.device = policy.device
        self.sampler = _PlanSampler(self.cfg, params, policy.device,
                                    sample_steps, ddim_eta)
        self.hist_len = self.sampler.hist_len
        self.future_act_len = future_act_len
        self.seed = seed
        self._step_i = 0
        self.reset()

    @property
    def last_exit_layer(self) -> int:
        return self.policy.last_exit_layer

    def reset(self):
        self.policy.reset()
        # zero action history at episode start (eval_utils.py:257-258);
        # the plan counter runs on
        self._hist = deque([np.zeros(self.sampler.adim, np.float32)
                            for _ in range(self.hist_len)],
                           maxlen=max(self.hist_len, 1))

    def set_timestep(self, t: int):
        self.policy.set_timestep(t)

    @torch.inference_mode()
    def step(self, image, gripper, input_ids, attention_mask,
             state=None) -> np.ndarray:
        if state is not None:
            feature = self.policy.step(image, gripper, input_ids,
                                       attention_mask, state=state)
        else:
            feature = self.policy.step(image, gripper, input_ids,
                                       attention_mask)
        s = self.sampler
        hist = (np.stack(list(self._hist)) if self.hist_len
                else np.zeros((0, s.adim), np.float32))
        cond, mask = s.cond(hist[None])
        noise = s.noise(self.seed, [self._step_i])
        self._step_i += 1
        feat = torch.as_tensor(np.asarray(feature, np.float32),
                               device=s.device)[None]
        plan = s.plans(s.sample(cond, mask, feat, noise).cpu().numpy(),
                       self.future_act_len)[0]
        # the rollout queue executes the whole plan: it is the history
        # (eval_utils.py:674 appends a row an env step)
        for a in plan:
            self._hist.append(a)
        return plan


class BatchedDiffusionSampler:
    """The lane analogue of ``DiffusionSamplerPolicy`` for
    ``eval/batched_rollout`` (``--lanes`` with a diffusion model), around a
    ``ScanDeerPolicy``: one batched U-Net chain a dispatch over every lane,
    with each lane's own history and plan counter.

    ``reset_streams(mask)`` zeroes the masked lanes' histories (their
    counters run on, as the sequential ``reset`` keeps its own); ``active``
    parks lanes: their counters do not advance and their histories stay.
    ``copy.copy`` (the harness's per-group split) copies the engine
    (shared weights, its own carry) and gives the copy fresh lane state.
    Other attributes are the engine's."""

    def __init__(self, policy, params: dict, future_act_len: int = -1,
                 seed: int = 0, sample_steps: int = 0,
                 ddim_eta: float = 0.0):
        self.policy = policy
        self.cfg = policy.cfg
        self.sampler = _PlanSampler(self.cfg, params, policy.device,
                                    sample_steps, ddim_eta)
        self.hist_len = self.sampler.hist_len
        self.future_act_len = future_act_len
        self.seed = seed
        self._hist: Optional[np.ndarray] = None    # (B, hist_len, adim)
        self._counts: Optional[np.ndarray] = None  # (B,) plan counters

    def _ensure_lanes(self, b: int) -> None:
        if self._hist is None or self._hist.shape[0] != b:
            self._hist = np.zeros((b, self.hist_len, self.sampler.adim),
                                  np.float32)
            self._counts = np.zeros(b, np.int64)

    def reset(self):
        self.policy.reset()
        self._hist = None
        self._counts = None

    def reset_streams(self, stream_mask) -> None:
        self.policy.reset_streams(stream_mask)
        if self._hist is not None:
            self._hist[np.asarray(stream_mask, bool)] = 0.0

    def __copy__(self):
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.policy = copy.copy(self.policy)
        new._hist = None
        new._counts = None
        return new

    def __getattr__(self, name):
        if name.startswith("_") or name == "policy":
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "policy"), name)

    @torch.inference_mode()
    def dispatch_batch(self, image, gripper, input_ids, attention_mask,
                       state=None, active=None):
        """The engine's batched step, then the plans of every lane from
        the features on the device, handed to the engine's worker thread
        as ``ScanDeerPolicy.dispatch_batch`` hands its step: the handle
        comes back at once.  ``active`` (bool (B,)): lanes marked False
        are parked."""
        return self.policy.submit(functools.partial(
            self._sample_batch, image, gripper, input_ids, attention_mask,
            state, active))

    def _sample_batch(self, image, gripper, input_ids, attention_mask,
                      state, active):
        feats, _, exit_layer = self.policy.run_batch(
            image, gripper, input_ids, attention_mask, state)
        b = feats.shape[0]
        self._ensure_lanes(b)
        s = self.sampler
        cond, mask = s.cond(self._hist)
        x = s.sample(cond, mask, feats.float(),
                     s.noise(self.seed, self._counts))
        act = (np.ones(b, bool) if active is None
               else np.asarray(active, bool))
        self._counts = self._counts + act
        return x, exit_layer, act

    def finish_batch(self, handle):
        """(B, k, 7) plans and exit layers (B,); each active lane's executed
        rows become its history.  A failed step's exception is raised
        here."""
        x, exit_layer, act = self.policy.collect(handle)
        plans = self.sampler.plans(x.cpu().numpy(), self.future_act_len)
        k = plans.shape[1]
        if self.hist_len:
            if k >= self.hist_len:
                new_hist = plans[:, k - self.hist_len:k]
            else:
                new_hist = np.concatenate([self._hist[:, k:], plans], axis=1)
            self._hist = np.where(act[:, None, None], new_hist, self._hist)
        return plans, exit_layer.cpu().numpy().astype(np.int64)

    @torch.inference_mode()
    def step_batch(self, image, gripper, input_ids, attention_mask,
                   state=None, active=None):
        """``dispatch_batch`` and ``finish_batch`` with the step run on the
        calling thread."""
        self.policy._check_idle("step_batch")
        return self.finish_batch(run_inline(functools.partial(
            self._sample_batch, image, gripper, input_ids, attention_mask,
            state, active), self.device))
