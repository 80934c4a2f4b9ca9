"""Training-free serving caches: the port of the JAX package's
``eval/caching.py`` (the action cache and the two vision caches; the
rolling frame cache of window-folded models is ROADMAP.md M10).

  * ``ActionCachePolicy`` replays the previous action while the frame
    changes little (the policy does not run; an LSTM carry does not advance
    on a hit, so keep tau tight), refreshed every ``refresh_every`` steps.
  * ``VisionCacheScanPolicy`` / ``VisionCacheDeerPolicy`` reuse the encoded
    prefix (ViT, perceiver, token embedding) while the frame changes little
    and always run the decoder and head: exits, carries and actions follow
    the uncached protocol, only the vision conditioning is stale.

The gate is ``frame_delta``, a mean L2 between consecutive frames on a
subsampled grid, read on the host as one scalar.
"""

from __future__ import annotations

import torch


def frame_delta(a, b, stride: int = 4) -> torch.Tensor:
    """Mean L2 between two (..., 3, H, W) or (..., H, W, 3) frames (numpy
    or tensors) on a ``stride``-subsampled grid, as a 0-dim fp32 tensor."""
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).float().to(a.device)
    a = a.reshape(-1, *a.shape[-2:])[..., ::stride, ::stride]
    b = b.reshape(-1, *b.shape[-2:])[..., ::stride, ::stride]
    return (a - b).square().mean().sqrt()


class ActionCachePolicy:
    """Wraps a policy: replays its last action while the observation is
    static.  ``hits`` / ``steps`` count the replays and the calls;
    ``last_exit_layer`` is -1 on a hit (no decoder layer ran)."""

    def __init__(self, policy, tau: float = 0.03, refresh_every: int = 5):
        self.policy = policy
        self.cfg = policy.cfg
        self.device = policy.device
        self.tau = tau
        self.refresh_every = max(1, refresh_every)
        self.hits = 0
        self.steps = 0
        self.reset()

    def reset(self):
        self.policy.reset()
        self._prev_frame = None
        self._cached_action = None
        self._since_miss = 0
        self.last_exit_layer = self.policy.last_exit_layer

    def set_timestep(self, t: int):
        self.policy.set_timestep(t)

    def step(self, image, gripper, input_ids, attention_mask):
        self.steps += 1
        hit = False
        if (self._cached_action is not None
                and self._since_miss < self.refresh_every):
            hit = float(frame_delta(image, self._prev_frame)) <= self.tau
        if hit:
            self.hits += 1
            self._since_miss += 1
            self.last_exit_layer = -1
            return self._cached_action
        self._prev_frame = image
        self._since_miss = 1
        action = self.policy.step(image, gripper, input_ids, attention_mask)
        self._cached_action = action
        self.last_exit_layer = self.policy.last_exit_layer
        return action


class _VisionCacheBase:
    """The tau-gated prefix cache: on a miss run the engine's ``encode``
    and keep the prefix, on a hit reuse it; its ``step_from_encoded`` runs
    every step.  ``encode_hits`` / ``steps`` count the reuses and the
    calls."""

    def __init__(self, inner, tau: float = 0.05):
        self.inner = inner
        self.cfg = inner.cfg
        self.device = inner.device
        self.tau = tau
        self.encode_hits = 0
        self.steps = 0
        self.reset()

    def reset(self):
        self.inner.reset()
        self._prev_frame = None
        self._cached = None

    def set_timestep(self, t: int):
        self.inner.set_timestep(t)

    @property
    def last_exit_layer(self):
        return self.inner.last_exit_layer

    @property
    def carry(self):
        return self.inner.carry

    def step(self, image, gripper, input_ids, attention_mask):
        self.steps += 1
        hit = False
        if self._cached is not None:
            hit = float(frame_delta(image, self._prev_frame)) <= self.tau
        if not hit:
            self._cached = self.inner.encode(image, gripper, input_ids)
            self._prev_frame = image
        self.encode_hits += int(hit)
        media, x, mloc = self._cached
        return self.inner.step_from_encoded(media, x, mloc, attention_mask)


class VisionCacheScanPolicy(_VisionCacheBase):
    """The vision cache around ``ScanDeerPolicy``."""

    def set_thresholds(self, thresholds):
        self.inner.set_thresholds(thresholds)


class VisionCacheDeerPolicy(_VisionCacheBase):
    """The vision cache around the host-bucketed ``DeerPolicy``: a miss runs
    its ``_encode_prefix`` on ``enc_params`` / ``enc_stacked``
    (``DeerPolicy.encode``), every step its segment loop.

    Proprio-state models are refused: the state token is part of the cached
    media latents and changes every step."""

    def __init__(self, inner, tau: float = 0.05):
        from deer_vla_tpu_torch.eval.policy import DeerPolicy
        if not isinstance(inner, DeerPolicy):
            raise TypeError("VisionCacheDeerPolicy wraps the host-bucketed "
                            "DeerPolicy")
        if inner.cfg.use_state or inner.cfg.head.use_state:
            raise NotImplementedError(
                "--vision_cache_tau cannot serve state models: the proprio "
                "token is part of the cached media latents and changes "
                "every step")
        super().__init__(inner, tau)
