"""Training-free serving caches: the port of the JAX package's
``eval/caching.py``.

  * ``ActionCachePolicy`` replays the previous action while the frame
    changes little (the policy does not run; an LSTM carry does not advance
    on a hit, so keep tau tight), refreshed every ``refresh_every`` steps.
  * ``VisionCacheScanPolicy`` / ``VisionCacheDeerPolicy`` reuse the encoded
    prefix (ViT, perceiver, token embedding) while the frame changes little
    and always run the decoder and head: exits, carries and actions follow
    the uncached protocol, only the vision conditioning is stale.
  * ``FrameCachePolicy`` keeps a window-folded model's per-frame ViT tokens
    in a rolling queue on the device and encodes only the newest frame a
    step; it is exact.

The gate is ``frame_delta``, a mean L2 between consecutive frames on a
subsampled grid, read on the host as one scalar.
"""

from __future__ import annotations

from collections import deque

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

    def step(self, image, gripper, input_ids, attention_mask, state=None):
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
        action = self.policy.step(image, gripper, input_ids, attention_mask,
                                  state)
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

    def step(self, image, gripper, input_ids, attention_mask, state=None):
        self.steps += 1
        hit = False
        if self._cached is not None:
            hit = float(frame_delta(image, self._prev_frame)) <= self.tau
        if not hit:
            self._cached = self._encode(image, gripper, input_ids, state)
            self._prev_frame = image
        self.encode_hits += int(hit)
        media, x, mloc = self._cached
        return self.inner.step_from_encoded(media, x, mloc, attention_mask,
                                            state)

    def _encode(self, image, gripper, input_ids, state):
        return self.inner.encode(image, gripper, input_ids, state)


class VisionCacheScanPolicy(_VisionCacheBase):
    """The vision cache around ``ScanDeerPolicy``, stateless models only
    (as in the JAX package)."""

    def set_thresholds(self, thresholds):
        self.inner.set_thresholds(thresholds)

    def _encode(self, image, gripper, input_ids, state):
        if state is not None:
            raise ValueError("the scan engine's vision cache serves "
                             "stateless models")
        return self.inner.encode(image, gripper, input_ids)


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


class FrameCachePolicy:
    """The rolling per-frame ViT-token cache of a window-folded model
    ('vit_concat' / ``use_hist``) around ``ScanDeerPolicy``.

    Uncached, the windowed adapter re-encodes all W frames every step (the
    reference's img_queue, eval_utils.py:344-386).  This keeps a queue of
    the last W frames' ViT tokens on the device (per frame and independent
    of the window position: ``use_hist``'s frame embeddings are added at
    fuse time) and a step

      1. encodes only the newest frame (``ScanDeerPolicy.encode_frame``);
      2. concatenates the cached window;
      3. runs the perceiver, the window fold and the dynamic-exit decode
         (``ScanDeerPolicy.step_from_tokens``).

    The decode consumes the same token values the full re-encode gives, so
    it is exact.  ``feeds_single_frame``: the adapter passes the newest
    frame only and keeps its state queue and use_hist text tiling."""

    feeds_single_frame = True

    def __init__(self, inner):
        from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
        if not isinstance(inner, ScanDeerPolicy):
            raise TypeError("the frame cache drives ScanDeerPolicy's "
                            "encode / decode split")
        cfg = inner.cfg
        if not (cfg.fusion_mode == "vit_concat" or cfg.use_hist):
            raise ValueError("frame caching only applies to window-folded "
                             "models (vit_concat / use_hist)")
        self.inner = inner
        self.cfg = cfg
        self.device = inner.device
        self.window = cfg.window_size
        self.reset()

    def reset(self):
        self.inner.reset()
        self._rgb_q = deque(maxlen=self.window)
        self._grip_q = deque(maxlen=self.window)

    def set_timestep(self, t: int):
        self.inner.set_timestep(t)

    def set_thresholds(self, thresholds):
        self.inner.set_thresholds(thresholds)

    @property
    def last_exit_layer(self):
        return self.inner.last_exit_layer

    @property
    def carry(self):
        return self.inner.carry

    def step(self, image, gripper, input_ids, attention_mask, state=None):
        """image / gripper: the newest frame only, (1, 1, 1, 3, H, W);
        state: a state model's rows for the whole window."""
        if image.shape[0] != 1:
            raise ValueError(
                f"FrameCachePolicy.step takes the newest frame only (got "
                f"image batch {image.shape[0]}); the token window is cached "
                "on the device")
        tok_rgb, tok_grip = self.inner.encode_frame(image, gripper)
        # episode start: the window left-padded with the first frame
        # (eval_utils.py:344-349)
        for _ in range(self.window if not self._rgb_q else 1):
            self._rgb_q.append(tok_rgb)
            self._grip_q.append(tok_grip)
        tg = (torch.cat(list(self._grip_q)) if tok_grip is not None
              else None)
        return self.inner.step_from_tokens(torch.cat(list(self._rgb_q)), tg,
                                           input_ids, attention_mask, state)
