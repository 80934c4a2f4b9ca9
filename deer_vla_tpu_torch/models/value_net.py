"""The dynamic-exit control plane: the action-consistency criterion, the
calibration deltas, the threshold solver and the exit controller (the JAX
package's ``models/value_net.py``; the reference's value_net.py
ActionValueNet :72-160, ExitController :163-297, generate_action_values
:301-399).

The delta generators run on the hidden states' device.  Their random
draws (the warm-prefix permutations, the streamed generator's committed
exits) come from an explicit ``torch.Generator`` or from the caller.
``exit_probs``, ``solve_thresholds`` and ``ExitController`` are numpy
copies of the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.heads import (any_head_forward, any_head_step,
                                             any_zero_carry, head_actions,
                                             pick_carry, tile_carry)


def get_delta(a1: torch.Tensor, a2: torch.Tensor,
              threshold_type: str = "L2") -> torch.Tensor:
    """Distance between two (..., action_dim) arm actions, reduced over the
    last dim.  Default 'L2' is the root mean square of the difference."""
    d = (a1 - a2).abs()
    if threshold_type == "mean":
        return d.mean(-1)
    if threshold_type == "L2":
        return d.square().mean(-1).sqrt()
    if threshold_type == "max":
        return d.amax(-1)
    if threshold_type == "cosine":
        f1 = a1 / a1.norm(dim=-1, keepdim=True).clamp_min(1e-5)
        f2 = a2 / a2.norm(dim=-1, keepdim=True).clamp_min(1e-5)
        return 1.0 - (f1 * f2).sum(-1)
    raise NotImplementedError(threshold_type)


# ---------------------------------------------------------------------------
# calibration deltas (value_net.py:134-160, 'generate' mode)
# ---------------------------------------------------------------------------


def generate_exit_deltas(extra_exit_params: dict, hidden_states: torch.Tensor,
                         rand_layer_feat: torch.Tensor, cfg: DeerConfig,
                         exit_list: Sequence[int], threshold_type: str = "L2",
                         warm_prefix: int = 0,
                         gen: Optional[torch.Generator] = None,
                         state: Optional[torch.Tensor] = None,
                         warm_perms: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The folded calibration deltas (n_exit, B * n_positions).

    hidden_states (L, B*W, S, D) are all layer outputs of a batch,
    rand_layer_feat (B*W, S, D) the sampling-1 features.  Row k is the
    action gap between exit_list[k] and the previous entry of
    [0] + exit_list at window positions W//2-1 .. W-2, each scored after a
    history prefix of random-layer features from a zero carry.
    'vit_concat' folds the window into the media tokens: one position a
    trajectory, no prefix.  ``warm_prefix`` (window-folded, w == 1, models
    only) puts that many frames of other trajectories' random-layer
    features before the scored one: the (B, warm_prefix) batch
    permutations come from ``gen`` or from the caller as ``warm_perms``.
    ``state`` (B*W, ..., dim) proprio rows reach a state head frame by
    frame, the prefix's too (under 'vit_concat' each trajectory's last
    row).  All entries of [0] + exit_list run as one batch through the
    head."""
    assert 0 not in exit_list
    w = 1 if cfg.fusion_mode == "vit_concat" else cfg.window_size
    s, d = hidden_states.shape[2], hidden_states.shape[3]
    ids = [0] + list(exit_list)
    feats = hidden_states[ids].reshape(len(ids), -1, w, s, d)
    rand = rand_layer_feat.reshape(-1, w, s, d)
    b = rand.shape[0]

    st = None
    if state is not None and cfg.head.use_state:
        st = state.reshape(-1, state.shape[-1])
        if w == 1 and st.shape[0] != b:
            st = st.reshape(b, -1, st.shape[-1])[:, -1:]
        else:
            st = st.reshape(-1, w, st.shape[-1])  # (B, W, dim)

    warm = warm_st = None
    if w == 1 and warm_prefix > 0:
        if warm_perms is None:
            assert gen is not None, "warm_prefix needs a generator"
            warm_perms = torch.stack(
                [torch.randperm(b, generator=gen, device=gen.device)
                 for _ in range(warm_prefix)], dim=1)
        warm_perms = warm_perms.to(rand.device)
        warm = rand[:, 0][warm_perms]  # (B, K, S, D)
        if st is not None:
            warm_st = st[:, 0][warm_perms]  # (B, K, dim)

    per_seq = []
    for seq_id in range(max(w // 2 - 1, 0), max(w - 1, 1)):
        prev = rand[:, :seq_id]
        if warm is not None:
            prev = torch.cat([warm, prev], dim=1)
        st_win = None
        if st is not None:
            st_win = st[:, :seq_id + 1]
            if warm_st is not None:
                st_win = torch.cat([warm_st, st_win], dim=1)
            # the same rows for every entry of [0] + exit_list
            st_win = st_win.expand(len(ids), *st_win.shape).reshape(
                -1, st_win.shape[-1])
        last = feats[:, :, seq_id:seq_id + 1]
        combined = torch.cat([prev.expand(len(ids), *prev.shape), last],
                             dim=2)  # (n_exit + 1, B, T, S, D)
        t = combined.shape[2]
        out = any_head_forward(extra_exit_params, combined.reshape(-1, s, d),
                               cfg, st_win, window=t, last_action=True)
        per_seq.append(head_actions(out, cfg)[:, 0].reshape(len(ids), b,
                                                            -1))
    acts = torch.stack(per_seq, dim=2)  # (n_exit + 1, B, n_seq, 6k)
    delta = get_delta(acts[1:], acts[:-1], threshold_type)
    return delta.reshape(delta.shape[0], -1)


def streamed_probs(n_exit: int, exit_sample_probs=None) -> np.ndarray:
    """The commit distribution: the given probabilities normalized, uniform
    when none are given or they are degenerate (sum 0 or not finite)."""
    probs = (np.full(n_exit, 1.0 / n_exit) if exit_sample_probs is None
             else np.asarray(exit_sample_probs, np.float64))
    if not probs.sum() > 0 or not np.all(np.isfinite(probs)):
        probs = np.full(n_exit, 1.0 / n_exit)
    return probs / probs.sum()


# unscored passes over a window before the scored one in the streamed
# regime (the JAX package's default warm_rounds)
WARM_ROUNDS = 1


def generate_streamed_exit_deltas(extra_exit_params: dict,
                                  hidden_states: torch.Tensor,
                                  cfg: DeerConfig, exit_list: Sequence[int],
                                  threshold_type: str = "L2",
                                  gen: Optional[torch.Generator] = None,
                                  exit_sample_probs=None,
                                  state: Optional[torch.Tensor] = None,
                                  commit_exits=None) -> torch.Tensor:
    """The streamed calibration deltas (n_exit, B * n_positions): the
    serving carry regime inside calibration.

    One LSTM carry threads each trajectory window's timesteps (zero at
    t = 0); at each t every entry of [0] + exit_list steps the head from the
    same incoming carry and consecutive entries' actions give the deltas;
    the carry committed is the candidate of one exit per timestep, shared by
    the batch.  ``WARM_ROUNDS`` passes over the window commit without
    scoring first; the scored pass contributes positions t >= W//2 - 1, the
    last one included.  The committed exits, ``(WARM_ROUNDS + 1) * W``
    indices into exit_list, come from ``commit_exits`` or are drawn from
    ``gen`` with ``exit_sample_probs`` (default uniform)."""
    assert 0 not in exit_list
    if cfg.fusion_mode == "vit_concat" or cfg.window_size < 2:
        raise ValueError(
            "streamed calibration needs a real time window "
            f"(fusion_mode={cfg.fusion_mode}, window={cfg.window_size}); "
            "use warm_prefix for window-folded models")
    if cfg.use_hist:
        raise ValueError("streamed calibration does not apply to use_hist "
                         "models; use the default folded calibration")
    w = cfg.window_size
    s, d = hidden_states.shape[2], hidden_states.shape[3]
    ids = [0] + list(exit_list)
    n_ids, n_exit = len(ids), len(exit_list)
    feats = hidden_states[ids].reshape(n_ids, -1, w, s, d)
    b = feats.shape[1]
    n_commit = (WARM_ROUNDS + 1) * w
    if commit_exits is None:
        if gen is None:
            gen = torch.Generator(device=hidden_states.device).manual_seed(0)
        p = torch.as_tensor(streamed_probs(n_exit, exit_sample_probs),
                            dtype=torch.float32, device=gen.device)
        commit_exits = torch.multinomial(p, n_commit, replacement=True,
                                         generator=gen)
    commit = [int(i) for i in np.asarray(
        commit_exits.cpu() if isinstance(commit_exits, torch.Tensor)
        else commit_exits).reshape(-1)]
    if len(commit) != n_commit:
        raise ValueError(f"{len(commit)} committed exits for {n_commit} "
                         "timesteps")

    dev = hidden_states.device
    st = None
    if state is not None and cfg.head.use_state:
        st = state.reshape(b, w, -1)
    carry = any_zero_carry(cfg, b, device=dev)
    per_t = []
    for r in range(WARM_ROUNDS + 1):
        for t in range(w):
            rep = tile_carry(cfg, carry, n_ids)
            st_t = None if st is None else st[:, t].repeat(n_ids, 1)
            out, cand = any_head_step(extra_exit_params,
                                      feats[:, :, t].reshape(-1, s, d), rep,
                                      cfg, st_t)
            if r == WARM_ROUNDS and t >= max(w // 2 - 1, 0):
                a = out.actions[:, 0].reshape(n_ids, b, -1)
                per_t.append(get_delta(a[1:], a[:-1], threshold_type))
            k = commit[r * w + t] + 1  # entry 0 is never committed
            carry = pick_carry(cfg, cand, n_ids, k)
    delta = torch.stack(per_t, dim=2)  # (n_exit, B, n_positions)
    return delta.reshape(delta.shape[0], -1)


# ---------------------------------------------------------------------------
# threshold solver (value_net.py:206-272)
# ---------------------------------------------------------------------------


def exit_probs(real_num_exit: int, exit_ratio: float, exit_dist: str = "exp",
               model_name: str = "mpt_dolly_3b") -> np.ndarray:
    if exit_dist == "exp":
        probs = exit_ratio ** np.arange(1, real_num_exit + 1,
                                        dtype=np.float64)
    elif exit_dist == "gauss":
        center = exit_ratio
        probs = np.array([math.exp(-(i - center) ** 2 / 2.0)
                          for i in range(real_num_exit)])
    elif exit_dist == "gamma":
        from scipy import stats
        x = np.arange(1, real_num_exit + 1, dtype=np.float64)
        probs = stats.gamma.pdf(x, exit_ratio, scale=2.0)
    else:
        raise ValueError(exit_dist)
    if "mpt_9b" in model_name:
        probs[0] = 0.0  # exits from the 4th layer on (value_net.py:235-236)
    return probs / probs.sum()


def solve_thresholds(pred_values: np.ndarray, exit_ratio: float,
                     exit_id_list: Sequence[int], max_layer: int,
                     exit_dist: str = "exp", leq: bool = True,
                     model_name: str = "mpt_dolly_3b"
                     ) -> Tuple[Dict[int, float], np.ndarray]:
    """Per-exit thresholds such that the samples' exit distribution matches
    the target ``exit_probs`` schedule (value_net.py:206-272).

    pred_values: (n_exit, n_sample) calibration deltas.  Returns
    ({exit_id: threshold}, probs)."""
    pred_values = np.asarray(pred_values)
    n_stage, n_sample = pred_values.shape
    real_ids = [x for x in exit_id_list if x <= max_layer]
    real_num_exit = len(real_ids)
    probs = exit_probs(real_num_exit, exit_ratio, exit_dist, model_name)

    sorted_idx = np.argsort(pred_values, axis=1)
    if not leq:
        sorted_idx = sorted_idx[:, ::-1]
    filtered = np.zeros(n_sample)
    T = np.full(real_num_exit, -1e8 if leq else 1e8, dtype=np.float64)

    for k in range(real_num_exit - 1):
        count = 0
        out_n = math.floor(n_sample * probs[k])
        for i in range(n_sample):
            ori_idx = sorted_idx[k][i]
            if filtered[ori_idx] == 0:
                count += 1
                if count == out_n:
                    T[k] = pred_values[k][ori_idx]
                    break
        if leq:
            filtered += (pred_values[k] <= T[k]).astype(np.float64)
        else:
            filtered += (pred_values[k] >= T[k]).astype(np.float64)

    T[real_num_exit - 1] = 1e8 if leq else -1e8
    thresholds = {int(real_ids[i]): float(T[i]) for i in range(real_num_exit)}
    return thresholds, probs


# ---------------------------------------------------------------------------
# exit controller (host-side state)
# ---------------------------------------------------------------------------


@dataclass
class ExitController:
    """Decision state for dynamic exit (value_net.py:163-297): thresholds,
    the steps_per_stage memory and the previous committed action.  The
    delta itself is computed on the device; this compares it with the
    threshold."""

    exit_id_list: Sequence[int]
    steps_per_stage: int = 1
    leq: bool = True
    max_layer: int = 12  # counts layers, not index
    thresholds: Optional[Dict[int, float]] = None
    threshold_type: str = "L2"

    cur_step: int = 0
    cur_exit_id: int = 10 ** 9
    prev_action: Optional[np.ndarray] = None
    action_list: List = field(default_factory=list)

    def __post_init__(self):
        self.effective_max = min(self.max_layer - 1, self.exit_id_list[-1])

    def set_thresholds(self, thresholds: Dict[int, float]) -> None:
        self.thresholds = thresholds

    def set_threshold_values(self, values: Sequence[float]) -> None:
        """Direct threshold setting for BO search (value_net.py:177-183)."""
        real_ids = [x for x in self.exit_id_list if x <= self.effective_max]
        assert len(values) == len(real_ids)
        self.thresholds = {int(i): float(v) for i, v in zip(real_ids, values)}

    def reset_episode(self) -> None:
        self.cur_exit_id = 10 ** 9
        self.prev_action = None
        self.action_list = []

    def set_timestep(self, t: int) -> None:
        self.cur_step = t

    def reuse_stage_exit(self) -> bool:
        """True mid-stage: reuse the previous exit (value_net.py:284-286)."""
        return (self.steps_per_stage > 1
                and self.cur_step % self.steps_per_stage != 0)

    def should_exit(self, exit_id: int, delta: float) -> bool:
        """Threshold compare for one evaluated exit (value_net.py:288-297)."""
        assert self.thresholds is not None, "set thresholds before rollout"
        if exit_id not in self.exit_id_list:
            return False
        take = ((delta <= self.thresholds[exit_id]) if self.leq
                else (delta >= self.thresholds[exit_id]))
        if take or exit_id >= self.effective_max:
            self.cur_exit_id = exit_id
            return True
        return False

    def record_action(self, action) -> None:
        """action: (arm, gripper_prob) tuple or bare arm array."""
        self.action_list.append(action)
        self.prev_action = action[0] if isinstance(action, tuple) else action

    def get_ensemble_action(self):
        """Mean of the last two evaluated exits' actions, arm and gripper
        (value_net.py:92-95)."""
        assert len(self.action_list) > 0
        last = self.action_list[-2:]
        if isinstance(last[0], tuple):
            arms, grips = zip(*last)
            return (np.mean(np.stack(arms, 0), axis=0),
                    np.mean(np.stack(grips, 0), axis=0))
        return np.mean(np.stack(last, 0), axis=0)
