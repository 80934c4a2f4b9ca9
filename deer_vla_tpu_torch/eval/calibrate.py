"""Offline threshold calibration (the JAX package's ``eval/calibrate.py``;
the reference's generate_action_values + set_threshold, value_net.py:185-272
and 301-399).

For each calibration batch: preprocess the frames on the device, run the
training forward once with every layer's output kept, compute the per-exit
action deltas there, bring them to the host; then solve the thresholds for
the target exit distribution.  The deltas can be cached in a sidecar
(``train/checkpoint.save_calibration_values``).

Random draws (the sampling-1 layer ids, the streamed regime's committed
exits) come from one ``torch.Generator`` that advances batch by batch, or
per batch from the caller (``draws``: one dict per batch with any of
``rand_layer_ids``, ``switch_layer_ids``, ``commit_exits``, ``warm_perms``).
Models with proprio state calibrate on the batch's ``robot_obs`` rows, as
they train and serve.  The port runs one process, so no all-gather is
taken here.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.data.preprocess import (preprocess_train_frames,
                                                state_rows)
from deer_vla_tpu_torch.data.text import window_text
from deer_vla_tpu_torch.models.flamingo import forward_train
from deer_vla_tpu_torch.models.value_net import (exit_probs,
                                                 generate_exit_deltas,
                                                 generate_streamed_exit_deltas,
                                                 solve_thresholds)


def make_delta_fn(cfg: DeerConfig, threshold_type: str = "L2",
                  warm_prefix: int = 0, streamed: bool = False,
                  exit_sample_probs=None):
    """The backbone (every layer) + calibration deltas of one batch.
    ``streamed=True`` threads one LSTM carry across each window and commits
    exits sampled from ``exit_sample_probs``
    (``generate_streamed_exit_deltas``); ``warm_prefix`` warms a
    window-folded model's head with other trajectories' frames."""
    exit_list = list(cfg.all_exit_ids())

    @torch.inference_mode()
    def delta_fn(params, image, gripper, input_ids, attention_mask,
                 gen: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None, state=None) -> torch.Tensor:
        draws = draws or {}
        out = forward_train(params, image, input_ids, attention_mask, cfg,
                            gen, vision_gripper=gripper, state_tensor=state,
                            only_extra_exit=True, train=False,
                            rand_layer_ids=draws.get("rand_layer_ids"),
                            switch_layer_ids=draws.get("switch_layer_ids"))
        if streamed:
            return generate_streamed_exit_deltas(
                params["extra_exit"], out.hidden_states, cfg, exit_list,
                threshold_type, gen=gen, exit_sample_probs=exit_sample_probs,
                state=state, commit_exits=draws.get("commit_exits"))
        return generate_exit_deltas(
            params["extra_exit"], out.hidden_states, out.rand_layer_feat, cfg,
            exit_list, threshold_type, warm_prefix=warm_prefix, gen=gen,
            state=state, warm_perms=draws.get("warm_perms"))

    return delta_fn


def batch_inputs(batch: Dict[str, np.ndarray], cfg: DeerConfig,
                 device: torch.device):
    """One raw batch -> (image, gripper, input_ids, attention_mask) on
    ``device`` in the training forward's (B*W, ...) layout: frames resized
    and normalized there (no random shift), the instruction repeated per
    frame (once a window under 'vit_concat') and padded to
    ``cfg.text_len``.  A state model's rows come from ``state_rows``."""
    w = cfg.window_size
    stat = torch.as_tensor(batch["rgb_static"], device=device)
    grip = torch.as_tensor(batch["rgb_gripper"], device=device)
    img, gri = preprocess_train_frames(
        None, stat.reshape(-1, *stat.shape[2:]),
        grip.reshape(-1, *grip.shape[2:]), rgb_pad=0, gripper_pad=0,
        window=w, size=cfg.vit.image_size,
        gripper_size=cfg.gripper_res or None)
    ids, mask = window_text(batch["input_ids"], batch["attention_mask"], cfg)
    return (img, gri, torch.as_tensor(ids.astype(np.int64), device=device),
            torch.as_tensor(mask.astype(np.int64), device=device))


def generate_calibration_values(params: dict, cfg: DeerConfig,
                                batches: Iterable[Dict[str, np.ndarray]], *,
                                gen: Optional[torch.Generator] = None,
                                threshold_type: str = "L2",
                                max_batches: Optional[int] = None,
                                warm_prefix: int = 0,
                                streamed: bool = False,
                                exit_sample_probs=None,
                                draws: Optional[List[Dict]] = None
                                ) -> np.ndarray:
    """The calibration pass over raw batches on the parameters' device:
    (n_exit, n_samples) deltas, fp32 on the host."""
    dev = params["decoder"]["wte"]["w"].device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    delta_fn = make_delta_fn(cfg, threshold_type, warm_prefix,
                             streamed=streamed,
                             exit_sample_probs=exit_sample_probs)
    outs = []
    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        d = delta_fn(params, *batch_inputs(batch, cfg, dev), gen,
                     draws[bi] if draws is not None else None,
                     state_rows(batch, cfg, dev))
        outs.append(d.float().cpu().numpy())
    return np.concatenate(outs, axis=1)


def streamed_sample_probs(cfg: DeerConfig, exit_ratio: float,
                          max_layer: Optional[int], exit_dist: str,
                          model_name: str) -> List[float]:
    """The target exit distribution over every exit (0 past max_layer):
    the streamed regime commits exits from it, so the calibration carries
    follow the mix the solved thresholds will realize."""
    ml = max_layer if max_layer is not None else cfg.n_layers
    exits = list(cfg.all_exit_ids())
    live = [e for e in exits if e <= ml - 1] or exits[:1]
    p = exit_probs(len(live), exit_ratio, exit_dist, model_name)
    return list(p) + [0.0] * (len(exits) - len(live))


def calibrate(params: dict, cfg: DeerConfig,
              batches: Iterable[Dict[str, np.ndarray]], exit_ratio: float, *,
              max_layer: Optional[int] = None, exit_dist: str = "exp",
              model_name: str = "mpt_dolly_3b", threshold_type: str = "L2",
              values: Optional[np.ndarray] = None,
              max_batches: Optional[int] = None, warm_prefix: int = 0,
              streamed: bool = False, gen: Optional[torch.Generator] = None,
              draws: Optional[List[Dict]] = None
              ) -> Tuple[Dict[int, float], np.ndarray]:
    """The set_threshold flow: ({exit: threshold}, values).  ``values``
    skips the generation (the cached deltas)."""
    if values is None:
        esp = (streamed_sample_probs(cfg, exit_ratio, max_layer, exit_dist,
                                     model_name) if streamed else None)
        values = generate_calibration_values(
            params, cfg, batches, gen=gen, threshold_type=threshold_type,
            max_batches=max_batches, warm_prefix=warm_prefix,
            streamed=streamed, exit_sample_probs=esp, draws=draws)
    ml = max_layer if max_layer is not None else cfg.n_layers
    thresholds, _ = solve_thresholds(
        values, exit_ratio, list(cfg.all_exit_ids()), ml - 1,
        exit_dist=exit_dist, model_name=model_name)
    return thresholds, values
