"""The two-phase "post strategy" trainer (the JAX package's
``train/trainer.py``, the loop of train_calvin_post_strategy.py:30-694).

Phases (train_calvin_post_strategy.py:644-660):
  epochs [0, num_joint_epochs)                  joint: backbone + heads
  epochs [num_joint_epochs, + num_exit_epochs)  exit-only: the backbone runs
                                                under no_grad, heads train

Each phase starts a fresh optimizer with its own schedule (two AdamW
optimizers, train_calvin_post_strategy.py:535-585); auto-resume picks the
newest checkpoint and restores the phase optimizer's state (:589-629).
A diffusion model's action normalizer is fitted on the loader's actions
before training (``fit_action_normalizer``).  The tcp-frame labels
(``--tcp_rel``) wait for ROADMAP.md M9b and co-training for M16.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.data.preprocess import (preprocess_train_frames,
                                                state_rows)
from deer_vla_tpu_torch.data.text import window_text
from deer_vla_tpu_torch.models.normalizer import SingleFieldLinearNormalizer
from deer_vla_tpu_torch.models.flamingo import (cast_frozen_to_bf16,
                                                checkpoint_mask, init_deer,
                                                trainable_mask)
from deer_vla_tpu_torch.ops.layers import (flat_key, tree_leaves_with_path,
                                           tree_map_with_path)
from deer_vla_tpu_torch.train.checkpoint import (check_init,
                                                 find_latest_checkpoint,
                                                 init_record,
                                                 load_checkpoint,
                                                 save_checkpoint)
from deer_vla_tpu_torch.train.optimizer import (adaptive_lr, flat_leaves,
                                                make_optimizer)
from deer_vla_tpu_torch.train.train_step import (TrainState,
                                                 init_train_state,
                                                 make_train_step)
from deer_vla_tpu_torch.utils.heartbeat import Heartbeat


@dataclass
class TrainConfig:
    run_dir: str = "runs/deer"
    num_joint_epochs: int = 4
    num_exit_epochs: int = 5
    joint_lr: float = 1e-4
    exit_lr: float = 2.5e-4
    joint_warmup_steps: int = 2500
    exit_warmup_steps: int = 2500
    joint_scheduler: str = "constant"
    exit_scheduler: str = "constant"
    weight_decay: float = 0.1
    exit_lr_scale: float = 1.0
    exit_decay: bool = False
    gradient_accumulation_steps: int = 1
    batch_size: int = 6
    world_size: int = 1
    rgb_pad: int = 10
    gripper_pad: int = 4
    traj_cons: bool = True
    real_data: bool = False
    # gripper-BCE weight; None = the reference rule (0.05 for real data,
    # else 0.01, train_utils.py:314-316)
    bin_coef: Optional[float] = None
    save_every_epoch: bool = True
    # save an epoch checkpoint when epoch % save_freq == 0; the last epoch
    # is always saved (train_calvin_post_strategy.py:688)
    save_freq: int = 1
    # scales the imitation loss before the gradient; the logged loss is
    # the scaled one (train_utils.py:322,549)
    loss_multiplier_calvin: float = 1.0
    # > 0: also checkpoint every N steps within an epoch
    # (train_utils.py:626-628)
    save_every_iter: int = -1
    logging_steps: int = 100
    seed: int = 42
    # > 0: an exponential moving average of the checkpointed leaves; each
    # checkpoint gains a sibling <name>_ema.ckpt (the reference has none)
    ema_decay: float = 0.0

    @property
    def num_epochs(self) -> int:
        return self.num_joint_epochs + self.num_exit_epochs


def prepare_batch(raw: Dict[str, np.ndarray], cfg: DeerConfig,
                  gen: Optional[torch.Generator], tcfg: TrainConfig,
                  device) -> Dict[str, torch.Tensor]:
    """A loader batch -> the train step's batch on ``device``: frames
    resized, normalized and randomly shifted there (shifts from ``gen``),
    the instruction repeated per frame (once a window under 'vit_concat')
    and padded to ``cfg.text_len``, the window's action labels, and a state
    model's proprio rows (the host-to-device flatten of
    train_utils.py:441-478)."""
    w = cfg.window_size
    stat = torch.as_tensor(raw["rgb_static"]).to(device)
    grip = torch.as_tensor(raw["rgb_gripper"]).to(device)
    img, gri = preprocess_train_frames(
        gen, stat.reshape(-1, *stat.shape[2:]),
        grip.reshape(-1, *grip.shape[2:]), rgb_pad=tcfg.rgb_pad,
        gripper_pad=tcfg.gripper_pad, traj_cons=tcfg.traj_cons, window=w,
        size=cfg.vit.image_size, gripper_size=cfg.gripper_res or None)
    ids, mask = window_text(raw["input_ids"], raw["attention_mask"], cfg)
    batch = {"image": img, "gripper": gri,
             "input_ids": torch.as_tensor(ids.astype(np.int64),
                                          device=device),
             "attention_mask": torch.as_tensor(mask.astype(np.int64),
                                               device=device),
             "labels": torch.as_tensor(raw["actions"][:, :w], device=device)}
    state = state_rows(raw, cfg, device)
    if state is not None:
        batch["state"] = state
    return batch


def fit_action_normalizer(params: dict, loader, max_actions: int = 10000,
                          mode: str = "limits") -> dict:
    """The diffusion head's normalizer fitted on up to ``max_actions``
    dataset actions (train_calvin_post_strategy.py:457-461: 'limits' mode
    over about 10k stacked actions), as an fp32 affine in
    params['diffusion']['norm'] on its device; a copy of ``params``."""
    if "diffusion" not in params:
        return params
    acts, n = [], 0
    for raw in loader:
        a = np.asarray(raw["actions"], np.float32)
        acts.append(a.reshape(-1, a.shape[-1]))
        n += acts[-1].shape[0]
        if n >= max_actions:
            break
    norm = SingleFieldLinearNormalizer().fit(np.concatenate(acts, axis=0),
                                             mode=mode)
    dev = params["diffusion"]["norm"]["scale"].device
    out = dict(params)
    out["diffusion"] = dict(params["diffusion"], norm={
        k: torch.as_tensor(norm.params[k], dtype=torch.float32, device=dev)
        for k in ("scale", "offset")})
    return out


class Trainer:
    """Trains ``cfg`` on ``loader`` (an iterable of raw batches with
    ``set_epoch`` and ``len``) on ``device`` (the card unless given).
    Without ``params`` the weights are ``init_deer(cfg, tcfg.seed)`` drawn
    on ``device``, which the checkpoints' meta records so that an
    evaluation can rebuild the frozen backbone a delta checkpoint
    overlays.  In bf16 compute the frozen leaves are cast to bf16 (they
    need no fp32 master); a diffusion model's normalizer is then fitted on
    the loader's actions.  The liveness file is
    <run_dir>/heartbeat.json."""

    def __init__(self, cfg: DeerConfig, tcfg: TrainConfig, loader,
                 params: Optional[dict] = None,
                 log_fn: Optional[Callable[[Dict], None]] = None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.loader = loader
        self.log_fn = log_fn or (lambda d: None)
        self.device = resolve_device(device)
        self.heartbeat = Heartbeat(os.path.join(tcfg.run_dir,
                                                "heartbeat.json"))
        # the training draws (shifts, layers, dropout) use a stream other
        # than the init's
        self.gen = torch.Generator(device=self.device).manual_seed(
            tcfg.seed + 1)
        self.init_meta = None
        if params is None:
            params = init_deer(cfg, seed=tcfg.seed, device=self.device)
            self.init_meta = init_record(tcfg.seed, self.device, cfg)
        if cfg.dtypes.compute_dtype == "bfloat16":
            params = cast_frozen_to_bf16(
                params, trainable_mask(params, cfg, "joint"))
        if cfg.head_type == "diffusion":
            # after the cast, so that the fitted affine stays fp32
            params = fit_action_normalizer(params, loader)
        self.params = params
        steps_per_epoch = len(loader)
        bin_coef = (tcfg.bin_coef if tcfg.bin_coef is not None
                    else (0.05 if tcfg.real_data else 0.01))
        self._phases = {}
        for phase, lr, warm, sched, n_ep in (
                ("joint", tcfg.joint_lr, tcfg.joint_warmup_steps,
                 tcfg.joint_scheduler, tcfg.num_joint_epochs),
                ("exit_only", tcfg.exit_lr, tcfg.exit_warmup_steps,
                 tcfg.exit_scheduler, tcfg.num_exit_epochs)):
            opt = make_optimizer(
                params, cfg, phase=phase,
                learning_rate=adaptive_lr(lr, tcfg.batch_size,
                                          tcfg.world_size),
                warmup_steps=warm, total_steps=max(1, steps_per_epoch * n_ep),
                scheduler=sched, weight_decay=tcfg.weight_decay,
                exit_lr_scale=tcfg.exit_lr_scale, exit_decay=tcfg.exit_decay,
                trainable=trainable_mask(params, cfg, phase))
            step = make_train_step(
                cfg, opt, phase=phase, bin_coef=bin_coef,
                calvin_multiplier=tcfg.loss_multiplier_calvin,
                grad_accum=tcfg.gradient_accumulation_steps)
            self._phases[phase] = (opt, step)
        self.state: Optional[TrainState] = None
        self.start_epoch = 0
        self._resume_ckpt = None
        self._resume_phase = None
        self._ema: Optional[Dict[str, torch.Tensor]] = None
        self._ema_keys = None
        if tcfg.ema_decay > 0:
            if not 0.0 < tcfg.ema_decay < 1.0:
                raise ValueError(f"ema_decay {tcfg.ema_decay} not in (0, 1)")
            self._ema_keys = [flat_key(p) for p, m in tree_leaves_with_path(
                checkpoint_mask(params, cfg)) if m]

    def _ema_step(self) -> None:
        flat = flat_leaves(self.state.params)
        d = float(self.tcfg.ema_decay)
        with torch.no_grad():
            if self._ema is None:  # the first step (or after a resume)
                self._ema = {k: flat[k].float().clone()
                             for k in self._ema_keys}
                return
            for k, e in self._ema.items():
                e.mul_(d).add_((1.0 - d) * flat[k].float())

    def _ema_params(self) -> dict:
        """The params with the EMA values in place of the tracked leaves."""
        def pick(path, leaf):
            e = self._ema.get(flat_key(path))
            return leaf if e is None else e.to(leaf.dtype)
        return tree_map_with_path(pick, self.params)

    def phase_of_epoch(self, epoch: int) -> str:
        return "joint" if epoch < self.tcfg.num_joint_epochs else "exit_only"

    def maybe_resume(self) -> int:
        """Load the newest checkpoint of the run dir, if any; returns the
        epoch training goes on from (a mid-epoch checkpoint re-runs its
        epoch from the start).  Raises when the checkpoint was trained over
        another backbone than this run's (another seed or generator
        device)."""
        ck = find_latest_checkpoint(self.tcfg.run_dir)
        if ck is None:
            return 0
        params, _, sidecar = load_checkpoint(ck, self.params)
        md = sidecar["meta"]
        check_init(md.get("init"), self.init_meta, ck)
        self.params = params
        ep = int(md.get("epoch", -1))
        self.start_epoch = ep if md.get("step") is not None else ep + 1
        self._resume_ckpt = ck
        self._resume_phase = md.get("phase")
        return self.start_epoch

    def train(self, num_epochs: Optional[int] = None) -> Dict:
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        if len(self.loader) == 0:
            raise ValueError(
                "empty loader: the dataset yields 0 batches at batch_size="
                f"{tcfg.batch_size}")
        last_metrics: Dict = {}
        metrics: Dict = {}
        cur_phase = None
        for epoch in range(self.start_epoch, num_epochs):
            phase = self.phase_of_epoch(epoch)
            if phase != cur_phase:
                opt, self._step_fn = self._phases[phase]
                self.state = None  # free the last phase's moments first
                self.state = init_train_state(self.params, opt)
                if (cur_phase is None and self._resume_ckpt
                        and self._resume_phase == phase):
                    _, opt_state, _ = load_checkpoint(
                        self._resume_ckpt, self.params,
                        opt_state_template=self.state.opt_state)
                    if opt_state is not None:
                        self.state = self.state._replace(opt_state=opt_state)
                cur_phase = phase
            self.loader.set_epoch(epoch)
            t0 = time.time()
            for it, raw in enumerate(self.loader):
                batch = prepare_batch(raw, self.cfg, self.gen, tcfg,
                                      self.device)
                self.state, metrics = self._step_fn(self.state, batch,
                                                    self.gen)
                if self._ema_keys is not None:
                    self._ema_step()
                self.heartbeat.beat(epoch=epoch, step=it, phase=phase)
                if (tcfg.save_every_iter > 0
                        and (it + 1) % tcfg.save_every_iter == 0):
                    self.save(epoch, step=it + 1)
                if (it + 1) % tcfg.logging_steps == 0:
                    last_metrics = _scalars(metrics)
                    self.log_fn({"epoch": epoch, "step": it, "phase": phase,
                                 **last_metrics})
            last_metrics = _scalars(metrics)
            last_metrics.update(epoch=epoch, phase=phase,
                                epoch_time=time.time() - t0)
            self.log_fn(last_metrics)
            if tcfg.save_every_epoch and (
                    epoch % max(1, tcfg.save_freq) == 0
                    or epoch == num_epochs - 1):
                self.save(epoch)
        return last_metrics

    def save(self, epoch: int, step: Optional[int] = None) -> str:
        """A delta checkpoint of the joint phase's trainable leaves, with
        the phase's optimizer state in the JAX package's optax layout; the
        meta holds the epoch, the phase, the seed and how the backbone was
        drawn."""
        mask = checkpoint_mask(self.params, self.cfg)
        name = f"deer_{epoch}" if step is None else f"deer_{epoch}_it{step}"
        path = os.path.join(self.tcfg.run_dir, name)
        phase = self.phase_of_epoch(epoch)
        meta = {"epoch": epoch, "phase": phase,
                "seed": self.tcfg.seed, "init": self.init_meta}
        if step is not None:
            meta["step"] = step
        opt_state = None
        if self.state is not None:
            opt_state = self._phases[phase][0].state_dict(
                self.state.opt_state, self.params)
        out = save_checkpoint(path, self.params, self.cfg, meta=meta,
                              trainable_mask=mask, opt_state=opt_state)
        if self._ema is not None:
            save_checkpoint(path + "_ema", self._ema_params(), self.cfg,
                            meta=dict(meta, ema_decay=self.tcfg.ema_decay),
                            trainable_mask=mask)
        return out


def _scalars(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if v.ndim == 0}
