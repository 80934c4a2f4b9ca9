"""Debug data (a copy of the JAX package's ``data/debug_data.py``):
  * DebugBatcher: random batches in the exact training format (the
    reference's DebugDataset, data.py:588-597, get_calvin_dataset_debug
    :1191-1246);
  * make_synthetic_calvin: a CALVIN-format directory on disk
    (episode_XXXXXXX.npz frames + lang_annotations/auto_lang_ann.npy), so
    ``data/calvin.py`` and the training CLI run without the dataset.

numpy only and seeded by ``RandomState``, so the same seed gives the same
batches and files in both packages, but for one entry on purpose: the
port puts ``robot_obs``'s last entry, CALVIN's gripper state, at -1 or 1
(``with_gripper_state``), where the JAX package leaves a normal draw that
a state head cannot always look up.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Collection, Dict, Iterator

import numpy as np

from deer_vla_tpu_torch.core.config import DeerConfig

TASKS = ["rotate_blue_block_right", "lift_red_block", "open_drawer",
         "move_slider_left", "turn_on_lightbulb"]
INSTRUCTIONS = {
    "rotate_blue_block_right": "rotate the blue block to the right",
    "lift_red_block": "pick up the red block",
    "open_drawer": "open the drawer",
    "move_slider_left": "push the slider to the left",
    "turn_on_lightbulb": "turn on the light bulb",
}


class DebugBatcher:
    """Yields random batches shaped like the CALVIN loader's output.  With
    ``world_size`` > 1 it draws the global batch of ``batch_size *
    world_size`` trajectories and yields rank ``rank``'s contiguous
    ``batch_size`` of them, so that the ranks together see what one
    process with the global batch sees."""

    def __init__(self, cfg: DeerConfig, text_fn: Callable,
                 batch_size: int = 2, num_batches: int = 4, img_hw: int = 64,
                 grip_hw: int = 48, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        self.rank, self.world = rank, world_size
        self.cfg = cfg
        self.text_fn = text_fn
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.img_hw = img_hw
        self.grip_hw = grip_hw
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        r = np.random.RandomState(self.seed + self.epoch)
        w = self.cfg.window_size
        # multi_step_action k > 1: (B, w, k, 7) labels restacked from a
        # (w + k - 1)-frame window, as the real collation emits them
        k = self.cfg.head.multi_step_action
        bs = self.batch_size * self.world
        mine = slice(self.rank * self.batch_size,
                     (self.rank + 1) * self.batch_size)
        for _ in range(self.num_batches):
            texts = [INSTRUCTIONS[TASKS[r.randint(len(TASKS))]]
                     for _ in range(bs)]
            ids, mask = self.text_fn(texts)
            acts = np.clip(r.randn(bs, w + k - 1, 7).astype(np.float32) * 0.3,
                           -1, 1)
            acts[..., 6] = np.sign(acts[..., 6]) + (acts[..., 6] == 0)
            if k != 1:
                acts = np.stack([acts[:, i:i + k] for i in range(w)], axis=1)
            batch = {
                "rgb_static": r.randint(0, 256, (bs, w, self.img_hw,
                                                 self.img_hw, 3), np.uint8),
                "rgb_gripper": r.randint(0, 256, (bs, w, self.grip_hw,
                                                  self.grip_hw, 3), np.uint8),
                "actions": acts,
                "robot_obs": with_gripper_state(
                    r.randn(bs, w, 15).astype(np.float32)),
                "input_ids": ids, "attention_mask": mask,
            }
            batch = {key: v[mine] for key, v in batch.items()}
            batch["robot_obs_multi"] = np.zeros(1, np.float32)
            yield batch


def with_gripper_state(robot_obs: np.ndarray) -> np.ndarray:
    """``robot_obs`` with its last entry, CALVIN's gripper state, at -1 or 1
    (the sign of the draw), as CALVIN records it; a draw of 3 or more
    would be refused by ``data/preprocess.check_gripper_state``."""
    robot_obs[..., -1] = np.where(robot_obs[..., -1] >= 0, 1.0, -1.0)
    return robot_obs


def make_synthetic_calvin(root: str, n_episodes: int = 3, ep_len: int = 24,
                          img_hw: int = 32, grip_hw: int = 24,
                          split: str = "training", seed: int = 0,
                          compressed_episodes: Collection[int] = ()) -> str:
    """Write a CALVIN-format split of random frames under ``root``; returns
    the split directory.  The episodes whose index is in
    ``compressed_episodes`` are written with ``np.savez_compressed``
    (DEFLATE members), the others with ``np.savez`` (STORED, as CALVIN
    ships them); the arrays are the same either way."""
    r = np.random.RandomState(seed)
    d = Path(root) / split
    (d / "lang_annotations").mkdir(parents=True, exist_ok=True)
    spans, anns, tasks = [], [], []
    frame = 0
    for e in range(n_episodes):
        save = np.savez_compressed if e in compressed_episodes else np.savez
        start = frame
        for _ in range(ep_len):
            save(d / f"episode_{frame:07d}.npz",
                 rgb_static=r.randint(0, 256, (img_hw, img_hw, 3), np.uint8),
                 rgb_gripper=r.randint(0, 256, (grip_hw, grip_hw, 3),
                                       np.uint8),
                 rel_actions=np.clip(r.randn(7).astype(np.float32) * 0.3,
                                     -1, 1),
                 robot_obs=with_gripper_state(
                     r.randn(15).astype(np.float32)),
                 scene_obs=r.randn(24).astype(np.float32))
            frame += 1
        spans.append((start, frame - 1))
        task = TASKS[e % len(TASKS)]
        tasks.append(task)
        anns.append(INSTRUCTIONS[task])
    lang_data = {"info": {"indx": spans},
                 "language": {"ann": anns, "task": tasks}}
    np.save(d / "lang_annotations" / "auto_lang_ann.npy", lang_data,
            allow_pickle=True)
    return str(d)
