"""Real-robot HDF5 dataset (a copy of the JAX package's
``data/real_hdf5.py``; the reference's robot_flamingo/data/
real_dataset_hdf5.py), numpy only; ``h5py`` is imported inside the two
functions that open a file:
  * rotation helpers: intrinsic XYZ euler <-> rotm (Rz*Ry*Rx composition,
    real_dataset_hdf5.py:40-143), quaternion -> rotm, matrix log
  * relative end-effector actions: 'ee_rel_pose' (world deltas) and
    'ee_rel_pose_local' (a_trans = R_t^T (p_{t+1}-p_t), a_rot =
    euler(R_t^T R_{t+1}), wrapped to [-pi, pi]; :456-487) with the
    reference's POS x50 / ROT x33 scaling
  * the binary gripper state from gripper position + teleop command
    transitions (:144-200)
  * a meta.json trajectory index + data.hdf5 frame storage; fixed-length
    windows.

The HDF5 schema: groups rgb/static (N,H,W,3 uint8), rgb/hand, state (N,7
float32: xyz+rpy+gripper), optionally gripper_command.  Images stay raw
uint8; resize, normalization and augmentation run on the frames' device
(``data/preprocess.py``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# rotation helpers (real_dataset_hdf5.py:40-143)
# ---------------------------------------------------------------------------


def euler2rotm(euler: np.ndarray) -> np.ndarray:
    """R = Rz(c) @ Ry(b) @ Rx(a) for euler = (a, b, c)."""
    a, b, c = euler
    ca, sa = math.cos(a), math.sin(a)
    cb, sb = math.cos(b), math.sin(b)
    cc, sc = math.cos(c), math.sin(c)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rz @ ry @ rx


def rotm2euler(R: np.ndarray) -> np.ndarray:
    """Inverse of euler2rotm (learnopencv-style extraction,
    real_dataset_hdf5.py:95-114) — WITHOUT the reference's x += 2pi quirk so
    euler2rotm(rotm2euler(R)) == R and angles stay in [-pi, pi]."""
    sy = math.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-6:
        x = math.atan2(R[2, 1], R[2, 2])
        y = math.atan2(-R[2, 0], sy)
        z = math.atan2(R[1, 0], R[0, 0])
    else:
        x = math.atan2(-R[1, 2], R[1, 1])
        y = math.atan2(-R[2, 0], sy)
        z = 0.0
    return np.array([x, y, z])


def quat2rotm(quat: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> rotation matrix (real_dataset_hdf5.py:116-127)."""
    x, y, z, w = quat
    s = w * w + x * x + y * y + z * z
    return np.array([
        [1 - 2 * (y * y + z * z) / s, 2 * (x * y - z * w) / s, 2 * (x * z + y * w) / s],
        [2 * (x * y + z * w) / s, 1 - 2 * (x * x + z * z) / s, 2 * (y * z - x * w) / s],
        [2 * (x * z - y * w) / s, 2 * (y * z + x * w) / s, 1 - 2 * (x * x + y * y) / s]])


def get_mat_log(R: np.ndarray) -> np.ndarray:
    theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    w_hat = (R - R.T) * theta / (2 * np.sin(theta) + 1e-10)
    return np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])


def binary_gripper_from_pos(gripper_pos: np.ndarray, command: np.ndarray,
                            close_cmd: float = 1.0,
                            pos_change_threshold: float = 0.01) -> np.ndarray:
    """Binary open(1)/closed(0) state per frame, switching when the measured
    gripper position actually moves after the teleop command flips
    (real_dataset_hdf5.py:144-200, generalized to multiple transitions)."""
    n = len(gripper_pos)
    state = np.ones(n, np.float32)
    cur = 1.0
    pending: Optional[float] = None
    ref_pos = gripper_pos[0]
    for i in range(n):
        if i > 0 and command[i] != command[i - 1]:
            pending = 0.0 if command[i] == close_cmd else 1.0
            ref_pos = gripper_pos[i]
        if pending is not None and abs(gripper_pos[i] - ref_pos) > pos_change_threshold:
            cur = pending
            pending = None
        state[i] = cur
    return state


def relative_ee_action(state_t: np.ndarray, state_t1: np.ndarray,
                       mode: str = "ee_rel_pose_local",
                       pos_scale: float = 50.0, rot_scale: float = 33.0
                       ) -> np.ndarray:
    """7-dof action from consecutive (xyz+rpy+gripper) states
    (real_dataset_hdf5.py:456-487)."""
    if mode == "ee_rel_pose":
        xyz = state_t1[:3] - state_t[:3]
        rpy = state_t1[3:6] - state_t[3:6]
    elif mode == "ee_rel_pose_local":
        r_t = euler2rotm(state_t[3:6])
        r_t1 = euler2rotm(state_t1[3:6])
        xyz = r_t.T @ (state_t1[:3] - state_t[:3])
        rpy = rotm2euler(r_t.T @ r_t1)
        rpy = np.mod(rpy + np.pi, 2 * np.pi) - np.pi
    else:
        raise NotImplementedError(mode)
    a = np.zeros(7, np.float32)
    a[:3] = xyz * pos_scale
    a[3:6] = rpy * rot_scale
    a[6] = state_t1[6]
    return a


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


class RealDatasetHDF5:
    """Language-conditioned real-robot windows from one HDF5 file."""

    def __init__(self, data_dir: str, mode: str = "train", seq_len: int = 12,
                 action_mode: str = "ee_rel_pose_local",
                 enrich_lang_path: Optional[str] = None, text_aug: bool = False,
                 seed: int = 0):
        import h5py
        self.dir = os.path.join(data_dir, mode)
        self.seq_len = seq_len
        self.action_mode = action_mode
        self.text_aug = text_aug
        self._rng = np.random.RandomState(seed)
        self.enrich = {}
        if text_aug and enrich_lang_path and os.path.exists(enrich_lang_path):
            with open(enrich_lang_path) as f:
                self.enrich = json.load(f)
        with open(os.path.join(self.dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.h5 = h5py.File(os.path.join(self.dir, "data.hdf5"), "r")
        self._build_index()

    def _build_index(self):
        self.seq_tuple: List = []
        n_trajs = self.meta["num_trajectories"]
        for ti in range(n_trajs):
            text, n_frames, _name, st, ed = self.meta[str(ti)][:5]
            if ed - st < self.seq_len + 1:
                continue
            # last frame excluded: actions need state_{t+1} (:424-426)
            for s in range(0, n_frames - self.seq_len):
                self.seq_tuple.append((ti, text, s, s + self.seq_len, st))

    def __len__(self):
        return len(self.seq_tuple)

    def __getitem__(self, index: int) -> Dict:
        ti, text, st, ed, h5_st = self.seq_tuple[index]
        states = np.asarray(self.h5["state"][h5_st + st:h5_st + ed + 1],
                            np.float32)  # (+1 for the next-state action)
        actions = np.stack([
            relative_ee_action(states[i], states[i + 1], self.action_mode)
            for i in range(self.seq_len)])
        # gripper action channel must be the {-1 close, +1 open} convention
        # the BCE loss assumes ((g+1)/2 target) — NOT the raw next-frame
        # gripper position relative_ee_action copies in.  Derive binary
        # open/closed per frame: from the teleop command stream when the
        # export has one (movement-confirmed switching,
        # real_dataset_hdf5.py:144-200), else by thresholding the position
        # at its trajectory midrange.
        grip_pos = states[:, 6]
        if "gripper_command" in self.h5:
            cmd = np.asarray(
                self.h5["gripper_command"][h5_st + st:h5_st + ed + 1],
                np.float32)
            binary = binary_gripper_from_pos(grip_pos, cmd)
        else:
            lo, hi = float(grip_pos.min()), float(grip_pos.max())
            binary = ((grip_pos > 0.5 * (lo + hi)).astype(np.float32)
                      if hi - lo > 1e-6 else np.ones_like(grip_pos))
        actions[:, 6] = 2.0 * binary[1:] - 1.0
        static = np.asarray(self.h5["rgb"]["static"][h5_st + st:h5_st + ed])
        hand = np.asarray(self.h5["rgb"]["hand"][h5_st + st:h5_st + ed])
        if self.text_aug and text in self.enrich and self._rng.rand() > 0.1:
            cands = self.enrich[text]
            text = cands[self._rng.randint(len(cands))]
        robot_obs = states[:self.seq_len].copy()
        robot_obs[:, 6] = 2.0 * binary[:self.seq_len] - 1.0  # head embed_state
        return {
            "rgb_static": static.astype(np.uint8),
            "rgb_gripper": hand.astype(np.uint8),
            "actions": actions,
            "robot_obs": robot_obs,
            "lang": text,
            "timestep": np.arange(st, ed, dtype=np.int32),
        }

    def collate(self, samples: Sequence[Dict], text_fn: Callable) -> Dict:
        ids, mask = text_fn([s["lang"] for s in samples])
        return {
            "rgb_static": np.stack([s["rgb_static"] for s in samples]),
            "rgb_gripper": np.stack([s["rgb_gripper"] for s in samples]),
            "actions": np.stack([s["actions"] for s in samples]),
            "robot_obs": np.stack([s["robot_obs"] for s in samples]),
            "input_ids": ids, "attention_mask": mask,
            "robot_obs_multi": np.zeros(1, np.float32),
        }


def make_synthetic_real_hdf5(root: str, n_trajs: int = 2, n_frames: int = 20,
                             img_hw: int = 32, mode: str = "train",
                             seed: int = 0) -> str:
    """Synthetic dataset in the simplified schema for tests."""
    import h5py
    r = np.random.RandomState(seed)
    d = os.path.join(root, mode)
    os.makedirs(d, exist_ok=True)
    total = n_trajs * n_frames
    meta = {"num_trajectories": n_trajs}
    with h5py.File(os.path.join(d, "data.hdf5"), "w") as f:
        f.create_dataset("state", data=np.cumsum(
            r.randn(total + 1, 7).astype(np.float32) * 0.01, axis=0))
        g = f.create_group("rgb")
        g.create_dataset("static", data=r.randint(
            0, 256, (total, img_hw, img_hw, 3), np.uint8))
        g.create_dataset("hand", data=r.randint(
            0, 256, (total, img_hw, img_hw, 3), np.uint8))
    for ti in range(n_trajs):
        meta[str(ti)] = [f"pick up object {ti}", n_frames, f"video_{ti}",
                         ti * n_frames, (ti + 1) * n_frames]
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    return d
