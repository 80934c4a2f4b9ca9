"""CALVIN disk dataset and loader on the host, numpy only (a copy of the
JAX package's ``data/calvin.py``; the reference's robot_flamingo/data/
data.py, BaseCalvinDataset :197-585, DiskCalvinDataset :600-814):
  * the index from lang_annotations/auto_lang_ann.npy episode spans, one
    sample per start frame with a skip_frames stride (:688-744)
  * a window of ``window_size + act_step - 1`` consecutive
    episode_{idx:07d}.npz frames (:660-685), read by the native reader
    (``data/native_loader``) or, where it cannot serve, ``np.load``; each
    window counts toward the reader that served it
  * tail padding: repeat the last frame; for relative actions zero the arm
    dims and repeat the gripper dim (:494-516)
  * ``dif_ws`` training windows drawn in [min, max] and padded to max;
    validation window sizes fixed by an md5 of the index (:111-126)
  * text enrichment from enrich_lang_annotations.json (:681-684) and the
    partial-data filter from partial_task_data.json (:725-729)
  * the multi-step action restack for act_step > 1 (:796-812)

Batches carry raw uint8 frames: resize, normalization and augmentation run
on the frames' device (``data/preprocess.py``), not in the workers.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import queue as queue_mod
from dataclasses import dataclass
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence)

import numpy as np


def stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "little")


def get_validation_window_size(idx: int, min_ws: int, max_ws: int) -> int:
    """Epoch-stable validation window size (data.py:111-126)."""
    return min_ws + stable_hash(str(idx)) % (max_ws - min_ws + 1)


@dataclass
class CalvinDataConfig:
    dataset_dir: str = ""
    window_size: int = 12
    act_step: int = 1            # multi_step_action
    skip_frames: int = 1
    pad: bool = True
    text_aug: bool = False
    partial_data: bool = False
    data_percent: float = 1.0
    lang_folder: str = "lang_annotations"
    relative_actions: bool = True  # CALVIN rel_actions space
    enrich_lang_path: Optional[str] = None
    partial_task_path: Optional[str] = None
    seed: int = 42
    # variable-window training (data.py:250-255 dif_ws): train windows
    # sampled uniformly in [min, max]; validation windows hash-determinized
    # per index; samples padded to max_window_size
    dif_ws: bool = False
    var_min_window: int = 12
    var_max_window: int = 24

    @property
    def min_window_size(self) -> int:
        if self.dif_ws:
            return self.var_min_window
        return self.window_size + self.act_step - 1

    @property
    def max_window_size(self) -> int:
        if self.dif_ws:
            return self.var_max_window
        return self.window_size + self.act_step - 1


class DiskCalvinDataset:
    """Indexable dataset of CALVIN language windows; returns numpy dicts."""

    RGB_KEYS = ("rgb_static", "rgb_gripper")

    def __init__(self, cfg: CalvinDataConfig, validation: Optional[bool] = None):
        self.cfg = cfg
        d = Path(cfg.dataset_dir)
        assert d.is_dir(), f"dataset dir {d} not found"
        self.dir = d
        self.validation = (("validation" in str(d)) if validation is None
                           else validation)
        self._rng = np.random.RandomState(cfg.seed)
        self._build_index()
        self._detect_naming()
        self.enrich_lang = {}
        if cfg.text_aug and cfg.enrich_lang_path and os.path.exists(cfg.enrich_lang_path):
            with open(cfg.enrich_lang_path) as f:
                self.enrich_lang = json.load(f)

    # -- index ---------------------------------------------------------------

    def _build_index(self):
        ann_path = self.dir / self.cfg.lang_folder / "auto_lang_ann.npy"
        if not ann_path.exists():
            ann_path = self.dir / "auto_lang_ann.npy"
        lang_data = np.load(ann_path, allow_pickle=True).item()
        ep_spans = lang_data["info"]["indx"]
        self.lang_ann = lang_data["language"]["ann"]
        self.lang_task = lang_data["language"]["task"]

        partial = None
        if self.cfg.partial_data and self.cfg.partial_task_path:
            with open(self.cfg.partial_task_path) as f:
                partial = {tuple(x) for x in json.load(f)}

        episode_lookup: List[int] = []
        lang_lookup: List[int] = []
        min_ws = self.cfg.min_window_size
        for i, (start_idx, end_idx) in enumerate(ep_spans):
            if partial is not None and (start_idx, end_idx) not in partial:
                continue
            assert end_idx >= self.cfg.max_window_size
            for cnt, idx in enumerate(range(start_idx, end_idx + 1 - min_ws)):
                if cnt % self.cfg.skip_frames == 0:
                    lang_lookup.append(i)
                    episode_lookup.append(idx)
        self.episode_lookup = np.asarray(episode_lookup)
        self.lang_lookup = lang_lookup

    def _detect_naming(self):
        # lookup_naming_pattern equivalent: find one episode_*.npz file
        files = sorted(self.dir.glob("episode_*.npz"))
        assert files, f"no episode_*.npz under {self.dir}"
        stem = files[0].stem  # episode_0000000
        digits = stem.split("_")[-1]
        self.n_digits = len(digits)

    def _episode_path(self, file_idx: int) -> Path:
        return self.dir / f"episode_{file_idx:0{self.n_digits}d}.npz"

    def __len__(self) -> int:
        return int(len(self.episode_lookup) * self.cfg.data_percent)

    # -- sample --------------------------------------------------------------

    def _window_size(self, idx: int) -> int:
        """Window size for sample ``idx`` (data.py:406-441 _get_window_size):
        clamp the max so the window never crosses an episode boundary (the
        index only guarantees min_window_size frames remain), then draw
        uniformly (train) or hash-deterministically (validation)."""
        min_ws, max_ws = self.cfg.min_window_size, self.cfg.max_window_size
        if min_ws == max_ws:
            return max_ws
        window_diff = max_ws - min_ws
        if len(self.episode_lookup) <= idx + window_diff:
            # last indexed windows: only the remaining entries are in-episode
            max_window = min_ws + len(self.episode_lookup) - idx - 1
        elif (self.episode_lookup[idx + window_diff]
              != self.episode_lookup[idx] + window_diff):
            # fewer than window_diff consecutive frames until the next
            # episode starts
            steps_to_next = int(np.nonzero(
                self.episode_lookup[idx:idx + window_diff + 1]
                - (self.episode_lookup[idx]
                   + np.arange(window_diff + 1)))[0][0])
            max_window = min(max_ws, min_ws + steps_to_next - 1)
        else:
            max_window = max_ws
        if self.validation:
            return get_validation_window_size(idx, min_ws, max_window)
        return int(self._rng.randint(min_ws, max_window + 1))

    EPISODE_KEYS = ("rgb_static", "rgb_gripper", "rel_actions", "robot_obs")

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ws = self._window_size(idx)
        start = int(self.episode_lookup[idx])
        paths = [str(self._episode_path(i)) for i in range(start, start + ws)]
        ep = self._load_window(paths)
        sample = {
            "rgb_static": ep["rgb_static"].astype(np.uint8),     # (ws, H, W, 3)
            "rgb_gripper": ep["rgb_gripper"].astype(np.uint8),
            "actions": ep["rel_actions"].astype(np.float32),     # (ws, 7)
            "robot_obs": ep["robot_obs"].astype(np.float32),     # (ws, 15)
        }
        sample = self._pad_sample(sample, self.cfg.max_window_size - ws)
        text = self.lang_ann[self.lang_lookup[idx]]
        if self.enrich_lang:
            task = self.lang_task[self.lang_lookup[idx]]
            cands = self.enrich_lang.get(task, []) + [text]
            text = cands[self._rng.randint(len(cands))]
        sample["lang"] = text
        sample["idx"] = idx
        return sample

    def _load_window(self, paths: List[str]) -> Dict[str, np.ndarray]:
        """The window's frames, key by key: the native reader's mmap path
        (one map and zip-directory parse a frame for all four keys), else
        ``np.load``."""
        from deer_vla_tpu_torch.data import native_loader
        if native_loader.available():
            out = native_loader.read_window_keys(paths, self.EPISODE_KEYS)
            if out is not None:
                native_loader.count_window(True)
                return out
        native_loader.count_window(False)
        frames = [np.load(p) for p in paths]
        return {k: np.stack([f[k] for f in frames]) for k in self.EPISODE_KEYS}

    def _pad_sample(self, s: Dict[str, np.ndarray], pad: int) -> Dict[str, np.ndarray]:
        if pad <= 0 or not self.cfg.pad:
            return s

        def rep(x):
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], 0)

        s["rgb_static"] = rep(s["rgb_static"])
        s["rgb_gripper"] = rep(s["rgb_gripper"])
        s["robot_obs"] = rep(s["robot_obs"])
        a = s["actions"]
        if self.cfg.relative_actions:
            # zero-pad arm dims, repeat gripper dim (data.py:500-509)
            zeros = np.zeros((pad, a.shape[-1] - 1), a.dtype)
            arm = np.concatenate([a[:, :-1], zeros], 0)
            grip = np.concatenate([a[:, -1:], np.repeat(a[-1:, -1:], pad, 0)], 0)
            s["actions"] = np.concatenate([arm, grip], -1)
        else:
            s["actions"] = rep(a)
        return s

    # -- collation -----------------------------------------------------------

    def collate(self, samples: Sequence[Dict[str, Any]],
                text_fn: Callable) -> Dict[str, np.ndarray]:
        """Assemble a raw batch (uint8 frames; device does the rest).

        Multi-step action restack for act_step>1 (data.py:796-812): actions
        become (B, window, act_step, 7) and frames are trimmed to window.
        """
        w, k = self.cfg.window_size, self.cfg.act_step
        stat = np.stack([s["rgb_static"] for s in samples])    # (B, ws, H, W, 3)
        grip = np.stack([s["rgb_gripper"] for s in samples])
        acts = np.stack([s["actions"] for s in samples])       # (B, ws, 7)
        robs = np.stack([s["robot_obs"] for s in samples])
        ids, mask = text_fn([s["lang"] for s in samples])
        if k != 1:
            stacked = np.stack([acts[:, i:i + k] for i in range(w)], axis=1)  # (B, w, k, 7)
            racked = np.stack([robs[:, i:i + k] for i in range(w)], axis=1)
            racked = np.concatenate([racked[..., :6], racked[..., -1:]], -1)
            acts = stacked
            stat, grip, robs = stat[:, :w], grip[:, :w], robs[:, :w]
            robot_obs = racked
        else:
            robot_obs = np.zeros(1, np.float32)
        return {
            "rgb_static": stat, "rgb_gripper": grip,
            "actions": acts, "robot_obs": robs,
            "input_ids": ids, "attention_mask": mask,
            "robot_obs_multi": robot_obs,
        }


# ---------------------------------------------------------------------------
# loader: sharded, shuffled, prefetching (DistributedSampler+DataLoader equiv)
# ---------------------------------------------------------------------------


class CalvinLoader:
    """Per-process shard of the dataset with background prefetch.

    Equivalent of DistributedSampler + DataLoader(persistent prefetch)
    (data.py:1064-1130): drop_last sharding so every process sees the same
    number of batches; set_epoch reshuffles deterministically.
    """

    def __init__(self, dataset: DiskCalvinDataset, text_fn: Callable,
                 batch_size: int, *, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 42, prefetch: int = 3,
                 workers: int = 4):
        self.ds = dataset
        self.text_fn = text_fn
        self.batch_size = batch_size
        self.rank, self.world = rank, world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.workers = workers
        n = len(dataset) // world_size
        self.num_batches = n // batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n_total = len(self.ds)
        order = np.arange(n_total)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        per = n_total // self.world
        return order[self.rank * per:(self.rank + 1) * per]

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()  # set when the consumer stops early

        def _put(item) -> bool:
            # bounded put that aborts on consumer cancellation — otherwise an
            # early `break` out of the iterator (calibration, max_batches
            # caps) would leave this thread + its executor blocked forever
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self.workers) as ex:
                    for b in range(self.num_batches):
                        if cancel.is_set():
                            break
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        samples = list(ex.map(self.ds.__getitem__, idxs))
                        if not _put(self.ds.collate(samples, self.text_fn)):
                            break
            finally:
                _put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            cancel.set()
            # drain so a producer blocked mid-put can observe the event
            try:
                while True:
                    q.get_nowait()
            except queue_mod.Empty:
                pass
