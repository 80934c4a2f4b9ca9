"""Micro-batching serving core: concurrent robot streams share one batched
dynamic-exit step a dispatch (the JAX package's ``serving/batcher.py``).

``serving/server.DeerActionServer`` runs one B=1 step a request, which is
right for latency; this core multiplexes HTTP streams onto the lanes of
one ``ScanDeerPolicy`` batch.  Requests that arrive within a window are
collated into one ``step_batch``, and each lane keeps its own carry row,
threshold row (per-stream thresholds), token cache entry, stage-reuse
counter and, for the window-folded models ('vit_concat' / ``use_hist``),
its rolling W-frame window of preprocessed frames (the per-stream
adapter's img_queue, eval_utils.py:344-386) and state rows.  A lane
without a request in a dispatch is parked: it rides along on a zero frame
and a threshold row that exits at the first exit, so it never prolongs
the batch, and its carry row is restored after the dispatch
(``models/heads.select_carry``, by carry layout).

The HTTP protocol is DeerActionServer's (``make_server`` takes either
core); ``cli/serve --batch_lanes N [--batch_window_ms W]`` selects this
one.  State models send ``robot_obs`` with every request.  Heads: the
deterministic LSTM, and diffusion through ``BatchedDiffusionSampler``
(each lane's plan history and counter; clients get (k, 7) plans under
"action"); fc and gpt heads use the per-stream core.

Stage reuse (steps_per_stage > 1, reference value_net.py:284-286): a lane
recomputes its exit every steps_per_stage steps; mid-stage its previous
exit is forced through its threshold row, so lanes on different stage
phases share a dispatch.

Preprocessing runs on the request threads and the dispatch on the
batcher's own thread, each on the engine's device under
``inference_mode`` (``server.engine_mode``).  An engine or kernel error
reaches the waiting requests raw, so that the HTTP layer answers 500.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.data.preprocess import clip_preprocess
from deer_vla_tpu_torch.data.text import fixed_length
from deer_vla_tpu_torch.eval.rollout import state_row
from deer_vla_tpu_torch.eval.scan_policy import folded_window
from deer_vla_tpu_torch.models.heads import select_carry
from deer_vla_tpu_torch.serving.server import (ServeError, _decode_image,
                                               check_thresholds, engine_mode,
                                               request_robot_obs)


class _Pending:
    __slots__ = ("payload", "event", "result", "error")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        # a ServeError answers 400; anything else (an engine or kernel
        # failure) is re-raised raw and answers 500
        self.error: Optional[BaseException] = None


class BatchedActionServer:
    """The lane-multiplexed serving core around one ``ScanDeerPolicy`` (or
    a ``BatchedDiffusionSampler`` around one).

    policy:    its batched carry and (lanes, n_layers) threshold rows hold
               every stream's state.
    lanes:     the stream capacity, the batch of every dispatch.
    window_ms: after the first pending request, how long to wait for the
               other live streams before dispatching (0: at once)."""

    def __init__(self, policy, text_fn, lanes: int = 8,
                 window_ms: float = 5.0):
        from deer_vla_tpu_torch.eval.diffusion_policy import \
            BatchedDiffusionSampler
        cfg = policy.cfg
        self._diff = isinstance(policy, BatchedDiffusionSampler)
        if cfg.head_type != "deterministic" and not self._diff:
            raise ServeError("batched serving covers the deterministic LSTM "
                             "head and diffusion heads (through "
                             "BatchedDiffusionSampler); fc / gpt heads use "
                             "the per-stream core")
        self._policy = policy
        # carry surgery targets the inner ScanDeerPolicy: a setattr on the
        # wrapper would shadow its delegation
        self._engine = policy.policy if self._diff else policy
        self.device = self._engine.device
        self._text_fn = text_fn
        self.cfg = cfg
        self.lanes = lanes
        self.window_s = window_ms / 1000.0
        self._size = cfg.vit.image_size
        self._grip_size = cfg.gripper_res or self._size

        # lane state, guarded by _cond's lock
        self._lane_of: Dict[str, int] = {}
        self._free: List[int] = list(range(lanes))
        th = self._engine.thresholds.cpu().numpy().astype(np.float32)
        self._default_row = (th if th.ndim == 1 else th[0]).copy()
        self._rows = np.tile(self._default_row, (lanes, 1))
        self._sps = int(getattr(self._engine, "steps_per_stage", 1) or 1)
        self._lane_step = np.zeros(lanes, np.int64)
        self._lane_last_exit = np.full(lanes, -1, np.int64)
        exits = self._engine.exits
        self._park_row = self._engine.threshold_row(
            {e: (1e30 if e == exits[0] else -1e30) for e in exits})
        w = folded_window(cfg)
        self._folded_w = w if w > 1 else 0
        self._tile_text = cfg.use_hist
        self._use_state = cfg.use_state or cfg.head.use_state
        self._win_rgb: List[list] = [[] for _ in range(lanes)]
        self._win_grip: List[list] = [[] for _ in range(lanes)]
        self._win_state: List[list] = [[] for _ in range(lanes)]
        # the batched carry exists from the start, so that the first
        # dispatch has parked rows to restore (text rows are a frame each
        # under use_hist; _ensure_carry divides back to lanes)
        self._engine._ensure_carry(lanes * (w if cfg.use_hist else 1))
        self._tok_cache: Dict[str, tuple] = {}
        self._tok_cache_cap = 512  # oldest out
        self._pending: Dict[int, _Pending] = {}  # lane -> request
        self._cond = threading.Condition()
        self._stop = False
        # true from taking a batch to restoring the parked carries; reset,
        # close and a new stream's first step wait it out so that the
        # write-back cannot undo their change
        self._dispatching = False
        self.total_steps = 0
        self.dispatches = 0
        # batched exit waste: every lane runs to the batch's deepest exit,
        # so each live lane wastes (batch max - own exit) layers
        self._waste_layers = 0.0
        self._waste_steps = 0
        self.started = time.time()
        self._zero_prep = self._prep(np.zeros((self._size, self._size, 3),
                                              np.uint8), self._size)
        self._zero_prep_grip = self._prep(
            np.zeros((self._grip_size, self._grip_size, 3), np.uint8),
            self._grip_size)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _prep(self, frame: np.ndarray, size: int) -> torch.Tensor:
        """uint8 (H, W, 3) -> (3, size, size) on the engine's device."""
        with engine_mode(self.device):
            u8 = torch.as_tensor(frame, device=self.device)
            return clip_preprocess(u8[None], size)[0]

    # -- stream management (the caller holds the lock) ----------------------

    def _lane(self, name: str) -> int:
        if not isinstance(name, str) or not name:
            raise ServeError("'stream' must be a non-empty string")
        lane = self._lane_of.get(name)
        if lane is None:
            if not self._free:
                raise ServeError(
                    f"stream limit {self.lanes} reached; close one")
            lane = self._free.pop(0)
            self._lane_of[name] = lane
            self._reset_lane(lane)
            # a freed lane may hold the previous stream's thresholds; a new
            # stream starts from the server's, as a fresh per-stream view
            self._rows[lane] = self._default_row
        return lane

    def _wait_not_dispatching(self):
        while self._dispatching and not self._stop:
            self._cond.wait()

    def _reset_lane(self, lane: int):
        with engine_mode(self.device):
            self._policy.reset_streams(np.arange(self.lanes) == lane)
        self._win_rgb[lane] = []
        self._win_grip[lane] = []
        self._win_state[lane] = []
        self._lane_step[lane] = 0
        self._lane_last_exit[lane] = -1

    # -- endpoints (DeerActionServer's) -------------------------------------

    def healthz(self) -> dict:
        with self._cond:
            streams = sorted(self._lane_of)
            steps = self.total_steps
            dispatches = self.dispatches
            waste = (self._waste_layers / self._waste_steps
                     if self._waste_steps else 0.0)
        return {
            "ok": True,
            "mode": "batched",
            "avg_wasted_layers_per_step": waste,
            "dispatches": dispatches,
            "steps_per_stage": self._sps,
            "lanes": self.lanes,
            "exits": [int(e) for e in self._engine.exits],
            "n_layers": self.cfg.n_layers,
            "head_type": self.cfg.head_type,
            "quantize": getattr(self._engine, "quantize", None),
            "streams": streams,
            "steps": steps,
            "uptime_s": time.time() - self.started,
        }

    def reset(self, payload: dict) -> dict:
        with self._cond:
            self._wait_not_dispatching()
            lane = self._lane(payload.get("stream", ""))
            if lane in self._pending:
                raise ServeError("stream busy (a step is in flight)")
            self._reset_lane(lane)
            th = payload.get("thresholds")
            if th is not None:
                self._rows[lane] = self._engine.threshold_row(
                    check_thresholds(th, self._engine.exits))
        return {"ok": True}

    def close(self, payload: dict) -> dict:
        with self._cond:
            self._wait_not_dispatching()
            lane = self._lane_of.pop(payload.get("stream", ""), None)
            if lane is not None:
                if lane in self._pending:
                    self._lane_of[payload["stream"]] = lane
                    raise ServeError("stream busy (a step is in flight)")
                self._free.append(lane)
        return {"ok": True, "existed": lane is not None}

    def step(self, payload: dict) -> dict:
        instruction = payload.get("instruction")
        if not isinstance(instruction, str) or not instruction.strip():
            raise ServeError("'instruction' must be a non-empty string")
        rgb = _decode_image(payload, "rgb")
        grip = _decode_image(payload, "gripper")
        st = None
        if self._use_state:
            st = state_row({"robot_obs": request_robot_obs(
                payload, self.cfg, required=True)}, self.cfg)
        # preprocess on the request thread (clients send any H x W; the
        # batch needs uniform frames), as the per-stream core does
        req = _Pending((instruction, self._prep(rgb, self._size),
                        self._prep(grip, self._grip_size), st))
        with self._cond:
            if self._stop:
                # the loop's final drain has run or will run before any
                # dispatch: a request queued now would wait forever
                raise ServeError("server shutting down")
            if self._lane_of.get(payload.get("stream", "")) is None:
                # a NEW stream: allocating its lane zeroes the lane's carry
                # row, which an in-flight dispatch's write-back (against
                # the carry from before the reset) would undo
                self._wait_not_dispatching()
                if self._stop:
                    raise ServeError("server shutting down")
            lane = self._lane(payload.get("stream", ""))
            if lane in self._pending:
                raise ServeError("stream busy (one step in flight per "
                                 "stream)")
            self._pending[lane] = req
            self._cond.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5)

    # -- the batcher loop ---------------------------------------------------

    def _tokens(self, instruction: str):
        t = self._tok_cache.get(instruction)
        if t is None:
            ids, mask = self._text_fn([instruction])
            pad = getattr(self._text_fn, "pad_token_id", 0)
            ids, mask = fixed_length(ids, mask, self.cfg.text_len, pad)
            t = (np.asarray(ids[0]), np.asarray(mask[0]))
            while len(self._tok_cache) >= self._tok_cache_cap:
                self._tok_cache.pop(next(iter(self._tok_cache)))
            self._tok_cache[instruction] = t
        return t

    def _take_batch(self):
        """Waits for requests, then up to the window for the other live
        streams; returns (batch, threshold rows), or None to stop."""
        with self._cond:
            while not self._pending and not self._stop:
                self._cond.wait()
            if self._stop:
                for req in self._pending.values():
                    req.error = ServeError("server shutting down")
                    req.event.set()
                return None
            deadline = time.time() + self.window_s
            while len(self._pending) < len(self._lane_of) and not self._stop:
                left = deadline - time.time()
                if left <= 0:
                    break
                self._cond.wait(timeout=left)
            batch = dict(self._pending)
            self._pending.clear()
            rows = self._rows.copy()
            if self._sps > 1:
                for lane in batch:
                    if (self._lane_step[lane] % self._sps != 0
                            and self._lane_last_exit[lane] >= 0):
                        rows[lane] = -1e30
                        rows[lane, self._lane_last_exit[lane]] = 1e30
            self._dispatching = True
        return batch, rows

    def _window_rows(self, lane: int, req) -> tuple:
        """The lane's image, gripper and state rows for this dispatch: the
        request's frame, or its rolling W-frame window (left-padded with
        the lane's first frame) for the window-folded models."""
        _, rgb_p, grip_p, st = req.payload
        rep = self._folded_w
        if not rep:
            return [rgb_p], [grip_p], [st]
        if not self._win_rgb[lane]:
            self._win_rgb[lane] = [rgb_p] * rep
            self._win_grip[lane] = [grip_p] * rep
            self._win_state[lane] = [st] * rep
        else:
            self._win_rgb[lane] = (self._win_rgb[lane] + [rgb_p])[-rep:]
            self._win_grip[lane] = (self._win_grip[lane] + [grip_p])[-rep:]
            self._win_state[lane] = (self._win_state[lane] + [st])[-rep:]
        return self._win_rgb[lane], self._win_grip[lane], self._win_state[lane]

    def _snapshot(self) -> tuple:
        """What a dispatch advances: the carry, the rolling windows (each
        lane's list is replaced, never changed in place) and the diffusion
        wrapper's histories and plan counters."""
        snap = (self._engine.carry, list(self._win_rgb),
                list(self._win_grip), list(self._win_state))
        if self._diff:
            snap += (self._policy._hist, self._policy._counts)
        return snap

    def _restore(self, snap: tuple) -> None:
        (self._engine.carry, self._win_rgb, self._win_grip,
         self._win_state) = snap[:4]
        if self._diff:
            self._policy._hist, self._policy._counts = snap[4:]

    def _dispatch(self, batch: dict, rows: np.ndarray) -> None:
        """One batched step over every lane; results to the live lanes'
        requests, the parked lanes' carry rows restored."""
        t0 = time.perf_counter()
        rep = self._folded_w or 1  # frame rows a lane
        trep = rep if self._tile_text else 1  # text rows a lane
        s = self.cfg.text_len
        imgs, grips, states = [], [], []
        ids = np.zeros((self.lanes * trep, s), np.int64)
        masks = np.zeros((self.lanes * trep, s), np.int64)
        zero_state = (np.zeros(self.cfg.state_dim, np.float32)
                      if self._use_state else None)
        snapshot = self._snapshot()
        for lane in range(self.lanes):
            req = batch.get(lane)
            if req is None:  # parked: zero rows, its window untouched
                imgs += [self._zero_prep] * rep
                grips += [self._zero_prep_grip] * rep
                states += [zero_state] * rep
                continue
            r_img, r_grip, r_st = self._window_rows(lane, req)
            imgs += r_img
            grips += r_grip
            states += r_st
            i, m = self._tokens(req.payload[0])
            ids[lane * trep:(lane + 1) * trep] = i
            masks[lane * trep:(lane + 1) * trep] = m
        in_batch = np.zeros(self.lanes, bool)
        in_batch[list(batch)] = True
        rows[~in_batch] = self._park_row
        img = torch.stack(imgs)[:, None, None]
        grip = torch.stack(grips)[:, None, None]
        state = (np.stack(states)[:, None, None, :] if self._use_state
                 else None)
        self._engine.set_threshold_array(rows)
        old_carry = self._engine.carry
        try:
            if self._diff:  # the wrapper keeps parked lanes' histories
                acts, exits = self._policy.step_batch(
                    img, grip, ids, masks, state, active=in_batch)
            else:
                acts, exits = self._policy.step_batch(img, grip, ids, masks,
                                                      state)
        except BaseException:
            # the step failed (a device fault shows at finish_batch's wait,
            # after the carry was committed): no lane keeps a step its
            # client never received
            self._restore(snapshot)
            raise
        # parked lanes rode along on zero frames: their carry rows go back
        self._engine.carry = select_carry(
            self.cfg, torch.as_tensor(in_batch, device=self.device),
            self._engine.carry, old_carry)
        dt = 1000 * (time.perf_counter() - t0)
        ex = np.asarray(exits, np.int64)
        # parked lanes exit at the first exit, so the batch's depth is the
        # live lanes' deepest exit
        batch_max = int(ex[sorted(batch)].max())
        for lane, req in batch.items():
            req.result = {"action": np.asarray(acts[lane]).tolist(),
                          "exit_layer": int(ex[lane]),
                          "batch_max_exit": batch_max,
                          "step_ms": dt,
                          "batched_with": len(batch)}
            req.event.set()

    def _loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            batch, rows = taken
            # built and run outside the lock, so that enqueues for the next
            # window go on; guarded so that no request can end the thread
            try:
                with engine_mode(self.device):
                    self._dispatch(batch, rows)
            except Exception as e:
                # raw, not a ServeError: a device failure is no client error
                for req in batch.values():
                    req.error = e
                    req.event.set()
            finally:
                with self._cond:
                    done = [(lane, r) for lane, r in batch.items()
                            if r.result is not None]
                    self.total_steps += len(done)
                    self.dispatches += 1
                    for lane, r in done:
                        self._waste_layers += (r.result["batch_max_exit"]
                                               - r.result["exit_layer"])
                        self._lane_last_exit[lane] = r.result["exit_layer"]
                        self._lane_step[lane] += 1
                    self._waste_steps += len(done)
                    self._dispatching = False
                    self._cond.notify_all()
