"""The ``rollout`` traffic kind: batched closed-loop evaluation, the path of
``cli/eval --lanes`` (``eval/batched_rollout.evaluate_policy_batched`` over
``ScanDeerPolicy.step_batch``), driven by one thread.

The environment is the benchmark's own: each lane serves CALVIN-sized
frames (200 px static, 84 px gripper) from a pool drawn at set-up, the
frame a function of the lane and its step count; the success oracle ends
a subtask after a length drawn from the seed, so no outcome depends on
the actions and a window's work does not move with rounding.  Every chain
takes the mix's ``subtask_steps`` in its own seeded order, so every seed
runs the same work and every lane of a call ends its chain together.

Set-up: the weights (``weights.draw_params``), thresholds calibrated with
the program's ``eval/calibrate.calibrate`` on seeded demonstration
windows, the engine, and a warm-up of the window's own shapes.  The
window starts with a rollout call after the warm-up and closes at the
first lockstep step after ``seconds``: that step is not dispatched, and
the window's time ends with the last step whose env steps were taken.
Afterwards the output check (``check_outputs``) follows a subtask of each
tracked lane, the longest among them, with the plain reference.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import reference as ref
from flops import served_step_flops
from weights import draw_params


# ---------------------------------------------------------------------------
# inputs made from the seed
# ---------------------------------------------------------------------------


class Inputs:
    """Everything the rollout serves, from ``seed``: the frame pool,
    the instructions' token ids, and the chains' subtask orders."""

    def __init__(self, traffic: dict, c: dict, seed: int):
        self.t = traffic
        self.c = c
        self.seed = seed
        rng = np.random.default_rng([seed, 1])
        n, blob = traffic["frame_pool"], traffic["frame_blob"]

        def pool(hw):
            lo = rng.integers(0, 256, (n, math.ceil(hw / blob),
                                       math.ceil(hw / blob), 3), np.uint8)
            big = lo.repeat(blob, 1).repeat(blob, 2)[:, :hw, :hw]
            noise = rng.integers(0, 24, big.shape, np.uint8)
            return np.ascontiguousarray(np.clip(big.astype(np.int16) + noise
                                                - 12, 0, 255).astype(np.uint8))

        self.static = pool(traffic["static_hw"])
        self.gripper = pool(traffic["gripper_hw"])
        d = c["deer"]
        vocab = d["mpt"]["vocab_size"]
        self.media_id = d["media_token_id"]
        self.eoc_id = d["eoc_token_id"]
        self.pad_id = vocab - 1
        self.text_len = d["text_len"]
        words = list(traffic["instruction_words"])
        words = [words[i % len(words)] for i in range(traffic["tasks"])]
        rng.shuffle(words)
        self.instructions = {}
        for task, nw in enumerate(words):
            ids = [self.media_id] + list(rng.integers(
                1, self.media_id - 1, nw)) + [self.eoc_id, 0]
            self.instructions[f"task{task:02d}"] = ids[:self.text_len]
        self.lane_offset = rng.integers(0, n, traffic["lanes"])

    def frame(self, lane: int, t: int) -> int:
        return int((self.lane_offset[lane] + 7 * t) % len(self.static))

    def call(self, index: int):
        """Call ``index``'s chains: (sequences, annotations, lengths), each
        chain's subtasks the mix's lengths in a seeded order, on seeded
        tasks; a subtask is named by its call, chain, place and task."""
        t = self.t
        rng = np.random.default_rng([self.seed, 2, index])
        steps = list(t["subtask_steps"])
        if len(steps) != t["subtasks_per_chain"]:
            raise ValueError("subtask_steps must give one length a subtask")
        sequences, lengths, annotations = [], {}, {}
        for chain in range(t["chains_per_call"]):
            order = rng.permutation(len(steps))
            tasks = rng.choice(t["tasks"], len(steps), replace=False)
            names = []
            for j, (k, task) in enumerate(zip(order, tasks)):
                name = f"c{index}.{chain}.{j}.task{task:02d}"
                lengths[name] = steps[k]
                annotations[name] = f"task{task:02d}"
                names.append(name)
            sequences.append(({}, names))
        return sequences, annotations, lengths

    def padded(self, task: str):
        """(ids, mask) of one instruction at the text length, as the
        rollout pads it (``data/text.fixed_length``)."""
        ids = np.full(self.text_len, self.pad_id, np.int64)
        mask = np.zeros(self.text_len, np.int64)
        r = self.instructions[task]
        ids[:len(r)] = r
        mask[:len(r)] = 1
        return ids, mask

    def calibration(self, n_exit_ids: List[int]):
        """Seeded demonstration windows in the CALVIN loader's format and
        the draws of the training forward (sampling-1 and -2 exit layers):
        [(batch, draws)]."""
        cal = self.t["calibration"]
        d = self.c["deer"]
        w = d["window_size"]
        b = cal["batch_size"]
        rng = np.random.default_rng([self.seed, 3])
        out = []
        tasks = sorted(self.instructions)
        for _ in range(cal["batches"]):
            fi = rng.integers(0, len(self.static), (b, w))
            rows = [self.padded(tasks[i]) for i in
                    rng.integers(0, len(tasks), b)]
            batch = {"rgb_static": self.static[fi],
                     "rgb_gripper": self.gripper[fi],
                     "input_ids": np.stack([r[0] for r in rows]),
                     "attention_mask": np.stack([r[1] for r in rows])}
            ex = np.asarray(n_exit_ids)
            draws = {"rand_layer_ids": torch.as_tensor(
                         ex[rng.integers(0, len(ex), (b, w))]),
                     "switch_layer_ids": torch.as_tensor(
                         ex[rng.integers(0, len(ex), (b, w))])}
            out.append((batch, draws))
        return out

    @staticmethod
    def subtask_task(name: str) -> str:
        """The task (and so the instruction) of a subtask's name."""
        return name.rsplit(".", 1)[1]


# ---------------------------------------------------------------------------
# the environment, the oracle and the engine as the rollout sees them
# ---------------------------------------------------------------------------


class WindowClosed(Exception):
    """Raised in place of the first step dispatched after the window's
    close."""


class Log:
    """What the window served: per lockstep step its host time and the
    exits it returned; per (lane, subtask) of the tracked lanes the
    frames, the program's exits and actions, and the step's index into
    ``carries``: the tracked lanes' carry before and after each step,
    copied to the host without a wait (read once the window has
    closed)."""

    def __init__(self, tracer, track=()):
        self.tracer = tracer
        self.track = list(track)
        self.carries: List[tuple] = []
        self.exits: Optional[np.ndarray] = None
        self.pending: Dict[int, tuple] = {}
        self.subtasks: Dict[tuple, dict] = {}
        self.lengths: Dict[str, int] = {}
        self.step_s: List[float] = []
        self.dispatch_exits: List[np.ndarray] = []
        self.recording = False
        self.deadline: Optional[float] = None
        self.last_env_t = 0.0
        self.bad_actions = 0

    def carry(self, step: int, j: int) -> tuple:
        """(before, after) of tracked lane ``j`` at logged step ``step``,
        (2, layers, hidden) arrays."""
        return tuple(np.asarray(x[:, :, j]) for x in self.carries[step])

    def clear_steps(self) -> None:
        self.step_s.clear()
        self.dispatch_exits.clear()


class Tokenizer:
    """The rollout's tokenizer: an instruction's seeded ids, right padded
    to the longest, with the pad id ``evaluate_policy_batched`` pads to the
    text length with (``pad_token_id``)."""

    def __init__(self, inp: Inputs):
        self.inp = inp
        self.pad_token_id = inp.pad_id

    def __call__(self, texts):
        rows = [self.inp.instructions[x] for x in texts]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask


class Lane:
    """One lane's environment, the protocol ``evaluate_policy_batched``
    drives: the frame at its step count; the action it was sent."""

    def __init__(self, lane: int, inputs: Inputs, log: Log):
        self.lane, self.inp, self.log = lane, inputs, log
        self.t = 0
        self.steps = 0

    def reset(self, robot_obs=None, scene_obs=None):
        return self.get_obs()

    def get_obs(self):
        with self.log.tracer.span("rollout.env.get_obs"):
            f = self.inp.frame(self.lane, self.t)
            return {"rgb_obs": {"rgb_static": self.inp.static[f],
                                "rgb_gripper": self.inp.gripper[f]},
                    "robot_obs": np.zeros(15, np.float32)}

    def step(self, action):
        with self.log.tracer.span("rollout.env.step"):
            action = np.asarray(action, np.float32)
            log = self.log
            if not np.all(np.isfinite(action)):
                log.bad_actions += 1
            if log.recording and self.lane in log.track:
                log.pending[self.lane] = (
                    self.inp.frame(self.lane, self.t),
                    int(log.exits[self.lane]), action,
                    len(log.carries) - 1)
            self.t += 1
            self.steps += 1
            log.last_env_t = time.perf_counter()
            return None, 0.0, False, self.get_info()

    def get_info(self):
        return {"t": self.t, "lane": self.lane}


FIELDS = ("frames", "exits", "actions", "step")


class Oracle:
    """A subtask succeeds once its drawn length of steps has passed.  It
    is asked about each step just taken, so it also files that step under
    the lane's subtask in the log."""

    def __init__(self, log: Log, lengths: Dict[str, int]):
        self.log = log
        self.lengths = lengths

    def get_task_info_for_set(self, start_info, info, subtasks):
        with self.log.tracer.span("rollout.oracle"):
            (name,) = subtasks
            step = self.log.pending.pop(info["lane"], None)
            if step is not None:
                rec = self.log.subtasks.setdefault(
                    (info["lane"], name), {k: [] for k in FIELDS})
                for k, v in zip(FIELDS, step):
                    rec[k].append(v)
            return (set(subtasks)
                    if info["t"] - start_info["t"] >= self.lengths[name]
                    else set())


class Engine:
    """The engine as the rollout sees it, with the benchmark's spans and
    clock around each call into it; every other attribute is the
    engine's.  ``before_step(i)`` runs before window step i."""

    def __init__(self, policy, log: Log, before_step=None):
        self._policy = policy
        self._log = log
        self._before = before_step
        self._idx = None

    def __getattr__(self, name):
        return getattr(self._policy, name)

    def step_batch(self, *args, **kw):
        log = self._log
        if (log.recording and log.deadline is not None
                and time.perf_counter() >= log.deadline):
            raise WindowClosed
        if self._before is not None:
            self._before(len(log.step_s))
        carry_in = self._carry() if log.recording and log.track else None
        with log.tracer.span("engine.step_batch"):
            t0 = time.perf_counter()
            actions, exits = self._policy.step_batch(*args, **kw)
            log.step_s.append(time.perf_counter() - t0)
        if carry_in is not None:
            log.carries.append((carry_in, self._carry()))
        log.exits = exits
        self._log.dispatch_exits.append(np.asarray(exits))
        return actions, exits

    def reset_streams(self, mask):
        with self._log.tracer.span("engine.reset_streams"):
            return self._policy.reset_streams(mask)

    def _carry(self):
        """The engine's LSTM carry (h, c) of the tracked lanes, (2, layers,
        lanes, hidden), on its way to the host without a wait (a copy into
        pinned memory on the card); zeros before its first step."""
        carry = self._policy.carry
        if carry is None:
            h = self._policy.cfg.head
            return np.zeros((2, h.lstm_num_layers, len(self._log.track),
                             h.hidden_size), np.float32)
        if self._idx is None:
            self._idx = torch.as_tensor(self._log.track,
                                        device=carry[0].device)
        return torch.stack([carry[0][:, self._idx], carry[1][:, self._idx]]
                           ).float().to("cpu", non_blocking=True)


# ---------------------------------------------------------------------------
# set-up, window, check
# ---------------------------------------------------------------------------


def build(cell, cfg, seed: int, device):
    """Weights, thresholds calibrated by the program and the engine:
    (policy, inputs, {exit: threshold}, calibration [(batch, draws)])."""
    from deer_vla_tpu_torch.eval.calibrate import calibrate
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inp = Inputs(cell.traffic, cell.config, seed)
    cal = cell.traffic["calibration"]
    batches = inp.calibration(list(cfg.all_exit_ids()))
    params = draw_params(cell.config["deer"], seed, device)
    thresholds, _ = calibrate(
        params, cfg, [b for b, _ in batches], cal["exit_ratio"],
        exit_dist=cal["exit_dist"], model_name=cell.config["registry"],
        threshold_type=cal["threshold_type"], draws=[d for _, d in batches])
    policy = ScanDeerPolicy(params, cfg, threshold_type=cal["threshold_type"],
                            indexed_mm=True, device=device)
    policy.set_thresholds(thresholds)
    return policy, inp, thresholds, batches


def one_call(engine, inp: Inputs, log: Log, lanes: List[Lane], index: int,
             cfg, traffic: dict, steps: Optional[List[int]] = None):
    """One ``evaluate_policy_batched`` call over call ``index``'s chains
    (``steps``: other subtask lengths, for the warm-up)."""
    from deer_vla_tpu_torch.eval.batched_rollout import \
        evaluate_policy_batched
    sequences, annotations, lengths = inp.call(index)
    if steps is not None:
        lengths = {n: steps[int(n.split(".")[2])] for n in lengths}
    log.lengths.update(lengths)
    with log.tracer.span("rollout.call"):
        return evaluate_policy_batched(
            engine, lanes, sequences, annotations, Oracle(log, lengths),
            Tokenizer(inp), text_len=cfg.text_len, ep_len=traffic["ep_len"],
            n_layers=cfg.n_layers, pipeline=traffic["pipeline"])


WARMUP_CALL = 2 ** 32 - 1  # the warm-up's chains: a stream no window call uses


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tracked_lanes(lanes: int, n: int, seed: int) -> List[int]:
    """``n`` lanes whose outputs the check follows, one drawn from the seed
    in each of ``n`` equal blocks of the batch, so that a fault in any
    half or quarter of the batch reaches one of them."""
    rng = np.random.default_rng([seed, 4])
    edges = [lanes * q // n for q in range(n + 1)]
    return [int(rng.integers(edges[q], edges[q + 1])) for q in range(n)]


def run(cell, seed: int, seconds: Optional[float], trace: bool, device,
        t_start: float, low: Optional[str] = None, wrap=None) -> dict:
    """One run of a rollout cell: set-up, the window, the output check.
    ``seconds`` None makes the window one whole call.  Returns {"e2e",
    "readings", "numbers", ...}; with ``low`` also "control", the check's
    numbers of the reference in that precision put in the program's place
    (``check_outputs``); ``wrap(policy)`` may plant a fault in the
    engine."""
    from deer_vla_tpu_torch.utils.compile_cache import enable_compile_cache
    from harness import deer_config
    from tracing import Tracer
    from paths import kernel_cache
    enable_compile_cache(str(kernel_cache()))
    traffic = cell.traffic
    cfg = deer_config(cell.config)
    tracer = Tracer("rollout.loop")
    log = Log(tracer, tracked_lanes(traffic["lanes"],
                                    traffic["check"]["lanes"], seed))
    policy, inp, thresholds, batches = build(cell, cfg, seed, device)
    lanes = [Lane(i, inp, log) for i in range(traffic["lanes"])]
    first, count = traffic["trace_steps"], traffic["trace_steps"]

    def before_step(i):
        if not trace or not log.recording:
            return
        if i == first:
            tracer.start()
        elif i == first + count and tracer.active:
            tracer.stop()

    engine = Engine(policy if wrap is None else wrap(policy), log,
                    before_step)
    warm = traffic["warmup_steps"]
    n_sub = traffic["subtasks_per_chain"]
    one_call(engine, inp, log, lanes, WARMUP_CALL, cfg, traffic,
             steps=[warm // n_sub + (j < warm % n_sub) for j in range(n_sub)])
    sync(device)
    gc.collect()
    gc.freeze()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    log.clear_steps()
    log.recording = True
    steps0 = sum(x.steps for x in lanes)
    t0 = time.perf_counter()
    log.last_env_t = t0
    if seconds is not None:
        log.deadline = t0 + seconds
    calls = 0
    try:
        while True:
            one_call(engine, inp, log, lanes, calls, cfg, traffic)
            calls += 1
            if seconds is None:
                break
    except WindowClosed:
        pass
    wall = log.last_env_t - t0
    log.recording = False
    if tracer.active and not tracer.done:
        tracer.stop()
    sync(device)
    env_steps = sum(x.steps for x in lanes) - steps0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    gc.unfreeze()

    exits = list(cfg.all_exit_ids())
    red = tracer.reduce() if tracer.active else None
    traced = (log.dispatch_exits[first:first + count] if red is not None
              else [])
    readings = {"window_s": wall, "step_s": list(log.step_s),
                "dispatch_exits": log.dispatch_exits, "trace": red,
                "traced_exits": traced,
                "flops_by_exit": served_step_flops(cfg, exits)}
    e2e = {"env_steps_per_s": env_steps / wall,
           "step_ms_p95": float(np.percentile(log.step_s, 95)) * 1e3,
           "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    hist = np.bincount(np.concatenate(log.dispatch_exits),
                       minlength=cfg.n_layers)[exits]
    info = {"calls": calls, "steps": len(log.step_s), "env_steps": env_steps,
            "window_s": wall,
            "exit_mix": (hist / hist.sum()).round(4).tolist(),
            "exit_target": ref.exit_probs(
                len(exits), traffic["calibration"]["exit_ratio"],
                traffic["calibration"]["exit_dist"],
                cell.config["registry"]).round(4).tolist(),
            "thresholds": {str(k): v for k, v in thresholds.items()},
            "tracked": log.track, "peak_bytes": peak,
            "bad_actions": log.bad_actions}

    del engine, policy, lanes
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, control = check_outputs(cell, cfg, inp, log, thresholds,
                                     batches, seed, device, low)
    info["check_s"] = time.perf_counter() - t_check
    out = {"e2e": e2e, "readings": readings, "numbers": numbers,
           "info": info, "attempted": env_steps, "failed": log.bad_actions}
    if control is not None:
        out["control"] = control
    return out


def reference_thresholds(cell, params, exits, batches, device):
    """The thresholds worked out again by the reference (in its current
    precision, ``reference.LOW``) from the calibration windows and draws:
    ({exit: threshold}, the deltas (n_exit, samples))."""
    c = cell.config["deer"]
    cal = cell.traffic["calibration"]
    w = c["window_size"]
    values = []
    for batch, draws in batches:
        b = batch["input_ids"].shape[0]

        def frames(key):
            a = torch.as_tensor(batch[key], device=device)
            return a.reshape((b * w,) + a.shape[2:])

        def rows(key):
            return torch.as_tensor(batch[key], device=device
                                   ).repeat_interleave(w, 0)

        values.append(ref.calibration_deltas(
            params, c, frames("rgb_static"), frames("rgb_gripper"),
            rows("input_ids"), rows("attention_mask"),
            draws["rand_layer_ids"].to(device), exits).cpu().numpy())
    values = np.concatenate(values, 1)
    return ref.solve_thresholds(values, cal["exit_ratio"], exits,
                                cal["exit_dist"],
                                cell.config["registry"]), values


def in_low(low: Optional[str], fn, *args):
    """``fn(*args)`` with the reference's products in precision ``low``."""
    ref.LOW = low
    try:
        return fn(*args)
    finally:
        ref.LOW = None


def check_outputs(cell, cfg, inp: Inputs, log: Log, thresholds: dict,
                  batches, seed: int, device, low: Optional[str] = None):
    """The plain reference over what the window served: the thresholds
    worked out again from the calibration windows and draws
    (``reference.threshold_gaps``); then one subtask of each tracked lane
    (the longest of all among them, the others drawn from the seed),
    followed step by step from the carry the program served it with
    (``reference.follow_subtask``): the program's arm actions, gripper
    signs, exit decisions under its own thresholds and committed carries
    against the reference's (``reference.compare_steps``), and its carry
    at each subtask's first step against the zeros of the reset
    (``start_gap``).  Each number is the worst over the sample.  With
    ``low``, the control's numbers too: the reference in that precision
    put in the program's place, calibrating and serving the same steps
    from the same carries.  Returns (numbers, control numbers or None)."""
    ref.strict_fp32()
    c = cell.config["deer"]
    exits = list(cfg.all_exit_ids())
    params = draw_params(c, seed, device)
    keys = sorted(log.subtasks)
    if not keys:
        raise RuntimeError("the window served no tracked step")
    rng = np.random.default_rng([seed, 5])
    longest = max(keys, key=lambda k: (len(log.subtasks[k]["exits"]), k))
    pick = []
    for lane in log.track:
        mine = [k for k in keys if k[0] == lane]
        if longest in mine:
            pick.append(longest)
        elif mine:
            pick.append(mine[int(rng.integers(len(mine)))])
    with torch.no_grad():
        thr_ref, values = reference_thresholds(cell, params, exits, batches,
                                               device)
        numbers = ref.threshold_gaps(thresholds, thr_ref, values, exits)
        control = None
        if low is not None:
            thr_low, _ = in_low(low, reference_thresholds, cell, params,
                                exits, batches, device)
            control = ref.threshold_gaps(thr_low, thr_ref, values, exits)
        for lane, name in pick:
            rec = dict(log.subtasks[(lane, name)])
            j = log.track.index(lane)
            cin, cout = zip(*(log.carry(i, j) for i in rec["step"]))
            rec["carry_out"] = cout
            fi = np.asarray(rec["frames"])
            ids, mask = inp.padded(inp.subtask_task(name))
            args = (params, c, exits,
                    torch.as_tensor(inp.static[fi], device=device),
                    torch.as_tensor(inp.gripper[fi], device=device),
                    torch.as_tensor(ids, device=device)[None],
                    torch.as_tensor(mask, device=device)[None],
                    np.stack(cin), cell.traffic["check"]["block"])
            follow = ref.follow_subtask(*args)
            got = ref.compare_steps(follow, rec, exits, thresholds)
            got["start_gap"] = float(np.abs(cin[0]).max())
            numbers = _worst(numbers, got)
            if low is not None:
                served = ref.served_by_reference(
                    in_low(low, ref.follow_subtask, *args), exits, thr_low)
                got = ref.compare_steps(follow, served, exits, thr_low)
                got["start_gap"] = 0.0
                control = _worst(control, got)
    del params
    return numbers, control


def _worst(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {**a, **{k: max(v, a.get(k, 0.0)) for k, v in b.items()}}
