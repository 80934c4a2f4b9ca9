"""Rollout evaluation (the JAX package's ``eval/rollout.py``; the
reference's eval_utils.py): the env protocol, the fake ``DebugEnv`` and its
success oracle, the policy adapter, the rollout loop (EP_LEN = 360),
sequence evaluation and the static split of sequences over processes.

The environment stays on the host; frames go to the policy's device as
raw uint8 and are resized and normalized there.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deer_vla_tpu_torch.data.debug_data import TASKS
from deer_vla_tpu_torch.data.preprocess import clip_preprocess
from deer_vla_tpu_torch.data.text import fixed_length
from deer_vla_tpu_torch.eval.metrics import summarize
from deer_vla_tpu_torch.eval.scan_policy import folded_window

EP_LEN = 360


# ---------------------------------------------------------------------------
# environments
# ---------------------------------------------------------------------------


class DebugEnv:
    """Fake CALVIN env (eval_utils.py:152-175).  With ``dynamic=True`` the
    observations follow an internal state the actions drive, so closed-loop
    behaviour and success detection are testable without the simulator.
    ``host_latency_ms`` sleeps that long a step, standing in for a
    simulator's host time.  ``steps`` counts the env steps taken."""

    def __init__(self, img_hw: int = 200, grip_hw: int = 84,
                 dynamic: bool = True, host_latency_ms: float = 0.0):
        self.img_hw, self.grip_hw = img_hw, grip_hw
        self.dynamic = dynamic
        self.host_latency_ms = host_latency_ms
        self.steps = 0
        self.reset()

    def reset(self, robot_obs=None, scene_obs=None):
        self._state = np.zeros(15, np.float32)
        if robot_obs is not None:
            self._state[:len(robot_obs)] = np.asarray(robot_obs)[:15]
        self._progress = 0.0
        return self.get_obs()

    def get_obs(self) -> Dict:
        base = (int(abs(self._state[:3].sum()) * 50) % 200 if self.dynamic
                else 1)
        img = np.full((self.img_hw, self.img_hw, 3), base, np.uint8)
        grip = np.full((self.grip_hw, self.grip_hw, 3), 255 - base, np.uint8)
        return {"rgb_obs": {"rgb_static": img, "rgb_gripper": grip},
                "robot_obs": self._state.copy()}

    def step(self, action: np.ndarray):
        if self.host_latency_ms > 0:
            time.sleep(self.host_latency_ms / 1e3)
        action = np.asarray(action, np.float32)
        self._state[:6] += 0.02 * action[:6]
        self._state[6] = action[6]
        self._progress += float(np.abs(action[:6]).mean())
        self.steps += 1
        return self.get_obs(), 0.0, False, self.get_info()

    def get_info(self) -> Dict:
        return {"progress": self._progress, "state": self._state.copy()}


class DebugTaskOracle:
    """Success oracle for DebugEnv: a subtask succeeds once enough motion
    has accumulated since the start of its rollout."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def get_task_info_for_set(self, start_info: Dict, current_info: Dict,
                              subtasks: set) -> set:
        if current_info["progress"] - start_info["progress"] >= self.threshold:
            return set(subtasks)
        return set()


# ---------------------------------------------------------------------------
# policy adapter: obs dict -> device tensors -> policy.step
# ---------------------------------------------------------------------------


class CalvinPolicyAdapter:
    """ModelWrapper equivalent (eval_utils.py:187-490) around a serving
    policy: each step's two camera frames are uploaded as uint8 and
    preprocessed on the policy's device (the gripper at ``gripper_res``
    when set); the goal's tokens are cached per instruction.

    Window-folded models ('vit_concat' / ``use_hist``) get a rolling
    W-frame window a step, left-padded with the episode's first frame (the
    reference's img_queue, eval_utils.py:344-386); ``use_hist`` also gets
    the goal tiled a frame.  A policy that caches the frame window itself
    (``feeds_single_frame``, ``eval/caching.FrameCachePolicy``) gets the
    newest frame only.  State models get ``robot_obs`` (arm pose and
    gripper only with ``clip_state``), a row a frame of the window."""

    def __init__(self, policy, text_fn: Callable, text_len: int = 32):
        self.policy = policy
        self.text_fn = text_fn
        self.text_len = text_len
        self._goal_cache: Tuple[Optional[str], Optional[tuple]] = (None, None)
        self.llm_time = 0.0
        cfg = policy.cfg
        self._size = cfg.vit.image_size
        self._grip_size = cfg.gripper_res or self._size
        w = folded_window(cfg)
        self._window = w if w > 1 else 0
        self._tile_text = cfg.use_hist
        self._img_window = (0 if getattr(policy, "feeds_single_frame", False)
                            else self._window)
        self._use_state = cfg.use_state or cfg.head.use_state
        self._img_q: List[torch.Tensor] = []
        self._grip_q: List[torch.Tensor] = []
        self._state_q: List[np.ndarray] = []

    def reset(self):
        self.policy.reset()
        self._img_q, self._grip_q, self._state_q = [], [], []

    @property
    def current_exit_layer(self) -> int:
        return self.policy.last_exit_layer

    def _tokenize(self, goal: str):
        cached_goal, cached = self._goal_cache
        if cached_goal == goal:
            return cached
        ids, mask = self.text_fn([goal])
        pad_id = getattr(self.text_fn, "pad_token_id", 0)
        ids, mask = fixed_length(ids, mask, self.text_len, pad_id)
        if self._tile_text:
            # use_hist: one text row a frame of the window
            ids = np.tile(np.asarray(ids), (self._window, 1))
            mask = np.tile(np.asarray(mask), (self._window, 1))
        out = (ids, mask)
        self._goal_cache = (goal, out)
        return out

    def _frame(self, frame: np.ndarray, size: int) -> torch.Tensor:
        """uint8 (H, W, 3) -> (1, 1, 1, 3, size, size) on the device."""
        u8 = torch.as_tensor(np.asarray(frame), device=self.policy.device)
        return clip_preprocess(u8[None], size)[:, None, None]

    def step(self, obs: Dict, goal: str) -> np.ndarray:
        img = self._frame(obs["rgb_obs"]["rgb_static"], self._size)
        grip = self._frame(obs["rgb_obs"]["rgb_gripper"], self._grip_size)
        if self._img_window:
            self._img_q = roll_window(self._img_q, img, self._img_window)
            self._grip_q = roll_window(self._grip_q, grip, self._img_window)
            img, grip = torch.cat(self._img_q), torch.cat(self._grip_q)
        ids, mask = self._tokenize(goal)
        state = None
        if self._use_state and "robot_obs" in obs:
            row = state_row(obs, self.policy.cfg)[None, None, None]
            if self._window:
                self._state_q = roll_window(self._state_q, row, self._window)
                state = np.concatenate(self._state_q)
            else:
                state = row
        t0 = time.perf_counter()
        if state is None:
            action = self.policy.step(img, grip, ids, mask)
        else:
            action = self.policy.step(img, grip, ids, mask, state=state)
        self.llm_time = time.perf_counter() - t0
        return action


def roll_window(queue: list, item, window: int) -> list:
    """The last ``window`` items after ``item``; an empty queue (episode
    start) is filled with ``item`` (eval_utils.py:344-349)."""
    return [item] * window if not queue else (queue + [item])[-window:]


def state_row(obs: Dict, cfg) -> np.ndarray:
    """``robot_obs`` in the training state layout: fp32, the arm pose and
    the gripper only with ``clip_state`` (train_utils.py:253-255)."""
    ro = np.asarray(obs["robot_obs"], np.float32)
    if cfg.clip_state:
        ro = np.concatenate([ro[:6], ro[-1:]], -1)
    return ro


# ---------------------------------------------------------------------------
# rollout loops (eval_utils.py:583-687)
# ---------------------------------------------------------------------------


def rollout(env, adapter: CalvinPolicyAdapter, task_oracle, subtask: str,
            lang_annotation: str, ep_len: int = EP_LEN, replan: int = -1
            ) -> Tuple[bool, List[int], int, List[float]]:
    """One subtask episode (eval_utils.py:625-687).  A (k, 7) plan is
    consumed one action per env step without re-running the policy; the
    exit layer and LLM time are recorded once per env step."""
    obs = env.get_obs()
    adapter.reset()
    start_info = env.get_info()
    exit_layers, llm_times = [], []
    planned: List[np.ndarray] = []
    for step in range(ep_len):
        if replan != -1 and step % replan == 0:
            adapter.reset()
            planned.clear()
        adapter.policy.set_timestep(step)
        if not planned:
            action = adapter.step(obs, lang_annotation)
            if action.ndim == 2:
                planned.extend(list(action))
            else:
                planned.append(action)
        exit_layers.append(adapter.current_exit_layer)
        llm_times.append(adapter.llm_time)
        obs, _, _, current_info = env.step(planned.pop(0))
        if task_oracle.get_task_info_for_set(start_info, current_info,
                                             {subtask}):
            return True, exit_layers, step + 1, llm_times
    return False, exit_layers, ep_len, llm_times


def reset_env_to_initial_state(env, initial_state) -> None:
    """Apply a chain's initial state (eval_utils.py:587-589): a raw
    robot_obs / scene_obs dict, a symbolic condition dict through CALVIN
    when it is installed, else a plain reset."""
    robot_obs = scene_obs = None
    if isinstance(initial_state, dict) and initial_state:
        if "robot_obs" in initial_state or "scene_obs" in initial_state:
            robot_obs = initial_state.get("robot_obs")
            scene_obs = initial_state.get("scene_obs")
        else:
            try:
                from calvin_agent.evaluation.utils import \
                    get_env_state_for_initial_condition
                robot_obs, scene_obs = get_env_state_for_initial_condition(
                    initial_state)
            except ImportError:
                pass  # symbolic dict without CALVIN (DebugEnv)
    env.reset(robot_obs=robot_obs, scene_obs=scene_obs)


def resolve_annotation(annotations, subtask: str, seq_i: int = 0,
                       subtask_i: int = 0) -> str:
    """A dict {task: text}, or the enriched list [seq][subtask]
    (lang_annotation_cache.json, eval_utils.py:513-516)."""
    if isinstance(annotations, list):
        return annotations[seq_i][subtask_i]
    return annotations.get(subtask, subtask)


def evaluate_sequence(env, adapter, task_oracle, initial_state,
                      eval_sequence, annotations, ep_len: int = EP_LEN,
                      seq_i: int = 0, replan: int = -1, reset: bool = False):
    """One 5-subtask chain, stopping at the first failure
    (eval_utils.py:583-622); ``reset`` restores the chain's initial state
    before every subtask (eval_utils.py:603-606)."""
    reset_env_to_initial_state(env, initial_state)
    success_counter = 0
    s_exits, f_exits, s_steps, s_times = [], [], [], []
    for subtask_i, subtask in enumerate(eval_sequence):
        if reset and subtask_i > 0:
            reset_env_to_initial_state(env, initial_state)
        lang = resolve_annotation(annotations, subtask, seq_i, subtask_i)
        ok, exits, n_steps, times = rollout(env, adapter, task_oracle,
                                            subtask, lang, ep_len, replan)
        if ok:
            success_counter += 1
            s_exits.extend(exits)
            s_steps.append(n_steps)
            s_times.extend(times)
        else:
            f_exits.extend(exits)
            break
    return success_counter, s_exits, f_exits, s_steps, s_times


def process_count() -> int:
    """Processes of the torch.distributed group, 1 without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gather_objects(obj) -> List:
    """Every process's ``obj``, in rank order, on every process."""
    n = process_count()
    if n == 1:
        return [obj]
    out = [None] * n
    torch.distributed.all_gather_object(out, obj)
    return out


def evaluate_policy(adapter: CalvinPolicyAdapter, env, sequences: List,
                    annotations, task_oracle, *, rank: int = 0,
                    world_size: int = 1,
                    num_sequences: Optional[int] = None,
                    ep_len: int = EP_LEN,
                    flops_per_layer: Optional[float] = None,
                    n_layers: Optional[int] = None, replan: int = -1,
                    reset: bool = False) -> Dict:
    """Split the sequences statically over the processes
    (eval_utils.py:521-527), run this rank's chains, gather every rank's
    raw results in rank order and summarize them all (eval_utils.py:565-577).

    ``world_size`` must equal the number of processes the gather runs over
    (the torch.distributed group, else 1): a mismatch would summarize a
    part of the sequences as if it were all of them."""
    procs = process_count()
    if world_size != procs:
        raise ValueError(f"world_size={world_size} but {procs} process(es) "
                         "take part in the gather")
    n = num_sequences or len(sequences)
    if n % world_size:
        raise ValueError(f"{n} sequences do not split over {world_size} "
                         "processes (eval_utils.py:525)")
    per = n // world_size
    my = sequences[rank * per:(rank + 1) * per]
    results, s_exits, f_exits, steps, s_times = [], [], [], [], []
    for local_i, (initial_state, eval_sequence) in enumerate(my):
        r, se, fe, st, ti = evaluate_sequence(
            env, adapter, task_oracle, initial_state, eval_sequence,
            annotations, ep_len, seq_i=rank * per + local_i, replan=replan,
            reset=reset)
        results.append(r)
        s_exits.extend(se)
        f_exits.extend(fe)
        steps.extend(st)
        s_times.extend(ti)

    gathered = gather_objects({
        "rank": rank, "results": results, "s_exits": s_exits,
        "f_exits": f_exits, "steps": steps, "s_times": s_times})
    gathered.sort(key=lambda p: p["rank"])

    def merged(key):
        return [x for p in gathered for x in p[key]]

    nl = n_layers or adapter.policy.cfg.n_layers
    return summarize(merged("results"), merged("s_exits"),
                     merged("f_exits"), merged("steps"), merged("s_times"),
                     sequences[:n], nl, flops_per_layer)


def load_eval_sequences(path: str) -> List:
    """The frozen chain list (eval_sequences.json, eval_utils.py:521-522)."""
    with open(path) as f:
        return json.load(f)


def make_debug_sequences(n: int = 8, seed: int = 0) -> List:
    r = np.random.RandomState(seed)
    return [({}, [TASKS[r.randint(len(TASKS))] for _ in range(5)])
            for _ in range(n)]
