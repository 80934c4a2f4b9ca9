"""Batched rollout evaluation (the JAX package's
``eval/batched_rollout.evaluate_policy_batched``): N env streams advance in
lockstep through one ``ScanDeerPolicy.step_batch`` per env step, with
per-stream dynamic exits; a stream that finishes its chain pulls the next
pending one, so the card stays busy until the queue drains.

``pipeline`` > 1 splits the lanes into that many groups, each with its own
carries: group g's outputs are read (``finish_batch``) and its envs stepped
while the later groups' steps were dispatched.  The port's
``dispatch_batch`` reads the host once per exit segment, so it returns
after its layers have run and defers only the copy of the outputs: the
overlap is that copy against the other groups' host work, until the exit
loop runs without host reads (ROADMAP.md M7b).  Per stream the results are
those of ``pipeline=1``: the groups touch disjoint envs and carries.

``env_workers`` > 1 steps a group's envs through a thread pool; the order of
steps per lane is kept and all bookkeeping stays on the driving thread, so
the results are those of serial stepping.

Per stream the semantics are the sequential harness's: a policy reset per
subtask (``reset_streams``), the chain ends at its first failure, at most
``ep_len`` steps a subtask.  A parked stream (queue drained) exits at the
first exit layer, so it never lengthens the batch's layer loop.  A
window-folded model ('vit_concat' / ``use_hist``) gets each lane's rolling
W-frame window as W stream-major rows (``use_hist`` also the goal tiled a
frame), a state model each lane's ``robot_obs`` rows.

``candidates`` (the substrate of ``cli/bayes_opt --parallel``) evaluates K
threshold rows in one rollout: the lanes split into K contiguous blocks,
block k's lanes serve row k through the engine's per-stream threshold rows,
every candidate runs all the sequences, and K reports come back.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.data.preprocess import clip_preprocess
from deer_vla_tpu_torch.data.text import fixed_length
from deer_vla_tpu_torch.eval.metrics import summarize
from deer_vla_tpu_torch.eval.rollout import (EP_LEN,
                                             reset_env_to_initial_state,
                                             resolve_annotation, roll_window,
                                             state_row)
from deer_vla_tpu_torch.eval.scan_policy import folded_window


class _Stream:
    """Host bookkeeping for one rollout lane."""

    def __init__(self, idx: int, group: int, local: int):
        self.idx = idx        # lane (env) index
        self.group = group    # pipeline group
        self.local = local    # row in the group's policy batch
        self.seq_i: Optional[int] = None
        self.chain: List[str] = []
        self.subtask_i = 0
        self.step = 0
        self.successes = 0
        self.exit_layers: List[int] = []
        self.last_exit = -1  # per-stream stage reuse (steps_per_stage)
        self.start_info: Optional[Dict] = None
        self.initial_state = None
        self.active = False
        # a window-folded model's rolling frame and state windows
        self.img_q: List[np.ndarray] = []
        self.grip_q: List[np.ndarray] = []
        self.state_q: List[np.ndarray] = []


def evaluate_policy_batched(policy, envs: List, sequences: List,
                            annotations, task_oracle, text_fn, *,
                            text_len: int = 32, ep_len: int = EP_LEN,
                            n_layers: Optional[int] = None,
                            pipeline: int = 1,
                            candidates: Optional[List] = None,
                            reset: bool = False, env_workers: int = 0):
    """Run all ``sequences`` over ``len(envs)`` parallel streams of one
    ``ScanDeerPolicy`` (or a ``BatchedDiffusionSampler`` around one) and
    summarize them as the sequential harness does.  ``pipeline`` is rounded
    down to a divisor of the lane count, so every group has one batch size.
    With ``candidates`` (K per-exit threshold lists; the lane count a
    multiple of K) the result is a list of K reports, one a candidate, else
    one report."""
    b = len(envs)
    n_cand = len(candidates) if candidates else 1
    if b % n_cand:
        raise ValueError(f"{b} lanes not divisible by {n_cand} candidates")

    def cand_of(lane: int) -> int:
        return lane * n_cand // b

    cfg = policy.cfg
    dev = policy.device
    size = cfg.vit.image_size
    grip_size = cfg.gripper_res or size
    rep = folded_window(cfg)  # frame rows a lane
    folded_w = rep if rep > 1 else 0
    use_state = cfg.use_state or cfg.head.use_state
    n_groups = max(1, min(pipeline, b))
    while b % n_groups:
        n_groups -= 1
    lanes = [list(range(g, b, n_groups)) for g in range(n_groups)]
    # the groups share the weights and thresholds (a shallow copy) and hold
    # their own carries
    gpol = [policy] + [copy.copy(policy) for _ in range(n_groups - 1)]
    for p in gpol:
        p.reset()
    if candidates:
        for g, p in enumerate(gpol):
            p.set_thresholds_batch([candidates[cand_of(i)]
                                    for i in lanes[g]])
    streams: List[_Stream] = [None] * b  # type: ignore[list-item]
    for g, ls in enumerate(lanes):
        for local, idx in enumerate(ls):
            streams[idx] = _Stream(idx, g, local)
    pending = [list(range(len(sequences))) for _ in range(n_cand)]
    results: List[Dict[int, int]] = [{} for _ in range(n_cand)]
    s_exits: List[List[int]] = [[] for _ in range(n_cand)]
    f_exits: List[List[int]] = [[] for _ in range(n_cand)]
    s_steps: List[List[int]] = [[] for _ in range(n_cand)]
    pad_id = getattr(text_fn, "pad_token_id", 0)
    pool = (ThreadPoolExecutor(max_workers=env_workers,
                               thread_name_prefix="deer-env")
            if env_workers and env_workers > 1 else None)

    def begin_subtask(st: _Stream):
        st.step = 0
        st.exit_layers = []
        st.last_exit = -1
        st.img_q, st.grip_q, st.state_q = [], [], []  # a fresh window
        st.start_info = envs[st.idx].get_info()
        gb = len(lanes[st.group])
        gpol[st.group].reset_streams(np.arange(gb) == st.local)

    def assign(st: _Stream):
        queue = pending[cand_of(st.idx)]
        if not queue:
            st.active = False
            return
        st.seq_i = queue.pop(0)
        st.initial_state, chain = sequences[st.seq_i]
        st.chain = list(chain)
        st.subtask_i = 0
        st.successes = 0
        reset_env_to_initial_state(envs[st.idx], st.initial_state)
        begin_subtask(st)
        st.active = True

    def finish_sequence(st: _Stream):
        results[cand_of(st.idx)][st.seq_i] = st.successes
        assign(st)

    for st in streams:
        assign(st)

    tok_cache: Dict[str, tuple] = {}

    def tokens_for(st: _Stream):
        lang = resolve_annotation(annotations, st.chain[st.subtask_i],
                                  st.seq_i, st.subtask_i)
        if lang not in tok_cache:
            ids, mask = text_fn([lang])
            ids, mask = fixed_length(ids, mask, text_len, pad_id)
            tok_cache[lang] = (ids[0], mask[0])
        return tok_cache[lang]

    def group_active(g: int) -> bool:
        return any(streams[i].active for i in lanes[g])

    # steps_per_stage: a mid-stage stream forces its previous exit through
    # the (B, n_layers) threshold rows, rebuilt from each group's base rows
    sps = int(policy.steps_per_stage or 1)
    nl_full = cfg.n_layers
    base_rows = []
    for p, ls in zip(gpol, lanes):
        base = p.thresholds.cpu().numpy().astype(np.float32)
        base_rows.append(np.tile(base, (len(ls), 1)) if base.ndim == 1
                         else base.copy())
    park_row = policy.threshold_row(
        {e: (1e30 if e == policy.exits[0] else -1e30) for e in policy.exits})
    rows_dirty = [False] * n_groups
    # lockstep waste: a group runs to its deepest stream's exit, so each
    # active stream wastes (deepest - own exit) layers a dispatch
    waste = {"dispatches": 0, "max_sum": 0, "waste_sum": 0,
             "active_steps": 0, "exit_sum": 0}

    def dispatch_rows(g: int) -> Optional[np.ndarray]:
        rows = None
        for local, i in enumerate(lanes[g]):
            st = streams[i]
            if not st.active:
                rows = base_rows[g].copy() if rows is None else rows
                rows[local] = park_row
            elif sps > 1 and st.step % sps != 0 and st.last_exit >= 0:
                rows = base_rows[g].copy() if rows is None else rows
                rows[local] = np.full(nl_full, -1e30, np.float32)
                rows[local, st.last_exit] = 1e30
        if rows is None and rows_dirty[g]:
            rows = base_rows[g].copy()
        return rows

    def dispatch(g: int):
        rows = dispatch_rows(g)
        if rows is not None:
            gpol[g].set_threshold_array(rows)
            rows_dirty[g] = not np.array_equal(rows, base_rows[g])
        imgs, grips, states, toks = [], [], [], []
        for i in lanes[g]:
            st = streams[i]
            obs = envs[st.idx].get_obs()
            f, gr = obs["rgb_obs"]["rgb_static"], obs["rgb_obs"]["rgb_gripper"]
            sr = state_row(obs, cfg) if use_state else None
            if not st.active:  # a parked lane: zeros
                imgs += [np.zeros_like(f)] * rep
                grips += [np.zeros_like(gr)] * rep
                states += [np.zeros_like(sr)] * rep if use_state else []
                toks.append((np.zeros(text_len, np.int32),
                             np.zeros(text_len, np.int32)))
                continue
            if folded_w:
                st.img_q = roll_window(st.img_q, f, folded_w)
                st.grip_q = roll_window(st.grip_q, gr, folded_w)
                imgs += st.img_q
                grips += st.grip_q
                if use_state:
                    st.state_q = roll_window(st.state_q, sr, folded_w)
                    states += st.state_q
            else:
                imgs.append(f)
                grips.append(gr)
                states += [sr] if use_state else []
            toks.append(tokens_for(st))

        def frames(u8: list, size: int) -> torch.Tensor:
            """uint8 frames preprocessed on the card: (rows, 1, 1, 3, size,
            size)."""
            return clip_preprocess(torch.as_tensor(np.stack(u8), device=dev),
                                   size)[:, None, None]

        # use_hist: a text row a frame
        text_rep = rep if cfg.use_hist else 1
        args = (frames(imgs, size), frames(grips, grip_size),
                np.repeat(np.stack([t[0] for t in toks]), text_rep, axis=0),
                np.repeat(np.stack([t[1] for t in toks]), text_rep, axis=0))
        kw = ({"state": np.stack(states)[:, None, None, :]} if use_state
              else {})
        if n_groups > 1:
            return gpol[g].dispatch_batch(*args, **kw)
        return gpol[g].step_batch(*args, **kw)

    def finish(g: int, handle):
        return gpol[g].finish_batch(handle) if n_groups > 1 else handle

    def apply(g: int, actions: np.ndarray, exit_layers: np.ndarray):
        """One policy output of group g: k env steps a stream for (Bg, k, 7)
        plans; a stream that ends its subtask mid-plan drops the rest."""
        plans = actions if actions.ndim == 3 else actions[:, None, :]
        valid = {i: streams[i].active for i in lanes[g]}
        own = [int(exit_layers[local]) for local, i in enumerate(lanes[g])
               if valid[i]]
        if own:
            deepest = int(np.max(exit_layers))  # the depth the card ran
            waste["dispatches"] += 1
            waste["max_sum"] += deepest
            waste["exit_sum"] += sum(own)
            waste["waste_sum"] += sum(deepest - e for e in own)
            waste["active_steps"] += len(own)
        for j in range(plans.shape[1]):
            todo = [(local, i) for local, i in enumerate(lanes[g])
                    if streams[i].active and valid[i]]
            if pool is not None and len(todo) > 1:
                outs = list(pool.map(
                    lambda t: envs[t[1]].step(plans[t[0], j]), todo))
            else:
                outs = [envs[i].step(plans[local, j]) for local, i in todo]
            for (local, i), (_, _, _, info) in zip(todo, outs):
                st = streams[i]
                if j == 0:
                    st.exit_layers.append(int(exit_layers[local]))
                    st.last_exit = int(exit_layers[local])
                st.step += 1
                subtask = st.chain[st.subtask_i]
                if task_oracle.get_task_info_for_set(st.start_info, info,
                                                     {subtask}):
                    st.successes += 1
                    s_exits[cand_of(i)].extend(st.exit_layers)
                    s_steps[cand_of(i)].append(st.step)
                    st.subtask_i += 1
                    if st.subtask_i >= len(st.chain):
                        finish_sequence(st)
                    else:
                        if reset:
                            reset_env_to_initial_state(envs[st.idx],
                                                       st.initial_state)
                        begin_subtask(st)
                    valid[i] = False
                elif st.step >= ep_len:
                    f_exits[cand_of(i)].extend(st.exit_layers)
                    finish_sequence(st)
                    valid[i] = False

    # group g's outputs are read and its envs stepped while the groups
    # dispatched after it are in flight
    try:
        handles: List = [None] * n_groups
        for g in range(n_groups):
            if group_active(g):
                handles[g] = dispatch(g)
        while any(h is not None for h in handles):
            for g in range(n_groups):
                if handles[g] is None:
                    continue
                acts, exits = finish(g, handles[g])
                handles[g] = None
                apply(g, acts, exits)
                if group_active(g):
                    handles[g] = dispatch(g)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    waste_report = {}
    if waste["dispatches"]:
        d, a = waste["dispatches"], waste["active_steps"]
        waste_report = {
            "dispatches": d,
            "avg_batch_max_exit": round(waste["max_sum"] / d + 1, 3),
            "avg_exit_layer": round(waste["exit_sum"] / a + 1, 3),
            "avg_wasted_layers_per_step": round(waste["waste_sum"] / a, 3)}
    reports = []
    for c in range(n_cand):
        ordered = sorted(results[c])
        report = summarize([results[c][i] for i in ordered], s_exits[c],
                           f_exits[c], s_steps[c], [],
                           [sequences[i] for i in ordered],
                           n_layers or cfg.n_layers)
        if waste_report:  # the lockstep waste of the whole batch
            report["batched_exit_waste"] = waste_report
        reports.append(report)
    return reports if candidates else reports[0]
