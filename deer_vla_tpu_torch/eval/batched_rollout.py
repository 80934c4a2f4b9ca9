"""Batched rollout evaluation (the JAX package's
``eval/batched_rollout.evaluate_policy_batched`` at ``pipeline=1``; the
pipelined drive, ``dispatch_batch`` / ``finish_batch``, is not ported): N env
streams advance in lockstep through one ``ScanDeerPolicy.step_batch`` per
env step, with per-stream dynamic exits; a stream that finishes its chain
pulls the next pending one, so the card stays busy until the queue drains.

Per stream the semantics are the sequential harness's: a policy reset per
subtask (``reset_streams``), the chain ends at its first failure, at most
``ep_len`` steps a subtask.  A parked stream (queue drained) exits at the
first exit layer, so it never lengthens the batch's layer loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.data.preprocess import clip_preprocess
from deer_vla_tpu_torch.data.text import fixed_length
from deer_vla_tpu_torch.eval.metrics import summarize
from deer_vla_tpu_torch.eval.rollout import (EP_LEN,
                                             reset_env_to_initial_state,
                                             resolve_annotation)


class _Stream:
    """Host bookkeeping for one rollout lane."""

    def __init__(self, idx: int):
        self.idx = idx
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


def evaluate_policy_batched(policy, envs: List, sequences: List,
                            annotations, task_oracle, text_fn, *,
                            text_len: int = 32, ep_len: int = EP_LEN,
                            n_layers: Optional[int] = None,
                            reset: bool = False) -> Dict:
    """Run all ``sequences`` over ``len(envs)`` parallel streams of one
    ``ScanDeerPolicy`` and summarize them as the sequential harness does."""
    b = len(envs)
    cfg = policy.cfg
    dev = policy.device
    size = cfg.vit.image_size
    grip_size = cfg.gripper_res or size
    policy.reset()
    streams = [_Stream(i) for i in range(b)]
    pending = list(range(len(sequences)))
    results: Dict[int, int] = {}
    s_exits: List[int] = []
    f_exits: List[int] = []
    s_steps: List[int] = []
    pad_id = getattr(text_fn, "pad_token_id", 0)

    def begin_subtask(st: _Stream):
        st.step = 0
        st.exit_layers = []
        st.last_exit = -1
        st.start_info = envs[st.idx].get_info()
        policy.reset_streams(np.arange(b) == st.idx)

    def assign(st: _Stream):
        if not pending:
            st.active = False
            return
        st.seq_i = pending.pop(0)
        st.initial_state, chain = sequences[st.seq_i]
        st.chain = list(chain)
        st.subtask_i = 0
        st.successes = 0
        reset_env_to_initial_state(envs[st.idx], st.initial_state)
        begin_subtask(st)
        st.active = True

    def finish_sequence(st: _Stream):
        results[st.seq_i] = st.successes
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

    # steps_per_stage: a mid-stage stream forces its previous exit through
    # the (B, n_layers) threshold rows, rebuilt from the base rows
    sps = int(policy.steps_per_stage or 1)
    nl_full = cfg.n_layers
    base = policy.thresholds.cpu().numpy().astype(np.float32)
    base_rows = np.tile(base, (b, 1)) if base.ndim == 1 else base.copy()
    park_row = policy.threshold_row(
        {e: (1e30 if e == policy.exits[0] else -1e30) for e in policy.exits})
    rows_dirty = False
    # lockstep waste: the batch runs to its deepest stream's exit, so each
    # active stream wastes (deepest - own exit) layers a dispatch
    waste = {"dispatches": 0, "max_sum": 0, "waste_sum": 0,
             "active_steps": 0, "exit_sum": 0}

    def dispatch_rows() -> Optional[np.ndarray]:
        rows = None
        for st in streams:
            if not st.active:
                rows = base_rows.copy() if rows is None else rows
                rows[st.idx] = park_row
            elif sps > 1 and st.step % sps != 0 and st.last_exit >= 0:
                rows = base_rows.copy() if rows is None else rows
                rows[st.idx] = np.full(nl_full, -1e30, np.float32)
                rows[st.idx, st.last_exit] = 1e30
        if rows is None and rows_dirty:
            rows = base_rows.copy()
        return rows

    while any(st.active for st in streams):
        rows = dispatch_rows()
        if rows is not None:
            policy.set_threshold_array(rows)
            rows_dirty = not np.array_equal(rows, base_rows)
        obs = [envs[st.idx].get_obs()["rgb_obs"] for st in streams]

        def frames(key: str, size: int) -> torch.Tensor:
            """All lanes' frames, zeros for parked lanes, preprocessed on
            the card: (B, 1, 1, 3, size, size)."""
            u8 = np.stack([o[key] if st.active else np.zeros_like(o[key])
                           for st, o in zip(streams, obs)])
            return clip_preprocess(torch.as_tensor(u8, device=dev),
                                   size)[:, None, None]

        toks = [tokens_for(st) if st.active
                else (np.zeros(text_len, np.int32),
                      np.zeros(text_len, np.int32)) for st in streams]
        actions, exit_layers = policy.step_batch(
            frames("rgb_static", size), frames("rgb_gripper", grip_size),
            np.stack([t[0] for t in toks]), np.stack([t[1] for t in toks]))
        plans = actions if actions.ndim == 3 else actions[:, None, :]
        valid = [st.active for st in streams]
        own = [int(exit_layers[i]) for i in range(b) if valid[i]]
        if own:
            deepest = int(np.max(exit_layers))  # the depth the card ran
            waste["dispatches"] += 1
            waste["max_sum"] += deepest
            waste["exit_sum"] += sum(own)
            waste["waste_sum"] += sum(deepest - e for e in own)
            waste["active_steps"] += len(own)
        for j in range(plans.shape[1]):
            for st in streams:
                if not (st.active and valid[st.idx]):
                    continue
                _, _, _, info = envs[st.idx].step(plans[st.idx, j])
                if j == 0:
                    st.exit_layers.append(int(exit_layers[st.idx]))
                    st.last_exit = int(exit_layers[st.idx])
                st.step += 1
                subtask = st.chain[st.subtask_i]
                if task_oracle.get_task_info_for_set(st.start_info, info,
                                                     {subtask}):
                    st.successes += 1
                    s_exits.extend(st.exit_layers)
                    s_steps.append(st.step)
                    st.subtask_i += 1
                    if st.subtask_i >= len(st.chain):
                        finish_sequence(st)
                    else:
                        if reset:
                            reset_env_to_initial_state(envs[st.idx],
                                                       st.initial_state)
                        begin_subtask(st)
                    valid[st.idx] = False
                elif st.step >= ep_len:
                    f_exits.extend(st.exit_layers)
                    finish_sequence(st)
                    valid[st.idx] = False

    ordered = sorted(results)
    rep = summarize([results[i] for i in ordered], s_exits, f_exits,
                    s_steps, [], [sequences[i] for i in ordered],
                    n_layers or cfg.n_layers)
    if waste["dispatches"]:
        d, a = waste["dispatches"], waste["active_steps"]
        rep["batched_exit_waste"] = {
            "dispatches": d,
            "avg_batch_max_exit": round(waste["max_sum"] / d + 1, 3),
            "avg_exit_layer": round(waste["exit_sum"] / a + 1, 3),
            "avg_wasted_layers_per_step": round(waste["waste_sum"] / a, 3)}
    return rep
