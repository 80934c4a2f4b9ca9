"""Batched serving with the streams split over the ranks of a process group
(the JAX package's ``eval/sharded_serving.py``).

The reference serves one stream a GPU process (eval sequences split over
ranks, eval_utils.py:521-527).  Here B streams step together: every rank
holds the weights whole (a ``ScanDeerPolicy``), steps its contiguous slice
of the streams (images, text, masks, state, carry, per-stream threshold
rows), and the ranks' actions and exit layers are gathered so that every
rank returns all B of them, the surface of ``ScanDeerPolicy.step_batch``.
A rank's exit loop ends when its own streams have exited; each stream's
result is the single-process step's either way.

``eval/batched_rollout.evaluate_policy_batched`` drives it unchanged: every
rank runs the same rollout over all B envs, and the gathered actions keep
the ranks' envs in step.

A mesh with tp > 1: the ranks of one tp group share a data shard and its
streams, and their engine is a tensor-parallel one (``ScanDeerPolicy(...,
tp=)``) on their shards of the weights; ``from_shards`` builds it from a
tree placed by ``parallel.sharding.shard_params``.  fsdp shards are
gathered once, when the engine is built: JAX all-gathers them inside each
step, so here serving does not keep fsdp shards at rest (ROADMAP.md).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.parallel.mesh import Mesh, make_mesh
from deer_vla_tpu_torch.parallel.sharding import Layout, gather_params
from deer_vla_tpu_torch.parallel.multihost import (gather_objects,
                                                   process_index)


class ShardedBatchedPolicy:
    """``inner`` (a ``ScanDeerPolicy``) stepping rank ``rank``'s slice of
    the B streams over ``mesh`` (dp x fsdp data shards; the process
    group's layout unless given).  B must divide by the data shards."""

    def __init__(self, inner, mesh: Optional[Mesh] = None,
                 rank: Optional[int] = None):
        from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
        assert isinstance(inner, ScanDeerPolicy), \
            "sharded serving wraps the while-loop engine"
        if inner.cfg.use_hist or inner.cfg.fusion_mode == "vit_concat":
            raise NotImplementedError(
                "sharded batched serving feeds one frame per stream; "
                "window-folded models use the single-stream windowed path")
        self.inner = inner
        self.cfg = inner.cfg
        self.device = inner.device
        self.exits = inner.exits
        self.steps_per_stage = inner.steps_per_stage
        self.mesh = mesh if mesh is not None else make_mesh()
        self.rank = process_index() if rank is None else rank
        self.n_shards = self.mesh.data_shards
        self.shard = self.mesh.data_index(self.rank)
        self.thresholds = inner.thresholds
        self.last_exit_layer = -1
        self.reset()

    @classmethod
    def from_shards(cls, local: dict, layout: Layout, cfg, **engine_kw):
        """The rank of ``layout`` serving from its local tree: the fsdp
        shards gathered (every rank of each fsdp group joins), then a
        ``ScanDeerPolicy`` on the rank's tp shards with the tp group
        (``engine_kw`` go to it)."""
        from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
        tp_local = gather_params(local, layout.placements, layout.mesh,
                                 layout.groups, axes=("fsdp",))
        inner = ScanDeerPolicy(tp_local, cfg, tp=layout.tp, **engine_kw)
        return cls(inner, layout.mesh, layout.rank)

    def __copy__(self):
        """A wrapper over a shallow copy of the engine: the weights are
        shared, the carry is its own (the pipelined rollout's lane
        groups)."""
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        out.inner = copy.copy(self.inner)
        return out

    # -- episode state -------------------------------------------------------
    def reset(self) -> None:
        self.inner.reset()

    def set_timestep(self, t: int) -> None:
        self.inner.set_timestep(t)

    def _mine(self, b: int) -> slice:
        per = b // self.n_shards
        return slice(self.shard * per, (self.shard + 1) * per)

    def reset_streams(self, stream_mask) -> None:
        """Zero the carry of the streams where the (B,) mask is true: this
        rank's slice of it on this rank's carry."""
        m = np.asarray(stream_mask, bool)
        self.inner.reset_streams(m[self._mine(m.shape[0])])

    # -- thresholds ----------------------------------------------------------
    def threshold_row(self, thresholds) -> np.ndarray:
        return self.inner.threshold_row(thresholds)

    def _set_rows(self, rows: np.ndarray) -> None:
        """(n_layers,) for every stream or (B, n_layers); the inner engine
        takes this rank's rows."""
        rows = np.asarray(rows, np.float32)
        self.thresholds = torch.as_tensor(rows, device=self.device)
        self.inner.set_threshold_array(
            rows if rows.ndim == 1 else rows[self._mine(rows.shape[0])])

    def set_thresholds(self, thresholds) -> None:
        self._set_rows(self.threshold_row(thresholds))

    def set_thresholds_batch(self, rows) -> None:
        self._set_rows(np.stack([self.threshold_row(th) for th in rows]))

    def set_threshold_array(self, arr) -> None:
        self._set_rows(arr)

    # -- serving -------------------------------------------------------------
    def dispatch_batch(self, image, gripper, input_ids, attention_mask,
                       state=None):
        """This rank's slice of the B streams handed to the engine's
        worker thread (``ScanDeerPolicy.dispatch_batch``, which returns at
        once); the gather waits for ``finish_batch``, on the calling
        thread."""
        b = input_ids.shape[0]
        assert b % self.n_shards == 0, \
            (f"stream batch {b} not divisible by the mesh's "
             f"{self.n_shards} data-parallel shards")
        if self.thresholds.ndim == 2 and self.thresholds.shape[0] != b:
            raise ValueError(f"{self.thresholds.shape[0]} threshold rows "
                             f"for {b} streams")
        mine = self._mine(b)
        return self.inner.dispatch_batch(
            image[mine], gripper[mine], input_ids[mine],
            attention_mask[mine], None if state is None else state[mine])

    def finish_batch(self, handle):
        """(actions, exit_layers) of all B streams, on every rank."""
        acts, exits = self.inner.finish_batch(handle)
        parts = gather_objects((self.shard, acts, exits))
        by_shard = {}
        for shard, a, e in parts:  # tp ranks of one data shard agree
            by_shard.setdefault(shard, (a, e))
        ordered = [by_shard[s] for s in range(self.n_shards)]
        return (np.concatenate([a for a, _ in ordered]),
                np.concatenate([e for _, e in ordered]))

    def settle(self, handle) -> None:
        """Wait for a dispatched step without the gather
        (``ScanDeerPolicy.settle``)."""
        self.inner.settle(handle)

    def step_batch(self, image, gripper, input_ids, attention_mask,
                   state=None):
        acts, exits = self.finish_batch(self.dispatch_batch(
            image, gripper, input_ids, attention_mask, state))
        self.last_exit_layer = int(np.max(exits))
        return acts, exits
