"""Parameter and batch placement rules over the (dp, fsdp, tp) mesh (the
JAX package's ``parallel/sharding.py``).

Rules, as the JAX package states them:
  * tp: the attention's fused qkv / cross-attention q and kv and the MLP's
    up projection split their output dim; out_proj / to_out and the MLP's
    down projection split their input dim (Megatron);
  * fsdp: every leaf of at least ``min_size`` elements splits its largest
    dim that divides and tp left free (ZeRO-3);
  * batch: the leading dim over dp x fsdp.

``param_placements`` gives each leaf's per-dim axis names; the port places
no weight by them yet (ROADMAP.md M15b): every dp rank holds the weights
whole.  ``shard_batch`` gives a rank its slice of a batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deer_vla_tpu_torch.ops.layers import keystr, tree_map_with_path
from deer_vla_tpu_torch.parallel.mesh import Mesh

_TP_ROWS = ("wqkv", "mlp_up", "to_q", "to_kv")   # split the output dim
_TP_COLS = ("out_proj", "mlp_down", "to_out")    # split the input dim

Placement = Tuple[Optional[str], ...]


def leaf_placement(path_str: str, shape, mesh: Mesh, *, fsdp: bool,
                   tp: bool, min_size: int) -> Placement:
    """The axis name (or None) of each dim of one leaf."""
    ndim = len(shape)
    spec = [None] * ndim
    if tp and mesh.tp > 1 and ndim == 2:
        if any(f"'{k}'" in path_str for k in _TP_ROWS) \
                and shape[1] % mesh.tp == 0:
            spec[1] = "tp"
        elif any(f"'{k}'" in path_str for k in _TP_COLS) \
                and shape[0] % mesh.tp == 0:
            spec[0] = "tp"
    if fsdp and mesh.fsdp > 1 and int(np.prod(shape)) >= min_size:
        for i in sorted(range(ndim), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % mesh.fsdp == 0:
                spec[i] = "fsdp"
                break
    return tuple(spec)


def param_placements(params, mesh: Mesh, *, fsdp: bool = True,
                     tp: bool = False, min_size: int = 2 ** 16):
    """A tree like ``params`` of per-leaf placements (``()`` for a
    scalar).  A leaf is anything with a ``shape``."""
    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return ()
        return leaf_placement(keystr(path), shape, mesh, fsdp=fsdp, tp=tp,
                              min_size=min_size)
    return tree_map_with_path(one, params)


def check_batch_split(batch_size: int, mesh: Mesh) -> int:
    """Trajectories a data shard: a contiguous row split keeps each rank's
    frame rows (B*W) with its labels (B) only when dp x fsdp divides B."""
    n = mesh.data_shards
    if batch_size % n:
        raise ValueError(f"batch of {batch_size} trajectories is not "
                         f"divisible by the mesh's {n} data shards")
    return batch_size // n


def shard_batch(batch, mesh: Mesh, rank: int):
    """This rank's contiguous slice of every leaf whose leading dim divides
    by dp x fsdp; every other leaf whole.  A training batch's trajectories
    (its ``labels`` rows) must divide (``check_batch_split``)."""
    n = mesh.data_shards
    i = mesh.data_index(rank)
    if isinstance(batch, dict) and "labels" in batch:
        check_batch_split(batch["labels"].shape[0], mesh)

    def one(_, x):
        shape = getattr(x, "shape", ())
        if len(shape) >= 1 and shape[0] % n == 0:
            per = shape[0] // n
            return x[i * per:(i + 1) * per]
        return x
    return tree_map_with_path(one, batch)
