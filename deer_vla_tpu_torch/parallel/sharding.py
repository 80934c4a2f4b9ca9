"""Parameter and batch placement rules over the (dp, fsdp, tp) mesh (the
JAX package's ``parallel/sharding.py``).

Rules, as the JAX package states them:
  * tp: the attention's fused qkv / cross-attention q and kv and the MLP's
    up projection split their output dim; out_proj / to_out and the MLP's
    down projection split their input dim (Megatron);
  * fsdp: every leaf of at least ``min_size`` elements splits its largest
    dim that divides and tp left free (ZeRO-3);
  * batch: the leading dim over dp x fsdp.

``param_placements`` gives each leaf's per-dim axis names (the JAX
package's specs); ``shard_params`` places a tree by them and returns one
rank's local tree, ``gather_params`` puts the whole tree back together.
``shard_batch`` gives a rank its slice of a batch.

The local layout.  A kernel here is a call on one rank's tensors, not a
partitioned program, so a rank's shard must be what it computes with:

  * the fused products split by heads: ``wqkv`` (d, 3d) keeps, on rank r
    of tp, the q, k and v columns of r's heads, [q_r | k_r | v_r], and
    ``to_kv`` [k_r | v_r]; a contiguous split would give rank 0 all of q
    and part of k (``fused_chunks``);
  * a column-parallel bias stays whole in the tree (the JAX specs shard
    2-D leaves only) and the product takes its rank's columns at use
    (``tp_local``); a row-parallel bias is added once, after the reduce;
  * a quantized linear (``ops.quant``: ``q``/``q4`` and a scale) is placed
    as its weight would be, over its last two dims whatever the stack dims
    before them: a column split slices the codes and the per-channel
    scales, a row split slices the codes and keeps the scales whole, and
    int4 codes, packed as halves of K, are unpacked, sliced and repacked,
    so every rank's codes are the whole codes' slice;
  * an fsdp split is contiguous along the leaf's fsdp dim, taken after the
    tp split (they never share a dim).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deer_vla_tpu_torch.ops.layers import (keystr, tree_leaves_with_path,
                                           tree_map_with_path)
from deer_vla_tpu_torch.ops.quant import pack_int4, unpack_int4
from deer_vla_tpu_torch.parallel.mesh import AxisGroup, Mesh

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


# ---------------------------------------------------------------------------
# the local layout
# ---------------------------------------------------------------------------

# the leaves of a quantized linear dict (ops/quant.py): codes and scales
_CODES = ("q", "q4")
_SCALES = ("s", "s4", "s8", "s48")


def fused_chunks(path_str: str) -> int:
    """The products fused in one leaf, split by heads under tp: wqkv's q,
    k and v, to_kv's k and v."""
    if "'wqkv'" in path_str:
        return 3
    if "'to_kv'" in path_str:
        return 2
    return 1


def split_dim(x: torch.Tensor, dim: int, n: int, i: int,
              chunks: int = 1) -> torch.Tensor:
    """Slice ``i`` of ``n`` along ``dim``, taken in each of ``chunks``
    fused parts (contiguous)."""
    parts = x.chunk(chunks, dim) if chunks > 1 else (x,)
    return torch.cat([p.chunk(n, dim)[i] for p in parts], dim).contiguous()


def merge_dim(parts: Sequence[torch.Tensor], dim: int,
              chunks: int = 1) -> torch.Tensor:
    """The inverse of ``split_dim`` over the ``n`` slices in order."""
    if chunks == 1:
        return torch.cat(list(parts), dim)
    per = [p.chunk(chunks, dim) for p in parts]
    return torch.cat([per[r][c] for c in range(chunks)
                      for r in range(len(parts))], dim)


def tp_local(x: torch.Tensor, tp: Optional[AxisGroup], dim: int = -1,
             chunks: int = 1) -> torch.Tensor:
    """This tp rank's slice of a replicated tensor (a column-parallel
    bias), head-grouped over ``chunks`` fused products."""
    if tp is None or tp.size == 1:
        return x
    return split_dim(x, dim, tp.size, tp.index, chunks)


def _split_leaf(x, key: str, dim: int, n: int, i: int, chunks: int):
    if key == "q4" and dim % x.ndim == x.ndim - 2:  # K of packed halves
        return pack_int4(split_dim(unpack_int4(x), -2, n, i, chunks))
    return split_dim(x, dim, n, i, chunks)


def _merge_leaf(parts, key: str, dim: int, chunks: int):
    if key == "q4" and dim % parts[0].ndim == parts[0].ndim - 2:
        return pack_int4(merge_dim([unpack_int4(p) for p in parts], -2,
                                   chunks))
    return merge_dim(parts, dim, chunks)


def _quant_spec(path: tuple, shape, parent: dict, mesh: Mesh, *,
                fsdp: bool, tp: bool, min_size: int) -> Placement:
    """A quantized linear's leaf placed as its weight would be, over its
    last two dims (see the module docstring)."""
    key = path[-1]
    ps = keystr(path[:-1])
    codes = parent["q4"] if "q4" in parent else parent["q"]
    k = codes.shape[-2] * (2 if "q4" in parent else 1)
    n = codes.shape[-1]
    spec = [None] * len(shape)
    if tp and mesh.tp > 1:
        if any(f"'{c}'" in ps for c in _TP_ROWS) and n % mesh.tp == 0:
            spec[-1] = "tp"    # codes and scales by output channel
        elif (any(f"'{c}'" in ps for c in _TP_COLS) and key in _CODES
              and k % (2 * mesh.tp if key == "q4" else mesh.tp) == 0):
            spec[-2] = "tp"    # codes by input row; scales whole
    if fsdp and mesh.fsdp > 1 and int(np.prod(shape)) >= min_size:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % mesh.fsdp == 0:
                spec[i] = "fsdp"
                break
    return tuple(spec)


def shard_placements(params, mesh: Mesh, *, fsdp: bool = True,
                     tp: bool = False, min_size: int = 2 ** 16):
    """``param_placements``, except the leaves of a quantized linear dict,
    which follow its weight's placement (``_quant_spec``)."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            quant = "q" in node or "q4" in node
            return {k: (_quant_spec(path + (k,), v.shape, node, mesh,
                                    fsdp=fsdp, tp=tp, min_size=min_size)
                        if quant and k in _CODES + _SCALES
                        and getattr(v, "ndim", 0) else walk(v, path + (k,)))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, path + (i,)) for i, v in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        shape = tuple(getattr(node, "shape", ()))
        if not shape:
            return ()
        return leaf_placement(keystr(path), shape, mesh, fsdp=fsdp, tp=tp,
                              min_size=min_size)
    return walk(params, ())


def placements_by_path(specs, prefix: tuple = ()) -> Dict[tuple, Placement]:
    """{leaf path: placement} of a placements tree (its tuples are the
    leaves)."""
    if specs is None:
        return {}
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, list):
        items = enumerate(specs)
    else:
        return {prefix: specs}
    return {p: s for k, v in items
            for p, s in placements_by_path(v, prefix + (k,)).items()}


def _leaves(tree, spec_tree):
    """(path, leaf, spec) of every leaf, in the tree's order."""
    specs = placements_by_path(spec_tree)
    return [(p, x, specs.get(p, ())) for p, x in tree_leaves_with_path(tree)]


def _rebuild(tree, values: Dict[tuple, torch.Tensor]):
    return tree_map_with_path(lambda p, x: values[p], tree)


def shard_params(params, mesh: Mesh, rank: int, *, fsdp: bool = True,
                 tp: bool = False, min_size: int = 2 ** 16):
    """(``rank``'s local tree, the placements): the counterpart of the JAX
    package's ``shard_params`` (``parallel/sharding.py:67-69``), which
    ``device_put``s the tree; here each rank keeps its own shards, in the
    local layout of the module docstring."""
    specs = shard_placements(params, mesh, fsdp=fsdp, tp=tp,
                             min_size=min_size)
    _, f, t = mesh.coords(rank)
    spec_of = placements_by_path(specs)
    local = {}
    for path, x in tree_leaves_with_path(params):
        spec = spec_of.get(path, ())
        chunks = fused_chunks(keystr(path))
        if "tp" in spec:
            x = _split_leaf(x, path[-1], spec.index("tp"), mesh.tp, t,
                            chunks)
        if "fsdp" in spec:
            x = split_dim(x, spec.index("fsdp"), mesh.fsdp, f)
        local[path] = x
    return _rebuild(params, local), specs


def _gather_leaf(path, shards: Sequence, spec, mesh: Mesh, axes):
    """One leaf from every rank's shard (``shards[r]``, rank order)."""
    key = path[-1]
    chunks = fused_chunks(keystr(path))
    by_tp = []
    for t in range(mesh.tp if "tp" in axes else 1):
        x = shards[t if "tp" in axes else 0]
        if "fsdp" in spec and "fsdp" in axes:
            x = merge_dim([shards[f * mesh.tp + t] for f in
                           range(mesh.fsdp)], spec.index("fsdp"))
        by_tp.append(x)
    if "tp" in spec and "tp" in axes:
        return _merge_leaf(by_tp, key, spec.index("tp"), chunks)
    return by_tp[0]


def gather_params(shards: Union[dict, List[dict]], placements, mesh: Mesh,
                  groups: Optional[Dict[str, AxisGroup]] = None,
                  axes: Tuple[str, ...] = ("fsdp", "tp")):
    """The inverse of ``shard_params``: the whole tree, bit for bit.

    ``shards`` is either every rank's local tree in rank order (one
    process, for tests and writers), or this rank's local tree, gathered
    over ``groups`` (``mesh.axis_groups``) by all-gathers that every rank
    of each group joins.  ``axes`` names the axes to undo: ``("fsdp",)``
    gives a rank's tp-local tree (the serving engine's, which gathers its
    fsdp shards once when it is built)."""
    if isinstance(shards, list):
        flat = [{p: x for p, x, _ in _leaves(s, placements)}
                for s in shards]
        # one data replica's ranks: (0, f, t) is rank f * tp + t
        return _rebuild(shards[0], {
            path: _gather_leaf(path, [f[path] for f in
                                      flat[:mesh.fsdp * mesh.tp]],
                               spec, mesh, axes)
            for path, _, spec in _leaves(shards[0], placements)})
    from deer_vla_tpu_torch.parallel.collectives import all_gather
    out = {}
    for path, x, spec in _leaves(shards, placements):
        if "fsdp" in spec and "fsdp" in axes:
            x = all_gather(x, groups["fsdp"], spec.index("fsdp"))
        if "tp" in spec and "tp" in axes:
            g = groups["tp"]
            dim = spec.index("tp")
            x = _merge_leaf(list(all_gather(x, g, dim).chunk(g.size, dim)),
                            path[-1], dim, fused_chunks(keystr(path)))
        out[path] = x
    return _rebuild(shards, out)


@dataclass
class Layout:
    """One rank's place in a (dp, fsdp, tp) mesh: the placements of its
    local tree (``shard_params``) and its groups (``mesh.axis_groups``).
    The train step takes it to gather, reduce and clip over the mesh."""
    mesh: Mesh
    rank: int
    placements: dict
    groups: Dict[str, AxisGroup]

    @property
    def tp(self) -> Optional[AxisGroup]:
        return self.groups["tp"]

    @property
    def specs(self) -> Dict[str, Placement]:
        """{flat key: placement} of every leaf."""
        from deer_vla_tpu_torch.ops.layers import flat_key
        return {flat_key(p): s for p, s in
                placements_by_path(self.placements).items()}


def gather_fsdp(local, layout: Layout):
    """The rank's tp-local tree from its fsdp shards, each leaf gathered
    along its fsdp dim with ``collectives.gather_shards`` (so a leaf that
    requires grad gets its gradient reduce-scattered back)."""
    from deer_vla_tpu_torch.parallel.collectives import gather_shards
    spec_of = placements_by_path(layout.placements)
    g = layout.groups["fsdp"]

    def one(path, x):
        spec = spec_of.get(path, ())
        if "fsdp" not in spec:
            return x
        return gather_shards(x, g, spec.index("fsdp"))
    return tree_map_with_path(one, local)


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
