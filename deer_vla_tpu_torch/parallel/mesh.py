"""The (dp, fsdp, tp) layout of the processes (the JAX package's
``parallel/mesh.py``).

The reference's runtime is torchrun + NCCL DDP (open_flamingo
distributed.py:73-132, the DDP wrap at train_calvin_post_strategy.py:464).
The axes:

  dp   data parallel: every rank holds the weights whole and averages the
       gradients of its slice of the batch (DDP);
  fsdp parameter sharding (ZeRO-3); a data axis for the batch, as in
       HYBRID_SHARD;
  tp   tensor parallel.

``axis_groups`` builds the process groups of each axis, which the
collectives of weight placement (``parallel/collectives``) run over;
``parallel/sharding.shard_params`` places the weights by the fsdp / tp
rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Mesh:
    """Ranks laid out row-major over (dp, fsdp, tp)."""
    dp: int
    fsdp: int = 1
    tp: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp

    @property
    def data_shards(self) -> int:
        """The batch's shards: dp x fsdp."""
        return self.dp * self.fsdp

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """(dp, fsdp, tp) index of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        return (rank // (self.fsdp * self.tp), (rank // self.tp) % self.fsdp,
                rank % self.tp)

    def data_index(self, rank: int) -> int:
        """Which batch shard ``rank`` holds (tp ranks share one)."""
        d, f, _ = self.coords(rank)
        return d * self.fsdp + f


    def axis_ranks(self, rank: int, axes: Tuple[str, ...]) -> List[int]:
        """The ranks that share ``rank``'s coordinates on every axis not in
        ``axes``, in rank order: ``rank``'s group over ``axes``."""
        mine = dict(zip(("dp", "fsdp", "tp"), self.coords(rank)))
        return [r for r in range(self.size)
                if all(c == mine[a] for a, c in
                       zip(("dp", "fsdp", "tp"), self.coords(r))
                       if a not in axes)]


# the groups of one rank: each axis, the data shards (dp x fsdp: the ranks
# that hold one tp coordinate) and the model shards (fsdp x tp: the ranks
# of one dp replica)
GROUP_AXES = {"tp": ("tp",), "fsdp": ("fsdp",), "dp": ("dp",),
              "data": ("dp", "fsdp"), "model": ("fsdp", "tp")}


@dataclass(frozen=True)
class AxisGroup:
    """One of ``rank``'s groups: its ranks in order, this rank's index
    among them, and the ``torch.distributed`` group (None when the group
    has one rank: nothing to communicate)."""
    ranks: Tuple[int, ...]
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_groups(mesh: Mesh, rank: int) -> Dict[str, AxisGroup]:
    """``rank``'s group of each ``GROUP_AXES`` entry.  Every rank of the
    process group must call this, with the same mesh: ``new_group`` is a
    collective, so each rank creates every group of more than one rank, in
    one order, also the groups it is not in.  Without a process group (a
    mesh of one) the groups carry no ``torch.distributed`` group."""
    out = {}
    for name, axes in GROUP_AXES.items():
        mine = None
        seen = set()
        for r in range(mesh.size):
            ranks = tuple(mesh.axis_ranks(r, axes))
            if ranks in seen:
                continue
            seen.add(ranks)
            group = None
            if len(ranks) > 1:
                import torch.distributed as dist
                group = dist.new_group(list(ranks))
            if rank in ranks:
                mine = AxisGroup(ranks, ranks.index(rank), group)
        out[name] = mine
    return out


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
              world: Optional[int] = None) -> Mesh:
    """A mesh over ``world`` ranks (the process group's size unless
    given); ``dp`` None takes what fsdp x tp leave."""
    if world is None:
        from deer_vla_tpu_torch.parallel.multihost import process_count
        world = process_count()
    if dp is None:
        assert world % (fsdp * tp) == 0, (world, fsdp, tp)
        dp = world // (fsdp * tp)
    assert dp * fsdp * tp == world, \
        f"mesh {dp}x{fsdp}x{tp} != {world} processes"
    return Mesh(dp, fsdp, tp)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.data_shards
    assert global_batch % n == 0, (global_batch, n)
    return global_batch // n
