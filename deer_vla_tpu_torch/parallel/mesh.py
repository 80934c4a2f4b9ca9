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

The port serves dp.  Placing weights by the fsdp / tp rules
(``parallel/sharding.param_placements``) is ROADMAP.md M15b: the layout
and the rules are here, the placement is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


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
