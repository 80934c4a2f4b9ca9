"""The training path's random draws, from a ``torch.Generator`` or from a
``RowShard`` of one.

Under data parallelism each rank holds a contiguous slice of the global
batch.  For two ranks to compute what one process computes over the whole
batch, every rank draws the global batch's values (the same generator,
seeded alike on every rank) and keeps the rows of its slice, as GSPMD draws
them globally in the JAX package.  Every draw of the training path has the
batch as its leading dim; a draw with no dim (a scalar) is the same on
every rank.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch


class RowShard:
    """Shard ``index`` of ``shards`` equal row slices of ``gen``'s draws."""

    def __init__(self, gen: torch.Generator, index: int, shards: int):
        if not 0 <= index < shards:
            raise ValueError(f"shard {index} outside [0, {shards})")
        self.gen = gen
        self.index = index
        self.shards = shards

    @property
    def device(self) -> torch.device:
        return self.gen.device


Source = Union[torch.Generator, RowShard]


def _draw(fn, gen: Source, shape: Sequence[int], **kw) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if not isinstance(gen, RowShard):
        return fn(shape, generator=gen, device=gen.device, **kw)
    if not shape:
        return fn(shape, generator=gen.gen, device=gen.device, **kw)
    n = shape[0]
    full = fn((n * gen.shards,) + shape[1:], generator=gen.gen,
              device=gen.device, **kw)
    return full[gen.index * n:(gen.index + 1) * n]


def randint(gen: Source, low: int, high: int, shape: Sequence[int]
            ) -> torch.Tensor:
    return _draw(lambda s, **kw: torch.randint(low, high, s, **kw), gen,
                 shape)


def rand(gen: Source, shape: Sequence[int]) -> torch.Tensor:
    return _draw(torch.rand, gen, shape)


def randn(gen: Source, shape: Sequence[int]) -> torch.Tensor:
    return _draw(torch.randn, gen, shape)
