"""Training-mode dropout with explicit keep masks.

The JAX package draws each mask with ``jax.random.bernoulli`` from a key
split off the step's key.  The port draws its masks from a
``torch.Generator``, or takes them from the caller in the order the model
asks for them, so a test can replay the JAX package's masks and compare a
training step element for element.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


class Dropout:
    """``x -> where(keep, x / (1 - rate), 0)`` with ``keep`` drawn from
    ``gen`` (``uniform < 1 - rate``), or the next of ``masks`` (boolean, of
    x's shape) when they are given."""

    def __init__(self, gen: Optional[torch.Generator] = None,
                 masks: Optional[Iterable] = None):
        if (gen is None) == (masks is None):
            raise ValueError("give exactly one of gen and masks")
        self.gen = gen
        self.masks = None if masks is None else iter(masks)

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.masks is not None:
            keep = torch.as_tensor(np.array(next(self.masks)),
                                   device=x.device)
            if keep.shape != x.shape:
                raise ValueError(f"keep mask {tuple(keep.shape)} for an "
                                 f"activation {tuple(x.shape)}")
        else:
            keep = (torch.rand(x.shape, generator=self.gen,
                               device=self.gen.device) < 1.0 - rate)
            keep = keep.to(x.device)
        return torch.where(keep.bool(), x / (1.0 - rate), 0.0)
