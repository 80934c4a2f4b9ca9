"""RandomShiftsAug (DrQ-style pad + random crop), reference
robot_flamingo/data/data.py:137-194; the JAX package's ``ops/rand_shift.py``.

The reference pads with 'replicate' and samples with ``grid_sample`` at
integer pixel shifts, so every sample point lands on a pixel centre and the
op is an integer crop of the edge-padded image.  Shifts come from an
explicit ``torch.Generator`` (or from the caller, as ``shifts``):

  * per image (``random_shift``):          shift ~ U{0, ..., 2 * pad}
  * per trajectory (``random_shift_traj``): shift ~ U{1, ..., 2 * pad}
    (data.py:184 draws randint(1, 2p + 1)), one per (n, t) frame.

``shifts`` is (N, 2): column 0 the x (width) offset, column 1 the y offset.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def draw_shifts(gen: torch.Generator, n: int, low: int, pad: int
                ) -> torch.Tensor:
    return torch.randint(low, 2 * pad + 1, (n, 2), generator=gen,
                         device=gen.device)


def shift_crop(x: torch.Tensor, pad: int, shifts: torch.Tensor
               ) -> torch.Tensor:
    """x (N, C, H, W), shifts (N, 2) -> the (H, W) crop of the edge-padded
    image starting at row shifts[:, 1], column shifts[:, 0]."""
    n, _, h, w = x.shape
    if h != w:
        raise ValueError(f"random shift needs square frames, got {h}x{w}")
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    shifts = shifts.to(x.device)
    ar = torch.arange(h, device=x.device)
    rows = shifts[:, 1, None] + ar
    cols = shifts[:, 0, None] + ar
    batch = torch.arange(n, device=x.device)[:, None, None]
    # advanced indices around a slice: the result is (N, H, W, C)
    out = xp[batch, :, rows[:, :, None], cols[:, None, :]]
    return out.permute(0, 3, 1, 2)


def random_shift(gen: torch.Generator, x: torch.Tensor, pad: int,
                 shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (N, C, H, W) -> same shape, one random integer shift per image."""
    if shifts is None:
        shifts = draw_shifts(gen, x.shape[0], 0, pad)
    return shift_crop(x, pad, shifts)


def random_shift_traj(gen: torch.Generator, x: torch.Tensor, pad: int,
                      shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (N, T, C, H, W); one shift per (n, t) frame from U{1..2p}
    (forward_traj, data.py:168-194)."""
    n, t = x.shape[:2]
    if shifts is None:
        shifts = draw_shifts(gen, n * t, 1, pad)
    out = shift_crop(x.reshape(n * t, *x.shape[2:]), pad, shifts)
    return out.reshape(x.shape)
