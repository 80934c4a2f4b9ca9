"""The exit criterion's action distance (value_net.py get_delta)."""

from __future__ import annotations

import torch


def get_delta(a1: torch.Tensor, a2: torch.Tensor,
              threshold_type: str = "L2") -> torch.Tensor:
    """Distance between two (..., action_dim) arm actions, reduced over the
    last dim.  Default 'L2' is the root mean square of the difference."""
    d = (a1 - a2).abs()
    if threshold_type == "mean":
        return d.mean(-1)
    if threshold_type == "L2":
        return d.square().mean(-1).sqrt()
    if threshold_type == "max":
        return d.amax(-1)
    if threshold_type == "cosine":
        f1 = a1 / a1.norm(dim=-1, keepdim=True).clamp_min(1e-5)
        f2 = a2 / a2.norm(dim=-1, keepdim=True).clamp_min(1e-5)
        return 1.0 - (f1 * f2).sum(-1)
    raise NotImplementedError(threshold_type)
