"""Weight bridge: a parameter tree of numpy arrays (or tensors) -> the
port's tree of tensors on one device.

The structure and key names stay those of the JAX package's tree, and
linear weights keep their (in, out) layout, so a JAX tree handed over as
``jax.tree.map(np.asarray, params)`` runs through the port unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.ops.layers import tree_map


def _leaf(x, device: torch.device, dtype: Optional[torch.dtype]):
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch view
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_torch(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Same tree, every array leaf a tensor on ``device``; floating leaves
    cast to ``dtype`` when it is given.  ``None`` leaves stay ``None``."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf(x, dev, dtype), tree)
