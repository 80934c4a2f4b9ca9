"""Action normalizer of the diffusion head: the JAX package's
``models/normalizer.py`` (a numpy-only LinearNormalizer port,
robot_flamingo/models/normalizer.py:57-398, minus the zarr dependency),
kept as the port's own copy.

Modes (normalizer.py:227+ _fit):
  'limits'   — affine map of [min, max] to [-1, 1] (output_min/max),
  'gaussian' — (x - mean) / std.
Parameters are a plain dict {scale, offset, input_stats} of numpy arrays,
fit over the last dim (last_n_dims=1 flattens everything else).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SingleFieldLinearNormalizer:
    def __init__(self, params: Optional[Dict[str, np.ndarray]] = None):
        self.params = params

    def fit(self, data: np.ndarray, mode: str = "limits",
            output_min: float = -1.0, output_max: float = 1.0,
            range_eps: float = 1e-4, fit_offset: bool = True) -> "SingleFieldLinearNormalizer":
        x = np.asarray(data, np.float32).reshape(-1, data.shape[-1])
        stats = {"min": x.min(0), "max": x.max(0),
                 "mean": x.mean(0), "std": x.std(0)}
        if mode == "limits":
            if fit_offset:
                rng = stats["max"] - stats["min"]
                ignore = rng < range_eps
                scale = (output_max - output_min) / np.where(ignore, 1.0, rng)
                offset = output_min - scale * stats["min"]
                offset[ignore] = (output_max + output_min) / 2 - stats["min"][ignore]
                scale[ignore] = 1.0
            else:
                amax = np.maximum(np.abs(stats["min"]), np.abs(stats["max"]))
                scale = np.where(amax < range_eps, 1.0,
                                 max(abs(output_min), abs(output_max)) / amax)
                offset = np.zeros_like(scale)
        elif mode == "gaussian":
            std = np.where(stats["std"] < range_eps, 1.0, stats["std"])
            scale = 1.0 / std
            offset = -stats["mean"] * scale if fit_offset else np.zeros_like(scale)
        else:
            raise ValueError(mode)
        self.params = {"scale": scale.astype(np.float32),
                       "offset": offset.astype(np.float32),
                       "input_stats": stats}
        return self

    def normalize(self, x):
        p = self.params
        return x * p["scale"] + p["offset"]

    def unnormalize(self, x):
        p = self.params
        return (x - p["offset"]) / p["scale"]


class LinearNormalizer:
    """Dict-of-fields normalizer; with a single 'action' field it behaves
    like the reference default used by the diffusion head
    (train_calvin_post_strategy.py:457-461 fits on stacked actions)."""

    def __init__(self):
        self.fields: Dict[str, SingleFieldLinearNormalizer] = {}

    def fit(self, data, last_n_dims: int = 1, mode: str = "limits", **kw):
        if isinstance(data, dict):
            for k, v in data.items():
                self.fields[k] = SingleFieldLinearNormalizer().fit(v, mode=mode, **kw)
        else:
            self.fields["action"] = SingleFieldLinearNormalizer().fit(
                np.asarray(data), mode=mode, **kw)
        return self

    def __getitem__(self, key: str) -> SingleFieldLinearNormalizer:
        return self.fields[key]

    def normalize(self, x, key: str = "action"):
        return self.fields[key].normalize(x)

    def unnormalize(self, x, key: str = "action"):
        return self.fields[key].unnormalize(x)

    def state_dict(self) -> Dict:
        return {k: v.params for k, v in self.fields.items()}

    def load_state_dict(self, sd: Dict):
        self.fields = {k: SingleFieldLinearNormalizer(p) for k, p in sd.items()}
        return self
