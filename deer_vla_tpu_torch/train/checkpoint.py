"""The calibration sidecar (the JAX package's
``train/checkpoint.py:137-173``): cached calibration deltas in an npz file
beside the checkpoint stem, with a JSON record of the settings they were
made under.  The port keeps its own copy because the JAX module imports
flax; the msgpack checkpoint reader is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


def _stem(path: str) -> str:
    """Drop a trailing '.ckpt' so sidecar paths derive from one stem."""
    return path[:-5] if path.endswith(".ckpt") else path


def save_calibration_values(path: str, values: np.ndarray,
                            info: Optional[Dict] = None) -> None:
    """Write ``{stem}.values.npz`` (the reference mutated ckpt['values'] in
    place, eval_calvin.py:608-611).  Values are stored as fp32."""
    np.savez(_stem(path) + ".values.npz",
             values=np.asarray(values).astype(np.float32),
             info=json.dumps(info or {}))


def load_calibration_info(path: str) -> Dict:
    """The settings recorded beside the cached values (exit_ratio,
    calib_warm, calib_streamed), {} when there is no sidecar."""
    f = _stem(path) + ".values.npz"
    if not os.path.exists(f):
        return {}
    z = np.load(f, allow_pickle=False)
    if "info" not in z.files:
        return {}
    return json.loads(str(z["info"]))


def load_calibration_values(path: str) -> Optional[np.ndarray]:
    f = _stem(path) + ".values.npz"
    if not os.path.exists(f):
        return None
    v = np.load(f, allow_pickle=False)["values"]
    if v.dtype.kind == "V":
        raise ValueError(f"{f} holds raw bf16 bytes (a legacy sidecar); "
                         "recompute the values")
    return v
