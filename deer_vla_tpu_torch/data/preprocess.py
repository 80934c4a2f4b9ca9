"""Image preprocessing on the frames' device (the JAX package's
``data/preprocess.py``).

The reference runs torchvision's CLIP transform on CPU workers (bicubic
resize to 224, normalize; data.py:898-903) and RandomShiftsAug in the
collater (data.py:769-795).  Here raw uint8 frames (CALVIN: 200 x 200
static, 84 x 84 wrist) go to the device and are resized, normalized and
augmented there.

The resize is the JAX package's ``jax.image.resize(method="cubic")``: the
Keys cubic kernel with a = -0.5, antialiased when downsampling (the kernel
stretched by the inverse scale), each output's weights normalized to sum
to one.  ``F.interpolate(mode="bicubic")`` uses a = -0.75 and does not
antialias, so it is not used: the separable weights are built as
``jax.image.scale_and_translate`` builds them and applied as two small
matrix products.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.ops.rand_shift import random_shift, random_shift_traj

# OpenAI CLIP normalization constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys (1981) cubic convolution kernel, a = -0.5, at |x|."""
    f = x.dtype.type
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0),
                   out)
    return np.where(x >= 2, f(0.0), out).astype(x.dtype)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) weights of a cubic resize along one axis,
    antialiased when downsampling: ``jax.image.compute_weight_mat`` with
    translation 0, in its fp32 arithmetic (exact float64 weights differ from
    JAX's by up to 1.5e-5)."""
    f = np.float32
    inv_scale = f(1.0) / f(out_size / in_size)
    kernel_scale = max(inv_scale, f(1.0))
    sample_f = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f)[:, None]) \
        / kernel_scale
    w = keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000 * np.finfo(f).eps,
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


@functools.lru_cache(maxsize=32)
def _weights_on(in_size: int, out_size: int, device: torch.device
                ) -> torch.Tensor:
    """``resize_weights`` on a device, built once per size pair and device;
    callers must not write to it."""
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def cubic_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) float -> (N, size, size, C): one product per axis that
    changes size."""
    _, h, w, _ = x.shape
    if h != size:
        wh = _weights_on(h, size, x.device).to(x.dtype)
        x = torch.einsum("nhwc,ho->nowc", x, wh)
    if w != size:
        ww = _weights_on(w, size, x.device).to(x.dtype)
        x = torch.einsum("nhwc,wp->nhpc", x, ww)
    return x


def clip_preprocess(images: torch.Tensor, size: int = 224,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> normalized (N, 3, size, size) on the images'
    device: cubic resize, CLIP mean / std, NCHW."""
    x = images.to(dtype) / 255.0
    x = cubic_resize(x, size)
    mean = torch.tensor(CLIP_MEAN, dtype=dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=dtype, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def preprocess_train_frames(gen: Optional[torch.Generator],
                            static_u8: torch.Tensor,
                            gripper_u8: torch.Tensor, *, rgb_pad: int = 10,
                            gripper_pad: int = 4, traj_cons: bool = True,
                            window: int = 12, size: int = 224,
                            gripper_size: Optional[int] = None,
                            dtype: torch.dtype = torch.float32):
    """Train-time vision preprocessing of one batch.

    static_u8 / gripper_u8: (B*W, H, W, 3) uint8.  Returns the
    (B*W, 1, 1, 3, size, size) pair forward_train takes.  The random shift
    runs after the resize, as in the reference, with shifts drawn from
    ``gen`` (needed only when a pad is > 0); ``gripper_size`` is the wrist
    camera's target size (cfg.gripper_res), None for ``size``."""
    stat = clip_preprocess(static_u8, size, dtype)
    grip = clip_preprocess(gripper_u8, gripper_size or size, dtype)

    def shift(x, pad):
        if pad <= 0:
            return x
        if not traj_cons:
            return random_shift(gen, x, pad)
        b = x.shape[0] // window
        return random_shift_traj(
            gen, x.reshape(b, window, *x.shape[1:]), pad).reshape(x.shape)

    stat = shift(stat, rgb_pad)
    grip = shift(grip, gripper_pad)
    return stat[:, None, None], grip[:, None, None]


def check_gripper_state(rows: np.ndarray, cfg) -> None:
    """Raises ValueError when a head that embeds the gripper state
    (``cfg.head.use_state``) would look up a row outside its table: the
    index is trunc((g + 1) / 2) of the last entry g, in fp32 as the head
    computes it (``models/action_head.embed_state``), and one outside
    [-2, 2) gives NaN actions there.  Indices -2 and -1 wrap to the table's
    rows, as the JAX package's lookup does.  Runs on the host rows, so it
    costs no device sync."""
    if not cfg.head.use_state:
        return
    g = np.asarray(rows, np.float32)[..., -1]
    idx = np.trunc((g + np.float32(1.0)) / np.float32(2.0))
    bad = ~((idx >= -2) & (idx < 2))  # NaN fails both
    if bad.any():
        raise ValueError(
            f"gripper state {g[bad].ravel()[:4].tolist()} is out of range: "
            "the head looks up row trunc((g + 1) / 2), which must lie in "
            "[-2, 2) (CALVIN's gripper state is -1 or 1)")


def state_rows(batch: dict, cfg, device) -> Optional[torch.Tensor]:
    """A state model's (B*W, 1, 1, dim) fp32 proprio rows from the batch's
    ``robot_obs`` (arm pose + gripper only with ``clip_state``,
    train_utils.py:253-255); None for other models or without robot_obs.
    A gripper state the head cannot look up raises
    (``check_gripper_state``)."""
    if not ((cfg.use_state or cfg.head.use_state) and "robot_obs" in batch):
        return None
    st = np.asarray(batch["robot_obs"])[:, :cfg.window_size]
    st = st.reshape(-1, st.shape[-1])
    if cfg.clip_state:
        st = np.concatenate([st[:, :6], st[:, -1:]], -1)
    check_gripper_state(st, cfg)
    return torch.as_tensor(st[:, None, None, :], dtype=torch.float32,
                           device=device)
