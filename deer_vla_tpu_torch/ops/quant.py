"""Weight quantization for the serving engine's stacked trees (the port's
copy of the JAX package's ``ops/quant.py``).

A quantized linear dict carries ``q`` (int8, the weight's shape) and a
per-output-channel fp32 scale instead of ``w``; the scale's key picks how
``ops.layers.linear`` and the stacked decoder consume it:

  ``s``   weight-only int8;
  ``s8``  w8a8: int8 weights and dynamic per-row int8 activations;
  ``s4``  weight-only int4, nibble-packed in ``q4`` (K/2, N);
  ``s48`` w4a8: packed int4 weights and dynamic per-row int8 activations.

Every step runs in fp32 in the JAX package's order (abs-max times the fp32
reciprocal of 127 or 7, floor at 1e-12, divide, round half to even, clip),
so ``q`` and the scales equal the JAX package's bit for bit.

int4 packing is a halves split along the contraction axis: the low nibble of
packed row k holds row k of [0, K/2), the high nibble row K/2 + k.  The
byte is built in int32 from masked nibbles and mapped to int8, so no shift
of a negative value is involved.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

QUANT_MODES = ("int8", "int8_w8a8", "int4", "int4_w8a8")

SERVING_QUANT_PARTS = ("blocks", "xattn", "vit", "perceiver",
                       "perceiver_gripper")
QUANT_PART_GROUPS = {
    "all": SERVING_QUANT_PARTS,
    "decoder": ("blocks", "xattn"),
    "vision": ("vit", "perceiver", "perceiver_gripper"),
}

_SCALE_KEY = {"int8": "s", "int8_w8a8": "s8", "int4": "s4",
              "int4_w8a8": "s48"}


def fp32_reciprocal(levels: float) -> float:
    """1 / levels rounded to fp32, as a Python float: XLA compiles the JAX
    package's ``max|w| / 127`` to a product with this constant, and an fp32
    tensor times it is the same fp32 product (no host-to-device copy)."""
    return float(np.float32(1.0) / np.float32(levels))


def _absmax_quantize(w: torch.Tensor, levels: float):
    """(codes in [-levels, levels] as fp32, fp32 scale over axis -2)."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2) * fp32_reciprocal(levels),
                    min=1e-12)
    q = torch.clamp(torch.round(w32 / s.unsqueeze(-2)), -levels, levels)
    return q, s


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 over the contraction axis (-2) of a
    (..., K, N) weight: (q int8 (..., K, N), s fp32 (..., N))."""
    q, s = _absmax_quantize(w, 127.0)
    return q.to(torch.int8), s


def dequantize_weight(q: torch.Tensor, s: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return (q.float() * s.unsqueeze(-2)).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) codes in [-8, 7] -> (..., K/2, N) int8, halves split."""
    k = q.shape[-2]
    q32 = q.to(torch.int32)
    b = ((q32[..., k // 2:, :] & 0xF) << 4) | (q32[..., : k // 2, :] & 0xF)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def quantize_weight4(w: torch.Tensor):
    """Symmetric per-output-channel int4 (codes in [-7, 7]), packed two rows
    per byte: (q4 int8 (..., K/2, N), s fp32 (..., N)).  K must be even."""
    k = w.shape[-2]
    assert k % 2 == 0, f"int4 packing needs an even contraction dim, got {k}"
    q, s = _absmax_quantize(w, 7.0)
    return pack_int4(q), s


def unpack_nibbles(q4: torch.Tensor):
    """Packed (..., K/2, N) -> (low, high) int32 nibbles, sign-extended:
    rows [0, K/2) and [K/2, K) of the codes."""
    b = q4.to(torch.int32)
    return ((b & 0xF) ^ 8) - 8, b >> 4


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) packed -> (..., K, N) int8 codes."""
    lo, hi = unpack_nibbles(q4)
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def dequantize_weight4(q4: torch.Tensor, s: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    return (unpack_int4(q4).float() * s.unsqueeze(-2)).to(dtype)


def quantize_tree(tree, scale_key: str = "s"):
    """Replace every floating ``{"w": (..., K, N)}`` leaf (ndim >= 2) with
    ``{"q" or "q4", scale_key}``; everything else passes through.  In the int4 modes an odd K falls back to int8
    (``s4`` -> ``q``/``s``, ``s48`` -> ``q``/``s8``).  Only for the
    serving engine's stacked trees, whose weights are all read through
    ``linear`` or the stacked decoder products."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if (k == "w" and isinstance(v, torch.Tensor) and v.ndim >= 2
                    and v.is_floating_point()):
                if scale_key in ("s4", "s48") and v.shape[-2] % 2 == 0:
                    out["q4"], out[scale_key] = quantize_weight4(v)
                elif scale_key == "s4":
                    out["q"], out["s"] = quantize_weight(v)
                elif scale_key == "s48":
                    out["q"], out["s8"] = quantize_weight(v)
                else:
                    out["q"], out[scale_key] = quantize_weight(v)
            else:
                out[k] = quantize_tree(v, scale_key)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_tree(v, scale_key) for v in tree)
    return tree


def quantize_serving_stacked(stacked: dict, mode: Optional[str],
                             parts=SERVING_QUANT_PARTS) -> dict:
    """Quantize the weight-heavy subtrees of the engine's stacked tree.

    mode: None or "none" (no change) or one of ``QUANT_MODES``.  parts: a
    tuple of subtree names or a ``QUANT_PART_GROUPS`` key; subtrees not
    named are passed through as the same objects."""
    if not mode or mode == "none":
        return stacked
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r} "
                         f"(want one of {QUANT_MODES})")
    if isinstance(parts, str):
        if parts not in QUANT_PART_GROUPS:
            raise ValueError(f"unknown parts group {parts!r} "
                             f"(want one of {tuple(QUANT_PART_GROUPS)})")
        parts = QUANT_PART_GROUPS[parts]
    unknown = set(parts) - set(SERVING_QUANT_PARTS)
    if unknown:
        raise ValueError(f"unknown stacked subtrees {sorted(unknown)} "
                         f"(want among {SERVING_QUANT_PARTS})")
    out = dict(stacked)
    for k in parts:
        if k in out:
            out[k] = quantize_tree(out[k], scale_key=_SCALE_KEY[mode])
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
