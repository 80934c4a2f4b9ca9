"""Primitive layers as plain functions over dicts of tensors.

Parameters keep the JAX package's (in, out) linear layout, so ``linear`` is
``x @ w`` and a bridged tree needs no transposes.  LayerNorm statistics are
always fp32 and the output comes back in the input dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.ops.quant import fp32_reciprocal, unpack_nibbles


# ---------------------------------------------------------------------------
# tree helpers (nested dicts / lists / tuples of tensors; None kept)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over matching nested dict/list/tuple trees.
    ``None`` passes through unchanged."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in the tree's own order; a path holds the dict keys
    and list indices down to the leaf.  ``None`` leaves are skipped, as
    JAX's tree utilities skip them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in tree_leaves_with_path(v, prefix + (k,))]


def tree_map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """``tree_map`` whose ``fn`` also takes the leaf's path first."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, prefix + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(prefix, tree)


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of the same path: ``['decoder']['xattn'][0]``.
    The optimizer's name rules match substrings of it."""
    return "".join(f"[{k!r}]" for k in path)


def flat_key(path: tuple) -> str:
    """The checkpoint key of a leaf: ``decoder/xattn/0/to_q/w``."""
    return "/".join(str(k) for k in path)


# ---------------------------------------------------------------------------
# initializers (seeded torch.Generator; same distributions as the JAX init)
# ---------------------------------------------------------------------------


def trunc_normal(shape, std: float, gen: torch.Generator,
                 device, dtype=torch.float32) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by inverse CDF."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
    return (torch.erfinv(2 * u - 1) * (math.sqrt(2) * std)).to(dtype)


def uniform(shape, bound: float, gen: torch.Generator, device,
            dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return ((2 * u - 1) * bound).to(dtype)


def normal(shape, std: float, gen: torch.Generator, device,
           dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_linear(gen, in_dim: int, out_dim: int, bias: bool = True,
                device="cpu", dtype=torch.float32, init: str = "torch") -> dict:
    if init == "torch":  # kaiming_uniform(a=sqrt(5)) on (in, out) weights
        w = uniform((in_dim, out_dim), 1.0 / math.sqrt(in_dim), gen, device,
                    dtype)
    elif init == "normal02":
        w = trunc_normal((in_dim, out_dim), 0.02, gen, device, dtype)
    else:
        raise ValueError(f"unknown init {init!r}")
    p = {"w": w}
    if bias:
        p["b"] = uniform((out_dim,), 1.0 / math.sqrt(in_dim), gen, device,
                         dtype)
    return p


def init_layernorm(dim: int, bias: bool = True, device="cpu",
                   dtype=torch.float32) -> dict:
    p = {"scale": torch.ones(dim, device=device, dtype=dtype)}
    if bias:
        p["bias"] = torch.zeros(dim, device=device, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def int8_rows(x: torch.Tensor):
    """Dynamic symmetric per-row int8 activations: (xi int8, sx fp32
    (..., 1)), with the scale computed as ``quant.quantize_weight`` does."""
    x32 = x.float()
    sx = torch.clamp(x32.abs().amax(-1, keepdim=True) * fp32_reciprocal(127),
                     min=1e-12)
    return torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8), sx


# torch._int_mm on the card needs M > 16; on an H100 cuBLASLt also refused
# M = 17 with a row-major (K, N) second operand and took M = 32 and 514
_INT_MM_MIN_ROWS = 32


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (..., K) @ int8 (K, N) -> int32 (..., N) through
    ``torch._int_mm``.  On the card its rules are met by padding fewer than
    32 rows with zeros and passing contiguous operands; K or N not a
    multiple of 8 raises there."""
    k, n = b.shape
    lead = a.shape[:-1]
    a2 = a.reshape(-1, k).contiguous()
    m = a2.shape[0]
    if a2.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 matmul on the card needs K and N "
                             f"multiples of 8, got K={k} N={n}")
        if m < _INT_MM_MIN_ROWS:
            a2 = torch.cat([a2, a2.new_zeros(_INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(a2, b.contiguous())[:m].reshape(*lead, n)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x.dtype (+ bias), for a float weight ``w`` or one of the
    quantized layouts of ``ops.quant`` (the JAX package's math for each):

      ``q``/``s``    ``(x @ q) * s``, both in x.dtype;
      ``q4``/``s4``  two products against the x halves, then ``* s4``;
      ``q``/``s8``   int8 activations per row, int8 x int8 -> int32,
                     rescaled in fp32 by ``sx * s8``;
      ``q4``/``s48`` the same as two int32 products over the halves.
    """
    if "s8" in p:
        xi, sx = int8_rows(x)
        y = (int8_matmul(xi, p["q"]).float() * sx
             * p["s8"].float()).to(x.dtype)
    elif "s48" in p:
        kp = p["q4"].shape[-2]
        xi, sx = int8_rows(x)
        lo, hi = unpack_nibbles(p["q4"])
        acc = (int8_matmul(xi[..., :kp], lo.to(torch.int8))
               + int8_matmul(xi[..., kp:], hi.to(torch.int8)))
        y = (acc.float() * sx * p["s48"].float()).to(x.dtype)
    elif "q4" in p:
        kp = p["q4"].shape[-2]
        lo, hi = unpack_nibbles(p["q4"])
        y = ((x[..., :kp] @ lo.to(x.dtype) + x[..., kp:] @ hi.to(x.dtype))
             * p["s4"].to(x.dtype))
    elif "q" in p:
        y = (x @ p["q"].to(x.dtype)) * p["s"].to(x.dtype)
    else:
        y = x @ p["w"].to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(x.dtype)
    return y


def layernorm(p: Optional[dict], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output in the input dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].float()
        if p.get("bias") is not None:
            y = y + p["bias"].float()
    return y.to(x.dtype)


def embedding(p: dict, ids: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Row gather; the cast happens after the gather (elementwise, so the
    result equals casting the table first)."""
    y = p["w"][ids]
    return y.to(compute_dtype) if compute_dtype is not None else y


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU()'s default."""
    return F.gelu(x)


# ---------------------------------------------------------------------------
# layer stacking
# ---------------------------------------------------------------------------


def stack_layer_tree(layers: Sequence, dtype: Optional[torch.dtype] = None):
    """List of per-layer param dicts -> one tree with a leading L dim.

    ``dtype`` pre-casts the matmul weights (per-layer ndim >= 2) to the
    compute dtype.  1-D leaves (LayerNorm scales, biases, gates) keep their
    own dtype, because ``layernorm`` reads them in fp32."""
    def stack(*xs):
        s = torch.stack(xs)
        if dtype is not None and xs[0].ndim >= 2 and s.is_floating_point():
            s = s.to(dtype)
        return s

    return tree_map(stack, layers[0], *layers[1:])


def layer_slice(stacked, i: int):
    """Per-layer views of a stacked (L, ...) tree at a host index (no
    copies)."""
    return tree_map(lambda s: s[i], stacked)
