"""Llama decoder block: the BCFlamingo LM substrate (the port of the JAX
package's ``models/llama.py``).

The reference picks BCFlamingo when the LM is a llama
(robot_flamingo/models/factory.py:161-162, flamingo_bc.py:10-531).  Block:
RMSNorm -> RoPE attention -> residual -> RMSNorm -> SwiGLU MLP -> residual,
no biases.  RoPE rotates INTERLEAVED pairs (x0, x1), (x2, x3), ... (not the
half-split layout of Hugging Face's llama), with the cos / sin tables cast
to the activations' dtype before the rotation, as the JAX package does.
Every product goes through ``ops.layers.linear``, so a quantized block
(``ops.quant``) serves unchanged; none of K2-K4 runs here (they implement
the MPT block's four products), and the 32 text rows take the plain
attention (``ops.attention.dot_attention``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.core.config import MPTConfig
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.layers import init_linear, linear


def init_rmsnorm(dim: int, device="cpu", dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, device=device, dtype=dtype)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics, output in the input dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float = 10000.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (S, D/2) cos and sin of position x frequency."""
    exps = torch.arange(0, head_dim, 2, device=device,
                        dtype=torch.float32) / head_dim
    inv = 1.0 / (theta ** exps)
    t = torch.arange(seq_len, device=device,
                     dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cos(t), torch.sin(t)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D): rotate the pairs (x[2j], x[2j+1]) by position."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[None, None].to(x.dtype)
    s = sin[None, None].to(x.dtype)
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def ffn_width(d: int) -> int:
    """The SwiGLU width: int(d * 8 / 3) rounded up to 256 (11008 at 4096)."""
    inner = int(d * 8 / 3)
    return 256 * ((inner + 255) // 256)


def init_llama_block(gen, cfg: MPTConfig, device="cpu",
                     dtype=torch.float32) -> dict:
    d = cfg.d_model
    inner = ffn_width(d)

    def lin(i, o):
        return init_linear(gen, i, o, False, device, dtype, init="normal02")

    return {"attn_norm": init_rmsnorm(d, device, dtype),
            "wq": lin(d, d), "wk": lin(d, d), "wv": lin(d, d),
            "wo": lin(d, d),
            "mlp_norm": init_rmsnorm(d, device, dtype),
            "w_gate": lin(d, inner), "w_up": lin(d, inner),
            "w_down": lin(inner, d)}


def llama_block_forward(p: dict, x: torch.Tensor, attn_bias: torch.Tensor,
                        cfg: MPTConfig,
                        rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None) -> torch.Tensor:
    """One block over (B, S, D); ``rope`` is ``rope_tables`` of S (built
    here when not given)."""
    h = rmsnorm(p["attn_norm"], x)
    q = split_heads(linear(p["wq"], h), cfg.n_heads)
    k = split_heads(linear(p["wk"], h), cfg.n_heads)
    v = split_heads(linear(p["wv"], h), cfg.n_heads)
    if rope is None:
        rope = rope_tables(x.shape[1], cfg.head_dim, device=x.device)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)
    attn = merge_heads(dot_attention(q, k, v, bias=attn_bias,
                                     scale=cfg.head_dim ** -0.5))
    x = x + linear(p["wo"], attn)
    h = rmsnorm(p["mlp_norm"], x)
    h = linear(p["w_down"],
               F.silu(linear(p["w_gate"], h)) * linear(p["w_up"], h))
    return x + h
