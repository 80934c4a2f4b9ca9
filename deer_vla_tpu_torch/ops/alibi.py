"""ALiBi, causal and padding attention bias for the MPT decoder.

Same layout and slope schedule as the JAX package's ``ops/alibi.py``
(llm-foundry ``gen_slopes``): per-key bias ``(j - S + 1) * slope_h``, causal
triangle and key padding as a finite -1e9.  Under tensor parallelism a rank
attends over its own heads only (``heads``, a range of the whole H): it
takes its slice of the whole H's slopes, never ``alibi_slopes(H / tp)``,
which interleaves otherwise when H is not a power of two.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def alibi_slopes(n_heads: int, alibi_bias_max: float = 8.0) -> np.ndarray:
    """slopes_i = 2^(-alibi_bias_max * i / ceilpow2(H)), interleaved for a
    head count that is not a power of two."""
    _n = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, _n + 1, dtype=np.float32) * (alibi_bias_max / _n)
    slopes = 1.0 / np.power(2.0, m)
    if _n != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.astype(np.float32)


def alibi_bias(n_heads: int, seq_len: int, alibi_bias_max: float = 8.0,
               dtype=torch.float32, device="cpu",
               heads: Optional[range] = None) -> torch.Tensor:
    """(1, H, 1, S) per-key bias (<= 0); (1, len(heads), 1, S) for the
    heads of ``heads``."""
    slopes = alibi_slopes(n_heads, alibi_bias_max)
    if heads is not None:
        slopes = slopes[heads.start:heads.stop]
    slopes = torch.from_numpy(np.ascontiguousarray(slopes)).to(device)
    pos = torch.arange(1 - seq_len, 1, dtype=torch.float32, device=device)
    bias = pos[None, :] * slopes[:, None]
    return bias[None, :, None, :].to(dtype)


def causal_padding_bias(attention_mask: torch.Tensor, seq_len: int,
                        dtype=torch.float32, neg: float = -1e9
                        ) -> torch.Tensor:
    """(B, 1, S, S): 0 where the causal triangle and the key mask allow,
    ``neg`` elsewhere."""
    dev = attention_mask.device
    causal = torch.ones(seq_len, seq_len, dtype=torch.bool, device=dev).tril()
    allowed = causal[None] & attention_mask[:, None, :].bool()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(allowed, zero, neg).to(dtype)[:, None]


def full_attn_bias(attention_mask: torch.Tensor, n_heads: int, seq_len: int,
                   alibi_bias_max: float = 8.0, dtype=torch.float32,
                   heads: Optional[range] = None) -> torch.Tensor:
    """(B, H, S, S) = alibi + causal + padding, summed in ``dtype``; H is
    ``len(heads)`` for the heads of ``heads``."""
    return (alibi_bias(n_heads, seq_len, alibi_bias_max, dtype,
                       attention_mask.device, heads)
            + causal_padding_bias(attention_mask, seq_len, dtype))
