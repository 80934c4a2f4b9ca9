"""Multi-layer LSTM for the action heads: the full window (training and
calibration) and the single streaming step.

Same semantics as the JAX package's ``ops/lstm.py``: gate order
[i, f, g, o], bias ``bi + bh``, optional LayerNorm on each layer's output
(never on the carry).  Carry layout: (h, c), each (num_layers, B, H).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.layers import init_layernorm, layernorm, uniform

Carry = Tuple[torch.Tensor, torch.Tensor]


def init_lstm(gen, in_dim: int, hidden: int, num_layers: int,
              use_layernorm: bool = False, device="cpu",
              dtype=torch.float32) -> dict:
    """torch's nn.LSTM init: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / hidden ** 0.5
    layers = []
    for i in range(num_layers):
        d_in = in_dim if i == 0 else hidden
        layer = {"wi": uniform((d_in, 4 * hidden), bound, gen, device, dtype),
                 "wh": uniform((hidden, 4 * hidden), bound, gen, device, dtype),
                 "bi": uniform((4 * hidden,), bound, gen, device, dtype),
                 "bh": uniform((4 * hidden,), bound, gen, device, dtype)}
        if use_layernorm:
            layer["ln"] = init_layernorm(hidden, device=device, dtype=dtype)
        layers.append(layer)
    return {"layers": layers}


def zero_carry(num_layers: int, batch: int, hidden: int,
               dtype=torch.float32, device="cpu") -> Carry:
    z = torch.zeros(num_layers, batch, hidden, dtype=dtype, device=device)
    return (z, z)


def _cell_step(p: dict, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM cell step for a batch. x_t: (B, Din); h, c: (B, H)."""
    dt = x_t.dtype
    gates = (x_t @ p["wi"].to(dt) + h @ p["wh"].to(dt)
             + (p["bi"] + p["bh"]).to(dt))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_forward(params: dict, x: torch.Tensor,
                 carry: Optional[Carry] = None, *, dropout_rate: float = 0.0,
                 dropout: Optional[Dropout] = None
                 ) -> Tuple[torch.Tensor, Carry]:
    """The whole stack over a window.  x (B, T, Din) -> top layer's output
    (B, T, H) and the final carry; the carry starts at zeros when not
    given.  With ``dropout`` (training) and a rate > 0, each layer's output
    but the last's goes through it (after the layer's LayerNorm)."""
    layers = params["layers"]
    if carry is None:
        carry = zero_carry(len(layers), x.shape[0], layers[0]["wh"].shape[0],
                           x.dtype, x.device)
    h0, c0 = carry
    new_h, new_c = [], []
    for li, lp in enumerate(layers):
        h, c = h0[li].to(x.dtype), c0[li].to(x.dtype)
        ys = []
        for t in range(x.shape[1]):
            h, c = _cell_step(lp, x[:, t], h, c)
            ys.append(h)
        x = torch.stack(ys, dim=1)
        if "ln" in lp:
            x = layernorm(lp["ln"], x)
        if dropout is not None and dropout_rate > 0 and li < len(layers) - 1:
            x = dropout(x, dropout_rate)
        new_h.append(h)
        new_c.append(c)
    return x, (torch.stack(new_h), torch.stack(new_c))


def lstm_step(params: dict, x_t: torch.Tensor, carry: Carry
              ) -> Tuple[torch.Tensor, Carry]:
    """One streaming step: x_t (B, Din) -> (B, H), new carry."""
    h0, c0 = carry
    new_h, new_c = [], []
    x = x_t
    for li, lp in enumerate(params["layers"]):
        h2, c2 = _cell_step(lp, x, h0[li].to(x.dtype), c0[li].to(x.dtype))
        x = h2
        if "ln" in lp:
            x = layernorm(lp["ln"], x)
        new_h.append(h2)
        new_c.append(c2)
    return x, (torch.stack(new_h), torch.stack(new_c))
