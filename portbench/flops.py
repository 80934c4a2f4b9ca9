"""Model FLOPs of the DeeR policy, from the configuration alone.

A copy of the program's ``eval/flops.py`` arithmetic (multiply-accumulates
x 2, thop's convention for a linear layer), kept here so that the
benchmark's yardstick cannot move with the program, with one correction:
``train_step_flops`` charges the frozen ViT its forward only.  The ViT runs
under ``no_grad`` in training (``models/flamingo.vision_tokens``) and has
no backward, so counting 3 x its forward, as the program's copy does,
overstates a joint step's work by about 2 x the ViT's forward.
"""

from __future__ import annotations

from typing import Dict


def linear_flops(tokens: int, d_in: int, d_out: int) -> int:
    return 2 * tokens * d_in * d_out


def attention_flops(tokens_q: int, tokens_kv: int, dim: int,
                    inner: int) -> int:
    """q / k / v / out projections, then QK^T and PV."""
    proj = (linear_flops(tokens_q, dim, inner)
            + 2 * linear_flops(tokens_kv, dim, inner)
            + linear_flops(tokens_q, inner, dim))
    return proj + 2 * tokens_q * tokens_kv * inner * 2


def vit_flops(cfg) -> int:
    v = cfg.vit
    if v.tome_r:
        raise ValueError("the ToMe-merged tower is not counted here")
    d = v.width
    inner = int(d * v.mlp_ratio)
    s = v.num_patches + 1
    per_layer = (attention_flops(s, s, d, d) + linear_flops(s, d, inner)
                 + linear_flops(s, inner, d))
    return linear_flops(v.num_patches, 3 * v.patch_size ** 2, d) \
        + v.layers * per_layer


def perceiver_flops(cfg) -> int:
    p = cfg.perceiver
    n, v, d, inner = p.num_latents, cfg.vit.num_patches, p.dim, p.inner_dim
    per_layer = (linear_flops(n, d, inner) + linear_flops(v + n, d, 2 * inner)
                 + 2 * 2 * n * (v + n) * inner + linear_flops(n, inner, d)
                 + linear_flops(n, d, d * p.ff_mult) * 2)
    return p.depth * per_layer


def vision_flops(cfg) -> int:
    """Both cameras' ViT and perceiver for one frame."""
    return 2 * (vit_flops(cfg) + perceiver_flops(cfg))


def mpt_layer_flops(cfg) -> int:
    s, d = cfg.text_len, cfg.mpt.d_model
    return (linear_flops(s, d, 3 * d) + linear_flops(s, d, d)
            + 2 * 2 * s * s * d + linear_flops(s, d, cfg.mpt.mlp_ratio * d)
            + linear_flops(s, cfg.mpt.mlp_ratio * d, d))


def xattn_layer_flops(cfg) -> int:
    s, d = cfg.text_len, cfg.lang_dim
    m = cfg.num_media_tokens
    inner = cfg.xattn_dim_head * cfg.xattn_heads
    return (linear_flops(s, d, inner) + linear_flops(m, cfg.vis_dim, 2 * inner)
            + 2 * 2 * s * m * inner + linear_flops(s, inner, d)
            + linear_flops(s, d, d * cfg.xattn_ff_mult) * 2)


def decoder_flops_to(cfg, exit_layer: int) -> int:
    """Layers 0 .. exit_layer, cross-attention included."""
    per, px = mpt_layer_flops(cfg), xattn_layer_flops(cfg)
    return sum(per + (px if cfg.has_xattn(i) else 0)
               for i in range(exit_layer + 1))


def head_flops(cfg) -> int:
    """One LSTM head step: the LSTM and both MLPs."""
    h = cfg.head
    lstm, d_in = 0, h.in_features
    for _ in range(h.lstm_num_layers):
        lstm += 2 * (d_in + h.hidden_size) * 4 * h.hidden_size
        d_in = h.hidden_size
    dims = ((h.hidden_size,)
            + tuple(h.mlp_hidden_dims[:h.mlp_num_hidden_layers]))
    mlp = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return lstm + 2 * mlp + 2 * dims[-1] * (h.out_features + 1)


def served_step_flops(cfg, exits) -> Dict[int, int]:
    """{exit layer: FLOPs of one stream's step that exits there}: vision,
    the decoder up to that exit, and a head step at every exit checked up
    to it plus the first exit's pseudo action."""
    out = {}
    for k, e in enumerate(exits):
        out[e] = (vision_flops(cfg) + decoder_flops_to(cfg, e)
                  + (k + 2) * head_flops(cfg))
    return out


def train_step_flops(cfg) -> int:
    """FLOPs of one trajectory (W frames) of a joint train step: the
    frozen ViT's forward once; the perceiver, the decoder and the heads
    (final, one a internal exit, the two random-exit samplings) forward
    and backward, 3 x their forward.  Remat is not counted."""
    w = cfg.window_size
    vit = 2 * vit_flops(cfg)
    rest = (2 * perceiver_flops(cfg) + decoder_flops_to(cfg, cfg.n_layers - 1)
            + (3 + len(cfg.exit_layer_ids())) * head_flops(cfg))
    return w * (vit + 3 * rest)
