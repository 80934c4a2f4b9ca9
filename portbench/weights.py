"""Seeded random weights in the port's parameter-tree layout, made on the
device from ``--seed``.

One ``torch.randn`` call over a flat fp32 buffer draws every weight; each
leaf is then its slice, scaled to the spread the port's own init gives it
(``models/*.init_*``: uniform(+-1/sqrt(fan_in)) linears, 0.02 for the MPT
products and the token table, ones and zeros for LayerNorm), and copied
out, so that the program can keep single leaves without holding the whole
buffer.  The gated cross-attention's two gates are drawn as N(0, 0.5^2)
(the init leaves them at zero, which would make every exit delta depend on
the text alone); the program stacks them from this tree, so the raw and the
stacked trees hold the same gates.

The same seed gives the same tree, bit for bit, so the reference draws it
again after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

GATE_STD = 0.5


def _lin(spec: list, path: tuple, d_in: int, d_out: int, bias: bool,
         std: float) -> dict:
    out = {"w": len(spec)}
    spec.append((path + ("w",), (d_in, d_out), std))
    if bias:
        out["b"] = len(spec)
        spec.append((path + ("b",), (d_out,), std))
    return out


def _ln(spec: list, path: tuple, dim: int, bias: bool = True) -> dict:
    out = {"scale": len(spec)}
    spec.append((path + ("scale",), (dim,), "ones"))
    if bias:
        out["bias"] = len(spec)
        spec.append((path + ("bias",), (dim,), "zeros"))
    return out


def _leaf(spec: list, path: tuple, shape: tuple, std) -> int:
    spec.append((path, shape, std))
    return len(spec) - 1


def _torch_std(d_in: int) -> float:
    """The spread of uniform(+-1/sqrt(d_in)), torch's Linear init."""
    return 1.0 / math.sqrt(3.0 * d_in)


def _head(spec: list, path: tuple, c: dict) -> dict:
    """An LSTM head whose actions depend on its input.  Drawn as torch
    inits them (uniform(+-1/sqrt(H)) and uniform(+-1/sqrt(fan_in))), four
    LSTM layers and a four-layer MLP pass on about 1e-4 of the input's
    variation: every exit's action is then its biases' (about 0.02, the
    same for every input) and a bf16 rounding decides the exit.  So the
    LSTM's weights are drawn at 1/sqrt(fan_in), the MLP's hidden layers at
    He's sqrt(2/fan_in) and its last layer at 12/sqrt(fan_in), the MLP's
    biases at zero: the actions then spread over a few tenths, as a
    trained head's do, neighbouring exits' actions differ by a share of
    that, and the LSTM stays out of the saturation that turns a rounding
    in its input into a different trajectory."""
    h = c["head"]
    hid = h["hidden_size"]
    layers = []
    for i in range(h["lstm_num_layers"]):
        d_in = h["in_features"] if i == 0 else hid
        p = path + ("rnn", "layers", i)
        std = _torch_std(hid)
        layers.append({"wi": _leaf(spec, p + ("wi",), (d_in, 4 * hid),
                                   1.0 / math.sqrt(d_in)),
                       "wh": _leaf(spec, p + ("wh",), (hid, 4 * hid),
                                   1.0 / math.sqrt(hid)),
                       "bi": _leaf(spec, p + ("bi",), (4 * hid,), std),
                       "bh": _leaf(spec, p + ("bh",), (4 * hid,), std)})
    dims = [hid] + list(h["mlp_hidden_dims"][:h["mlp_num_hidden_layers"]])

    def mlp(name, out_dim):
        d = dims + [out_dim]
        out = []
        for i in range(len(d) - 1):
            last = i == len(d) - 2
            std = (12.0 if last else math.sqrt(2.0)) / math.sqrt(d[i])
            out.append(_lin(spec, path + (name, "layers", i), d[i], d[i + 1],
                            True, std))
            spec[out[-1]["b"]] = spec[out[-1]["b"]][:2] + ("zeros",)
        return {"layers": out, "lns": [None] * (len(d) - 2)}

    return {"rnn": {"layers": layers},
            "actions": mlp("actions",
                           h["out_features"] * h["multi_step_action"]),
            "gripper": mlp("gripper", h["multi_step_action"])}


def layout(c: dict) -> Tuple[dict, List[tuple]]:
    """(tree of leaf numbers, [(path, shape, std or 'ones' / 'zeros')]) for
    the plain MPT model of config dict ``c`` with the deterministic LSTM
    head, as the port's ``models/flamingo.init_deer`` lays it out."""
    spec: list = []
    v, pc, m = c["vit"], c["perceiver"], c["mpt"]
    w = v["width"]
    patch_dim = 3 * v["patch_size"] ** 2
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    hidden = int(w * v["mlp_ratio"])
    vit = {"patch_embed": {"w": _leaf(spec, ("vit", "patch_embed", "w"),
                                      (patch_dim, w), 0.02)},
           "class_embedding": _leaf(spec, ("vit", "class_embedding"), (w,),
                                    w ** -0.5),
           "positional_embedding": _leaf(
               spec, ("vit", "positional_embedding"), (seq, w), w ** -0.5),
           "ln_pre": _ln(spec, ("vit", "ln_pre"), w),
           "ln_post": _ln(spec, ("vit", "ln_post"), w), "blocks": []}
    for i in range(v["layers"]):
        p = ("vit", "blocks", i)
        vit["blocks"].append({
            "ln_1": _ln(spec, p + ("ln_1",), w),
            "ln_2": _ln(spec, p + ("ln_2",), w),
            "qkv": _lin(spec, p + ("qkv",), w, 3 * w, True, _torch_std(w)),
            "out": _lin(spec, p + ("out",), w, w, True, _torch_std(w)),
            "mlp_fc": _lin(spec, p + ("mlp_fc",), w, hidden, True,
                           _torch_std(w)),
            "mlp_proj": _lin(spec, p + ("mlp_proj",), hidden, w, True,
                             _torch_std(hidden))})

    def ff(p, dim, mult):
        inner = dim * mult
        return {"ln": _ln(spec, p + ("ln",), dim),
                "fc1": _lin(spec, p + ("fc1",), dim, inner, False,
                            _torch_std(dim)),
                "fc2": _lin(spec, p + ("fc2",), inner, dim, False,
                            _torch_std(inner))}

    d = pc["dim"]
    inner = pc["dim_head"] * pc["heads"]
    per = {"latents": _leaf(spec, ("perceiver", "latents"),
                            (pc["num_latents"], d), 1.0),
           "norm": _ln(spec, ("perceiver", "norm"), d), "layers": []}
    for i in range(pc["depth"]):
        p = ("perceiver", "layers", i)
        per["layers"].append({
            "norm_media": _ln(spec, p + ("norm_media",), d),
            "norm_latents": _ln(spec, p + ("norm_latents",), d),
            "to_q": _lin(spec, p + ("to_q",), d, inner, False, _torch_std(d)),
            "to_kv": _lin(spec, p + ("to_kv",), d, 2 * inner, False,
                          _torch_std(d)),
            "to_out": _lin(spec, p + ("to_out",), inner, d, False,
                           _torch_std(inner)),
            "ff": ff(p + ("ff",), d, pc["ff_mult"])})

    dm = m["d_model"]
    bias = not m["no_bias"]
    dec = {"wte": {"w": _leaf(spec, ("decoder", "wte", "w"),
                              (m["vocab_size"], dm), 0.02)},
           "ln_f": _ln(spec, ("decoder", "ln_f"), dm, bias),
           "blocks": [], "xattn": []}
    xin = c["xattn_dim_head"] * c["xattn_heads"]
    for i in range(m["n_layers"]):
        p = ("decoder", "blocks", i)
        dec["blocks"].append({
            "ln_1": _ln(spec, p + ("ln_1",), dm, bias),
            "wqkv": _lin(spec, p + ("wqkv",), dm, 3 * dm, bias, 0.02),
            "out_proj": _lin(spec, p + ("out_proj",), dm, dm, bias, 0.02),
            "ln_2": _ln(spec, p + ("ln_2",), dm, bias),
            "mlp_up": _lin(spec, p + ("mlp_up",), dm, m["mlp_ratio"] * dm,
                           bias, 0.02),
            "mlp_down": _lin(spec, p + ("mlp_down",), m["mlp_ratio"] * dm,
                             dm, bias, 0.02)})
        if (i + 1) % c["cross_attn_every_n_layers"]:
            dec["xattn"].append(None)
            continue
        p = ("decoder", "xattn", i)
        vis = v["width"]
        dec["xattn"].append({
            "norm": _ln(spec, p + ("norm",), dm),
            "to_q": _lin(spec, p + ("to_q",), dm, xin, False, _torch_std(dm)),
            "to_kv": _lin(spec, p + ("to_kv",), vis, 2 * xin, False,
                          _torch_std(vis)),
            "to_out": _lin(spec, p + ("to_out",), xin, dm, False,
                           _torch_std(xin)),
            "attn_gate": _leaf(spec, p + ("attn_gate",), (1,), GATE_STD),
            "ff": ff(p + ("ff",), dm, c["xattn_ff_mult"]),
            "ff_gate": _leaf(spec, p + ("ff_gate",), (1,), GATE_STD)})
    tree = {"vit": vit, "perceiver": per, "decoder": dec,
            "lm_head": _head(spec, ("lm_head",), c),
            "extra_exit": _head(spec, ("extra_exit",), c),
            "lm_exits": {str(e): _head(spec, ("lm_exits", str(e)), c)
                         for e in exit_layer_ids(c)}}
    return tree, spec


def exit_layer_ids(c: dict) -> List[int]:
    """The internal exits (``DeerConfig.exit_layer_ids``)."""
    start = max(c["exit_interval"] - 1, 1)
    return list(range(start, c["mpt"]["n_layers"] - 1, c["exit_interval"]))


def _fill(tree, leaves: list):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _fill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, leaves) for v in tree]
    return leaves[tree]


def draw_params(c: dict, seed: int, device) -> dict:
    """The fp32 parameter tree of config dict ``c`` from ``seed``, drawn on
    ``device`` in one call."""
    tree, spec = layout(c)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    leaves = []
    off = 0
    for (_, shape, std), n in zip(spec, sizes):
        if std == "ones":
            leaves.append(torch.ones(shape, device=device))
        elif std == "zeros":
            leaves.append(torch.zeros(shape, device=device))
        else:
            leaves.append(flat[off:off + n].view(shape) * std)
        off += n
    del flat
    return _fill(tree, leaves)
