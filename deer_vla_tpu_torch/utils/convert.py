"""Reference checkpoints -> the parameter tree (a copy of the JAX package's
``utils/convert.py``, which the port does not import).

The reference's eval composes two torch checkpoints (eval_calvin.py:543-577):
the OpenFlamingo base (open_clip ViT + MPT + perceiver + gated x-attn, full
model) loaded non-strict, then the DeeR delta (trainable-only state dict,
train_utils.py:631-638).  This module maps their state-dict names onto the
tree of numpy fp32 arrays in the JAX package's key layout, which
``bridge.to_torch`` carries to a device.

Name mapping (torch name -> ours):
  vision_encoder.visual.conv1.weight          vit.patch_embed.w  (reshape.T)
  vision_encoder.visual.class_embedding       vit.class_embedding
  vision_encoder.visual.positional_embedding  vit.positional_embedding
  ...transformer.resblocks.N.{ln_1,ln_2,attn.in_proj_*,attn.out_proj,mlp.c_fc,mlp.c_proj}
  perceiver.latents / layers.N.{0,1} ...      perceiver.*
  lang_encoder.transformer.wte.weight         decoder.wte.w
  lang_encoder.transformer.blocks.N.*         decoder.blocks.N.*  (FlamingoLayer
      wraps: gated_cross_attn_layer.* -> decoder.xattn.N.*,
             decoder_layer.* -> decoder.blocks.N.*)
  lm_head / lm_exit_modules.K / extra_exit    heads (DeterministicDecoder)

Torch Linear weights are (out, in) -> transposed to our (in, out).

The card's machine has no ``safetensors`` package: ``read_safetensors``
parses the format itself (an 8-byte little-endian header length, a JSON
header of dtype / shape / data_offsets, little-endian data).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict

import numpy as np
import torch


def _t(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    return a.T if a.ndim == 2 else a


def _ln(sd, prefix) -> dict:
    p = {"scale": np.asarray(sd[prefix + ".weight"], np.float32)}
    if prefix + ".bias" in sd:
        p["bias"] = np.asarray(sd[prefix + ".bias"], np.float32)
    return p


def _linear(sd, prefix) -> dict:
    p = {"w": _t(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        p["b"] = np.asarray(sd[prefix + ".bias"], np.float32)
    return p


def convert_vit(sd: Dict[str, np.ndarray], params: dict,
                prefix: str = "vision_encoder.visual.") -> int:
    """open_clip VisionTransformer state dict -> params['vit']; returns the
    number of tensors written."""
    n = 0
    vit = params["vit"]
    if prefix + "conv1.weight" in sd:
        w = np.asarray(sd[prefix + "conv1.weight"], np.float32)  # (width,3,p,p)
        vit["patch_embed"]["w"] = w.reshape(w.shape[0], -1).T
        n += 1
    for name, key in [("class_embedding", "class_embedding"),
                      ("positional_embedding", "positional_embedding")]:
        if prefix + name in sd:
            vit[key] = np.asarray(sd[prefix + name], np.float32)
            n += 1
    for ours, theirs in [("ln_pre", "ln_pre"), ("ln_post", "ln_post")]:
        if prefix + theirs + ".weight" in sd:
            vit[ours] = _ln(sd, prefix + theirs)
            n += 1
    i = 0
    while f"{prefix}transformer.resblocks.{i}.ln_1.weight" in sd:
        if i >= len(vit["blocks"]):
            break
        b = vit["blocks"][i]
        rb = f"{prefix}transformer.resblocks.{i}."
        b["ln_1"] = _ln(sd, rb + "ln_1")
        b["ln_2"] = _ln(sd, rb + "ln_2")
        b["qkv"] = {"w": _t(sd[rb + "attn.in_proj_weight"]),
                    "b": np.asarray(sd[rb + "attn.in_proj_bias"], np.float32)}
        b["out"] = _linear(sd, rb + "attn.out_proj")
        b["mlp_fc"] = _linear(sd, rb + "mlp.c_fc")
        b["mlp_proj"] = _linear(sd, rb + "mlp.c_proj")
        n += 6
        i += 1
    return n


def convert_perceiver(sd: Dict[str, np.ndarray], tree: dict,
                      prefix: str = "perceiver.") -> int:
    n = 0
    if prefix + "latents" in sd:
        tree["latents"] = np.asarray(sd[prefix + "latents"], np.float32)
        n += 1
    if prefix + "norm.weight" in sd:
        tree["norm"] = _ln(sd, prefix + "norm")
        n += 1
    for i, layer in enumerate(tree["layers"]):
        # helpers.py PerceiverResampler layers.N is ModuleList[attn, ff];
        # ff Sequential = [LayerNorm, Linear, GELU, Linear]
        a = f"{prefix}layers.{i}.0."
        f = f"{prefix}layers.{i}.1."
        if a + "to_q.weight" not in sd:
            continue
        layer["norm_media"] = _ln(sd, a + "norm_media")
        layer["norm_latents"] = _ln(sd, a + "norm_latents")
        layer["to_q"] = _linear(sd, a + "to_q")
        layer["to_kv"] = _linear(sd, a + "to_kv")
        layer["to_out"] = _linear(sd, a + "to_out")
        layer["ff"] = {"ln": _ln(sd, f + "0"),
                       "fc1": _linear(sd, f + "1"),
                       "fc2": _linear(sd, f + "3")}
        n += 6
    return n


def convert_gated_xattn(sd: Dict[str, np.ndarray], tree: dict, prefix: str) -> int:
    n = 0
    a = prefix + "attn."
    tree["norm"] = _ln(sd, a + "norm")
    tree["to_q"] = _linear(sd, a + "to_q")
    tree["to_kv"] = _linear(sd, a + "to_kv")
    tree["to_out"] = _linear(sd, a + "to_out")
    tree["attn_gate"] = np.asarray(sd[prefix + "attn_gate"], np.float32)
    tree["ff"] = {"ln": _ln(sd, prefix + "ff.0"),
                  "fc1": _linear(sd, prefix + "ff.1"),
                  "fc2": _linear(sd, prefix + "ff.3")}
    tree["ff_gate"] = np.asarray(sd[prefix + "ff_gate"], np.float32)
    return n + 8


def convert_mpt_block(sd: Dict[str, np.ndarray], tree: dict, prefix: str) -> int:
    """MPT-1B block names: ln_1, attn.Wqkv, attn.out_proj, ln_2,
    mlp.mlp_up, mlp.mlp_down (7B uses ffn.up_proj/down_proj, norm_1/norm_2,
    handled via alternates).  qk_ln configs add attn.q_ln / attn.k_ln
    LayerNorms (mosaic MPT attention; only written when our tree was built
    with cfg.qk_ln)."""
    alt = {
        "ln_1": ["ln_1", "norm_1"], "ln_2": ["ln_2", "norm_2"],
        "wqkv": ["attn.Wqkv"], "out_proj": ["attn.out_proj"],
        "mlp_up": ["mlp.mlp_up", "ffn.up_proj"],
        "mlp_down": ["mlp.mlp_down", "ffn.down_proj"],
    }
    n = 0
    for ours, cands in alt.items():
        for c in cands:
            full = prefix + c
            if full + ".weight" in sd:
                if ours.startswith("ln"):
                    tree[ours] = _ln(sd, full)
                else:
                    tree[ours] = _linear(sd, full)
                n += 1
                break
    for ours, theirs in [("q_ln", "attn.q_ln"), ("k_ln", "attn.k_ln")]:
        if prefix + theirs + ".weight" in sd and ours in tree:
            tree[ours] = _ln(sd, prefix + theirs)
            n += 1
    return n


def convert_head(sd: Dict[str, np.ndarray], tree: dict, prefix: str) -> int:
    """DeterministicDecoder state dict -> head params.

    torch LSTM: weight_ih_l{k} (4H, in) -> rnn.layers[k].wi (in, 4H) etc.
    MLPTanhHead/MLPSigmoidHead Sequential indices depend on dropout_mode;
    we locate Linear layers by scanning numeric indices in order.
    """
    n = 0
    # LSTM (plain nn.LSTM; LayerNormLSTM names layers.{3k}.*)
    for k, lp in enumerate(tree["rnn"]["layers"]):
        if f"{prefix}rnn.weight_ih_l{k}" in sd:
            lp["wi"] = _t(sd[f"{prefix}rnn.weight_ih_l{k}"])
            lp["wh"] = _t(sd[f"{prefix}rnn.weight_hh_l{k}"])
            lp["bi"] = np.asarray(sd[f"{prefix}rnn.bias_ih_l{k}"], np.float32)
            lp["bh"] = np.asarray(sd[f"{prefix}rnn.bias_hh_l{k}"], np.float32)
            n += 4
        elif f"{prefix}rnn.layers.{3 * k}.weight_ih_l0" in sd:
            base = f"{prefix}rnn.layers.{3 * k}."
            lp["wi"] = _t(sd[base + "weight_ih_l0"])
            lp["wh"] = _t(sd[base + "weight_hh_l0"])
            lp["bi"] = np.asarray(sd[base + "bias_ih_l0"], np.float32)
            lp["bh"] = np.asarray(sd[base + "bias_hh_l0"], np.float32)
            lp["ln"] = _ln(sd, f"{prefix}rnn.layers.{3 * k + 1}")
            n += 5
    # MLP heads: collect Linear weights in Sequential order
    for ours, theirs in [("actions", "actions.mlp"), ("gripper", "gripper.mlp")]:
        idxs = sorted({int(m.group(1)) for k in sd
                       for m in [re.match(rf"^{re.escape(prefix + theirs)}\.(\d+)\.weight$", k)]
                       if m})
        for j, idx in enumerate(idxs):
            if j < len(tree[ours]["layers"]):
                tree[ours]["layers"][j] = _linear(sd, f"{prefix}{theirs}.{idx}")
                n += 1
    for ours, theirs in [("embed_arm_state", "embed_arm_state.0"),
                         ("embed_state", "embed_state")]:
        if prefix + theirs + ".weight" in sd and ours in tree:
            tree[ours] = _linear(sd, prefix + theirs)
            n += 1
    if prefix + "embed_gripper_state.0.weight" in sd and "embed_gripper_state" in tree:
        tree["embed_gripper_state"] = {
            "w": np.asarray(sd[prefix + "embed_gripper_state.0.weight"], np.float32)}
        n += 1
    return n


def convert_state_dict(sd: Dict[str, np.ndarray], params: dict,
                       cfg) -> Dict[str, int]:
    """Full MPTFlamingo state dict -> our param tree (in place); returns
    per-component tensor counts for audit."""
    counts = {}
    # the ViT arrives either inside a composed checkpoint
    # (vision_encoder.visual.*) or as a raw open_clip checkpoint (visual.*,
    # factory.py:109-113 downloads it separately)
    vit_prefix = "vision_encoder.visual."
    if vit_prefix + "conv1.weight" not in sd and "visual.conv1.weight" in sd:
        vit_prefix = "visual."
    counts["vit"] = convert_vit(sd, params, prefix=vit_prefix)
    counts["perceiver"] = convert_perceiver(sd, params["perceiver"])
    if "perceiver_gripper" in params:
        counts["perceiver_gripper"] = convert_perceiver(
            sd, params["perceiver_gripper"], "perceiver_gripper.")

    # wte: lang_encoder.transformer.wte.weight in composed checkpoints,
    # transformer.wte.weight in a raw HF MPT backbone state dict
    for key in ("lang_encoder.transformer.wte.weight",
                "transformer.wte.weight"):
        if key in sd:
            w = np.asarray(sd[key], np.float32)
            ours = params["decoder"]["wte"]["w"]
            m = min(w.shape[0], ours.shape[0])
            new = np.array(ours)
            new[:m] = w[:m]
            params["decoder"]["wte"]["w"] = new
            counts["wte"] = 1
            break

    # decoder layers: after init_flamingo the blocks live under
    # lang_encoder.transformer.blocks.N.decoder_layer.* with x-attn at
    # lang_encoder.transformer.blocks.N.gated_cross_attn_layer.*; the raw
    # (pre-mixin) MPT ckpt has them directly at transformer.blocks.N.*
    nb = nx = 0
    for i in range(cfg.n_layers):
        for base in (f"lang_encoder.transformer.blocks.{i}.decoder_layer.",
                     f"transformer.blocks.{i}.",
                     f"lang_encoder.transformer.blocks.{i}."):
            if any(k.startswith(base + "attn") or k.startswith(base + "ln_1")
                   or k.startswith(base + "norm_1") for k in sd):
                nb += convert_mpt_block(sd, params["decoder"]["blocks"][i], base)
                break
        xb = f"lang_encoder.transformer.blocks.{i}.gated_cross_attn_layer."
        xb2 = f"lang_encoder.gated_cross_attn_layers.{i}."
        for base in (xb, xb2):
            if base + "attn_gate" in sd and params["decoder"]["xattn"][i] is not None:
                nx += convert_gated_xattn(sd, params["decoder"]["xattn"][i], base)
                break
    counts["mpt_blocks"] = nb
    counts["xattn"] = nx

    # final LayerNorm: MPT-1B transformer.ln_f, llm-foundry 7B norm_f
    # (mosaic_gpt_3b.py:108-110); consumed for the VL lm_logits path
    for base in ("lang_encoder.transformer.", "transformer."):
        for name in ("ln_f", "norm_f"):
            if base + name + ".weight" in sd:
                params["decoder"]["ln_f"] = _ln(sd, base + name)
                counts["ln_f"] = 1
                break
        if counts.get("ln_f"):
            break

    counts["lm_head"] = convert_head(sd, params["lm_head"], "lm_head.")
    counts["extra_exit"] = convert_head(sd, params["extra_exit"], "extra_exit.")
    for j, layer_id in enumerate(cfg.exit_layer_ids()):
        counts[f"exit_{layer_id}"] = convert_head(
            sd, params["lm_exits"][str(layer_id)], f"lm_exit_modules.{j}.")
    return counts


# Keys legitimately present in the composed reference state dict that the
# robot policy never uses — the converter deliberately skips them.  Everything
# else left unconsumed is a naming-drift bug (tests/test_convert_coverage.py).
IGNORED_KEY_PATTERNS = [
    # open_clip CLIP text tower + contrastive glue: the policy uses only the
    # visual tower (factory.py:109-114 keeps the whole CLIP module, frozen)
    r"^vision_encoder\.(?!visual\.)",
    # visual.proj / pooled-path ln_post feed the CLIP embedding, not the
    # token features Flamingo consumes (output_tokens=True, factory.py:114)
    r"^vision_encoder\.visual\.proj$",
    # the same glue in a RAW open_clip checkpoint (no vision_encoder. prefix)
    r"^visual\.proj$",
    r"^(token_embedding|ln_final|text_projection|positional_embedding"
    r"|attn_mask|transformer\.resblocks)(\.|$)",
    # HF buffers that show up in torch state dicts
    r"rotary_emb\.inv_freq$",
    # raw HF MPT extras: learned positions (alibi models don't load one) and
    # tied-embedding lm_head mirrors
    r"^transformer\.wpe\.weight$",
    r"^lm_head_embedding\.weight$",
    # MosaicGPT optional logit temperature (mosaic_gpt_3b.py:112-118)
    r"logit_scale$",
]


class _TrackingDict(dict):
    """dict that records which keys were read via __getitem__."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


_BLOCK_INDEX_RE = re.compile(
    r"^(?:lang_encoder\.)?(?:transformer\.blocks|gated_cross_attn_layers)"
    r"\.(\d+)\.")


def convert_with_audit(sd: Dict[str, np.ndarray], params: dict, cfg):
    """convert_state_dict + name-coverage audit (VERDICT r2 item 6).

    Returns (counts, report) where report = {consumed, ignored, truncated,
    unconsumed} key sets.  `unconsumed` non-empty means the reference renamed
    something the converter doesn't know about — fail loudly before real
    artifacts produce silently-random weights.

    Decoder blocks/x-attn at index >= cfg.n_layers are expected extras, not
    drift: the reference DELETES those layers before loading the full-depth
    base checkpoint with strict=False (eval_calvin.py:543-577 via the
    early-exit truncation, mosaic_gpt_3b early_exit_layer), so a 24-layer
    OpenFlamingo base composed into a max_layer=12 DeeR model legitimately
    carries 12 layers of unloadable keys."""
    tracked = _TrackingDict(sd)
    counts = convert_state_dict(tracked, params, cfg)
    ignored = {k for k in tracked
               if any(re.search(p, k) for p in IGNORED_KEY_PATTERNS)}
    truncated = set()
    for k in tracked:
        m = _BLOCK_INDEX_RE.match(k)
        if m and int(m.group(1)) >= cfg.n_layers:
            truncated.add(k)
    unconsumed = set(tracked) - tracked.consumed - ignored - truncated
    return counts, {"consumed": tracked.consumed, "ignored": ignored,
                    "truncated": truncated, "unconsumed": unconsumed}


def torch_state_dict_to_numpy(obj) -> Dict[str, np.ndarray]:
    """Torch ckpt object (or bare state dict) -> fp32 numpy state dict;
    strips DDP 'module.' prefixes and drops non-tensor entries.  Unwraps
    the common container keys ('model_state_dict' from the reference's
    train loop, 'state_dict' from open_clip releases)."""
    if isinstance(obj, dict):
        for container in ("model_state_dict", "state_dict"):
            inner = obj.get(container)
            if isinstance(inner, dict) and inner:
                obj = inner
                break
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("module.")
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(torch.float32).numpy()
    return out


# safetensors dtype names -> little-endian numpy dtypes (BF16 is widened
# through torch, numpy has no bfloat16)
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as fp32 numpy, by name
    ('module.' prefixes stripped)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, info in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            f.seek(8 + n + begin)
            raw = f.read(end - begin)
            dtype = info["dtype"]
            if dtype == "BF16":
                itemsize = 2
            elif dtype in _SAFETENSORS_DTYPES:
                itemsize = np.dtype(_SAFETENSORS_DTYPES[dtype]).itemsize
            else:
                raise ValueError(f"{path}: {name} has dtype {dtype}, which "
                                 "this reader does not know")
            if len(raw) != int(np.prod(shape)) * itemsize:
                raise ValueError(f"{path}: {name} holds {len(raw)} bytes for "
                                 f"{dtype} {list(shape)}")
            if dtype == "BF16":
                a = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(
                    torch.bfloat16).float().numpy()
            else:
                a = np.frombuffer(raw, _SAFETENSORS_DTYPES[dtype]).astype(
                    np.float32)
            out[name.removeprefix("module.")] = a.reshape(shape)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Published weights as a numpy state dict (on the CPU).

    Accepts a torch .pt/.pth/.bin file, a .safetensors file, or a
    DIRECTORY of shards (an HF snapshot: every *.safetensors /
    pytorch_model*.bin merged) — the forms the real artifact set arrives
    in: open_clip ViT .pt, HF MPT snapshot dir, OpenFlamingo
    checkpoint.pt, DeeR delta .pth.  A torch file is loaded with
    ``weights_only=False``: the DeeR .pth holds Python scalars beside its
    tensors, which torch >= 2.6 refuses by default."""
    def one(p: str) -> Dict[str, np.ndarray]:
        if p.endswith(".safetensors"):
            return read_safetensors(p)
        return torch_state_dict_to_numpy(
            torch.load(p, map_location="cpu", weights_only=False))

    if os.path.isdir(path):
        files = sorted(
            f for f in os.listdir(path)
            if f.endswith(".safetensors")
            or (f.startswith("pytorch_model") and f.endswith(".bin")))
        if not files:
            raise FileNotFoundError(
                f"{path}: no *.safetensors or pytorch_model*.bin shards")
        merged: Dict[str, np.ndarray] = {}
        for f in files:
            merged.update(one(os.path.join(path, f)))
        return merged
    return one(path)
