"""BLIP captioner / VQA model (the JAX package's ``models/blip.py``): the
second eval-model family of the VL harness (upstream
open_flamingo/eval/models/blip.py).  A pre-LN ViT encoder and a BERT-style
causal text decoder with cross-attention over the image tokens in every
layer (Li et al., BLIP), laid out as HF ``BlipForConditionalGeneration`` so
that its state dict converts leaf for leaf (``convert_hf_blip``).

The ViT's attention goes through ``ops.attention.dot_attention``: blip_base
hands K1 577 tokens (24 x 24 patches of 16 px at 384 px, and CLS), 12 heads
of 64.  Softmax and LayerNorm statistics are fp32; the activations take the
pixel values' dtype (``BlipEvalModel`` casts them to ``--precision``'s; the
JAX package's eval model passes fp32).  The layer stacks are lists, as in
the JAX tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.data.preprocess import clip_preprocess
from deer_vla_tpu_torch.eval.vl_eval import (generated_rows, prompt_buffer,
                                             write_token)
from deer_vla_tpu_torch.models.vit import _patchify
from deer_vla_tpu_torch.ops.attention import (dot_attention, merge_heads,
                                              split_heads)
from deer_vla_tpu_torch.ops.layers import (embedding, gelu, init_layernorm,
                                           init_linear, layernorm, linear,
                                           normal, trunc_normal)


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    image_size: int = 384
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    eps: float = 1e-5

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524          # bert-base + [DEC] / [ENC]
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 512
    eps: float = 1e-12
    bos_token_id: int = 30522        # [DEC]: generation starts here
    sep_token_id: int = 102          # [SEP]: generation stops here
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: BlipVisionConfig = BlipVisionConfig()
    text: BlipTextConfig = BlipTextConfig()


def blip_base() -> BlipConfig:
    """Salesforce/blip-image-captioning-base geometry."""
    return BlipConfig()


def blip_tiny() -> BlipConfig:
    """Test-scale geometry (the HF replica's in the tests)."""
    return BlipConfig(
        vision=BlipVisionConfig(image_size=24, patch_size=8, width=32,
                                layers=2, heads=4, mlp_dim=64),
        text=BlipTextConfig(vocab_size=100, width=32, layers=2, heads=4,
                            mlp_dim=64, max_positions=40,
                            bos_token_id=97, sep_token_id=98))


# ---------------------------------------------------------------------------
# init (seeded torch.Generator; the JAX init's distributions)
# ---------------------------------------------------------------------------


def _init_attn(gen, width: int, kv_width: int, device, dtype) -> dict:
    """BERT attention: separate q / k / v, output dense + LayerNorm."""
    return {"q": init_linear(gen, width, width, True, device, dtype),
            "k": init_linear(gen, kv_width, width, True, device, dtype),
            "v": init_linear(gen, kv_width, width, True, device, dtype),
            "out": init_linear(gen, width, width, True, device, dtype),
            "ln": init_layernorm(width, device=device, dtype=dtype)}


def init_blip(cfg: BlipConfig, seed: int = 0, device=None,
              dtype=torch.float32) -> dict:
    """Random parameters in the JAX tree's layout from a seeded
    ``torch.Generator`` on ``device`` (the card unless named)."""
    vc, tc = cfg.vision, cfg.text
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(i, o):
        return init_linear(gen, i, o, True, device, dtype)

    def ln(d):
        return init_layernorm(d, device=device, dtype=dtype)

    vision = {
        "class_embedding": normal((vc.width,), 0.02, gen, device, dtype),
        "position_embedding": normal((vc.seq_len, vc.width), 0.02, gen,
                                     device, dtype),
        "patch_embed": lin(3 * vc.patch_size * vc.patch_size, vc.width),
        "blocks": [{"ln1": ln(vc.width), "ln2": ln(vc.width),
                    "qkv": lin(vc.width, 3 * vc.width),
                    "out": lin(vc.width, vc.width),
                    "fc1": lin(vc.width, vc.mlp_dim),
                    "fc2": lin(vc.mlp_dim, vc.width)}
                   for _ in range(vc.layers)],
        "ln_post": ln(vc.width),
    }
    text = {
        "wte": {"w": trunc_normal((tc.vocab_size, tc.width), 0.02, gen,
                                  device, dtype)},
        "wpe": {"w": trunc_normal((tc.max_positions, tc.width), 0.02, gen,
                                  device, dtype)},
        "ln_emb": ln(tc.width),
        "layers": [{"self": _init_attn(gen, tc.width, tc.width, device,
                                       dtype),
                    "cross": _init_attn(gen, tc.width, vc.width, device,
                                        dtype),
                    "inter": lin(tc.width, tc.mlp_dim),
                    "output": lin(tc.mlp_dim, tc.width),
                    "ln": ln(tc.width)}
                   for _ in range(tc.layers)],
        "head_transform": lin(tc.width, tc.width),
        "head_ln": ln(tc.width),
        "head": lin(tc.width, tc.vocab_size),
    }
    return {"vision": vision, "text": text}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def vision_forward(params: dict, pixel_values: torch.Tensor,
                   cfg: BlipVisionConfig) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1 + P, D) image tokens (CLS first) after the
    post-LayerNorm, in ``pixel_values``' dtype: what the text decoder
    attends to (HF BlipVisionModel)."""
    p = params["vision"]
    b = pixel_values.shape[0]
    h = linear(p["patch_embed"], _patchify(pixel_values, cfg.patch_size))
    cls = p["class_embedding"].to(h.dtype).expand(b, 1, cfg.width)
    h = torch.cat([cls, h], dim=1) + p["position_embedding"].to(h.dtype)
    for blk in p["blocks"]:
        a = layernorm(blk["ln1"], h, cfg.eps)
        q, k, v = linear(blk["qkv"], a).chunk(3, dim=-1)
        a = dot_attention(split_heads(q, cfg.heads),
                          split_heads(k, cfg.heads),
                          split_heads(v, cfg.heads))
        h = h + linear(blk["out"], merge_heads(a))
        m = layernorm(blk["ln2"], h, cfg.eps)
        h = h + linear(blk["fc2"], gelu(linear(blk["fc1"], m)))
    return layernorm(p["ln_post"], h, cfg.eps)


def _bert_attn(p: dict, x: torch.Tensor, kv: torch.Tensor, heads: int,
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """Post-LN BERT attention: LN(dense(attn(x, kv)) + x)."""
    q = split_heads(linear(p["q"], x), heads)
    k = split_heads(linear(p["k"], kv), heads)
    v = split_heads(linear(p["v"], kv), heads)
    a = merge_heads(dot_attention(q, k, v, bias=bias))
    return layernorm(p["ln"], linear(p["out"], a) + x, eps)


def text_hidden(params: dict, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, encoder_states: torch.Tensor,
                cfg: BlipTextConfig) -> torch.Tensor:
    """The causal BERT decoder's last hidden state (B, S, D), in
    ``encoder_states``' dtype.  The self-attention sees causal and
    key-padding positions (HF get_extended_attention_mask for a decoder);
    the cross-attention every image token."""
    p = params["text"]
    s = input_ids.shape[1]
    h = embedding(p["wte"], input_ids, encoder_states.dtype)
    h = h + p["wpe"]["w"][:s].to(h.dtype)
    h = layernorm(p["ln_emb"], h, cfg.eps)
    dev = input_ids.device
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    keep = causal[None, None] & (attention_mask[:, None, None, :] > 0)
    bias = torch.where(keep, torch.zeros((), device=dev),
                       torch.tensor(-1e9, device=dev))
    for lp in p["layers"]:
        h = _bert_attn(lp["self"], h, h, cfg.heads, bias, cfg.eps)
        h = _bert_attn(lp["cross"], h, encoder_states, cfg.heads, None,
                       cfg.eps)
        m = gelu(linear(lp["inter"], h))
        h = layernorm(lp["ln"], linear(lp["output"], m) + h, cfg.eps)
    return h


def text_head(params: dict, h: torch.Tensor, cfg: BlipTextConfig
              ) -> torch.Tensor:
    """Hidden states -> fp32 vocabulary logits (the prediction head)."""
    p = params["text"]
    t = layernorm(p["head_ln"], gelu(linear(p["head_transform"], h)),
                  cfg.eps)
    return linear(p["head"], t).float()


def text_decoder_forward(params: dict, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor,
                         encoder_states: torch.Tensor,
                         cfg: BlipTextConfig) -> torch.Tensor:
    """(B, S) ids and mask, (B, Sv, Dv) image tokens -> (B, S, vocab) fp32
    logits."""
    return text_head(params, text_hidden(params, input_ids, attention_mask,
                                         encoder_states, cfg), cfg)


def blip_forward(params: dict, pixel_values: torch.Tensor,
                 input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 cfg: BlipConfig) -> torch.Tensor:
    """The captioner's forward -> (B, S, vocab) logits (HF
    BlipForConditionalGeneration.forward)."""
    enc = vision_forward(params, pixel_values, cfg.vision)
    return text_decoder_forward(params, input_ids, attention_mask, enc,
                                cfg.text)


@torch.no_grad()
def blip_generate(params: dict, cfg: BlipConfig, pixel_values: torch.Tensor,
                  prompt_ids, prompt_mask,
                  max_new_tokens: int = 10) -> np.ndarray:
    """Greedy caption continuation with the buffer protocol of
    ``eval/vl_eval.greedy_generate``.  Prompt rows start with [DEC]
    (``text.bos_token_id``; HF generate forces it).  Returns the (B,
    max_new_tokens) new ids, [SEP] from the first stop on."""
    b, s = np.asarray(prompt_ids).shape
    if s + max_new_tokens > cfg.text.max_positions:
        raise ValueError(
            f"BLIP decode buffer {s + max_new_tokens} (prompt {s} + "
            f"{max_new_tokens} new) exceeds text.max_positions="
            f"{cfg.text.max_positions}; shorten the prompt (fewer "
            f"--shots / shorter demos) or use a larger-context config")
    dev = pixel_values.device
    ids, mask, start_lens = prompt_buffer(prompt_ids, prompt_mask,
                                          max_new_tokens, dev)
    enc = vision_forward(params, pixel_values, cfg.vision)
    rows = torch.arange(b, device=dev)
    starts = torch.from_numpy(start_lens).to(dev)
    for i in range(max_new_tokens):
        h = text_hidden(params, ids, mask, enc, cfg.text)
        logits = text_head(params, h[rows, starts + i - 1], cfg.text)
        write_token(ids, mask, rows, starts + i, logits.argmax(-1))
    return generated_rows(ids, start_lens, max_new_tokens,
                          cfg.text.sep_token_id)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


def convert_hf_blip(state_dict, cfg: BlipConfig) -> dict:
    """HF BlipForConditionalGeneration state dict (tensors or arrays) ->
    the ``init_blip`` tree of fp32 CPU tensors.  Every key is consumed;
    a leftover key raises."""
    sd = {k: torch.as_tensor(v.detach().cpu() if hasattr(v, "detach")
                             else np.asarray(v))
          for k, v in state_dict.items()}
    used = set()

    def take(name):
        used.add(name)
        return sd[name].float()

    def lin(prefix):
        p = {"w": take(prefix + ".weight").t().contiguous()}
        if prefix + ".bias" in sd:
            p["b"] = take(prefix + ".bias")
        return p

    def ln(prefix):
        return {"scale": take(prefix + ".weight"),
                "bias": take(prefix + ".bias")}

    vc, tc = cfg.vision, cfg.text
    v = "vision_model."
    conv_w = take(v + "embeddings.patch_embedding.weight")
    vision = {
        "class_embedding": take(v + "embeddings.class_embedding").reshape(
            vc.width),
        "position_embedding": take(v + "embeddings.position_embedding"
                                   ).reshape(vc.seq_len, vc.width),
        # conv (D, 3, p, p) -> (3*p*p, D); _patchify flattens (c, ph, pw)
        "patch_embed": {"w": conv_w.reshape(vc.width, -1).t().contiguous(),
                        "b": take(v + "embeddings.patch_embedding.bias")},
        "ln_post": ln(v + "post_layernorm"),
        "blocks": [],
    }
    for i in range(vc.layers):
        b = f"{v}encoder.layers.{i}."
        vision["blocks"].append({
            "ln1": ln(b + "layer_norm1"), "ln2": ln(b + "layer_norm2"),
            "qkv": lin(b + "self_attn.qkv"),
            "out": lin(b + "self_attn.projection"),
            "fc1": lin(b + "mlp.fc1"), "fc2": lin(b + "mlp.fc2")})

    t = "text_decoder.bert."
    pred = "text_decoder.cls.predictions."
    text = {
        "wte": {"w": take(t + "embeddings.word_embeddings.weight")},
        "wpe": {"w": take(t + "embeddings.position_embeddings.weight")},
        "ln_emb": ln(t + "embeddings.LayerNorm"),
        "layers": [],
        "head_transform": lin(pred + "transform.dense"),
        "head_ln": ln(pred + "transform.LayerNorm"),
        "head": {"w": take(pred + "decoder.weight").t().contiguous(),
                 "b": take(pred + "decoder.bias")},
    }
    # HF ties the decoder's bias to cls.predictions.bias; consume the alias
    if pred + "bias" in sd:
        text["head"]["b"] = take(pred + "bias")

    def bert_attn(prefix):
        return {"q": lin(prefix + ".self.query"),
                "k": lin(prefix + ".self.key"),
                "v": lin(prefix + ".self.value"),
                "out": lin(prefix + ".output.dense"),
                "ln": ln(prefix + ".output.LayerNorm")}

    for i in range(tc.layers):
        b = f"{t}encoder.layer.{i}."
        text["layers"].append({
            "self": bert_attn(b + "attention"),
            "cross": bert_attn(b + "crossattention"),
            "inter": lin(b + "intermediate.dense"),
            "output": lin(b + "output.dense"),
            "ln": ln(b + "output.LayerNorm")})

    # HF registers non-parameter buffers (position_ids) in some versions
    leftover = {k for k in set(sd) - used if not k.endswith("position_ids")}
    if leftover:
        raise ValueError(f"unconsumed HF BLIP keys: {sorted(leftover)[:8]}")
    return {"vision": vision, "text": text}



def blip_preprocess(images: torch.Tensor, size: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> (B, 3, size, size) normalized on the images'
    device: BlipImageProcessor's bicubic resize and mean / std, which are
    OpenAI CLIP's (``data/preprocess.clip_preprocess``, the JAX package's
    cubic weights)."""
    return clip_preprocess(images, size, dtype)
