"""The DeeR policy's vision path, parameter init, training forward ('post'
camera fusion) and the freeze policy of training.

Both cameras run through the ViT as ONE doubled batch, then through the
shared perceiver as one doubled batch, and the two cameras' latents are
concatenated on the token dim (flamingo_mpt.py:609-668).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.models.action_head import HeadOutput, init_head
from deer_vla_tpu_torch.models.heads import any_head_forward, any_head_step
from deer_vla_tpu_torch.models.mpt import (decoder_forward,
                                           decoder_segment_forward,
                                           embed_tokens, init_decoder)
from deer_vla_tpu_torch.models.perceiver import (init_perceiver,
                                                 perceiver_forward,
                                                 perceiver_forward_stacked)
from deer_vla_tpu_torch.models.vit import (init_vit, vit_forward,
                                           vit_forward_stacked,
                                           vit_forward_tome)
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.layers import tree_map, tree_map_with_path


def check_vision_supported(cfg: DeerConfig) -> None:
    """The ported vision path: 'post' fusion, one shared resampler, no
    proprio token, no frame window, both cameras at one resolution."""
    unsupported = {
        "fusion_mode": cfg.fusion_mode != "post",
        "sep_resampler": cfg.sep_resampler,
        "use_state": cfg.use_state,
        "use_hist": cfg.use_hist,
        "gripper_res": cfg.gripper_res != 0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def init_deer(cfg: DeerConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's tree layout (deterministic
    head family), drawn from a seeded ``torch.Generator`` on ``device``."""
    if cfg.head_type != "deterministic":
        raise NotImplementedError(
            f"head_type {cfg.head_type!r} is not ported")
    check_vision_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = cfg.dtypes.pdt
    params = {
        "vit": init_vit(gen, cfg.vit, dev, pdt),
        "perceiver": init_perceiver(gen, cfg.perceiver, dev, pdt),
        "decoder": init_decoder(gen, cfg, dev, pdt),
        "lm_head": init_head(gen, cfg.head, dev, pdt),
        "extra_exit": init_head(gen, cfg.head, dev, pdt),
        "lm_exits": {},
    }
    if cfg.multi_exit and not cfg.share_exit:
        for layer_id in cfg.exit_layer_ids():
            params["lm_exits"][str(layer_id)] = init_head(gen, cfg.head, dev,
                                                          pdt)
    if cfg.share_exit:
        del params["extra_exit"]
    return params


def encode_vision(params: dict, vision_rgb: torch.Tensor,
                  vision_gripper: Optional[torch.Tensor], cfg: DeerConfig,
                  stacked: Optional[dict] = None) -> torch.Tensor:
    """(B, T, F, 3, H, W) cameras -> media (B, T, 2n, vis_dim)."""
    tok_rgb, tok_grip = dual_camera_tokens(params, vision_rgb,
                                           vision_gripper, cfg, stacked)
    return fuse_vision_tokens(params, tok_rgb, tok_grip, cfg, stacked)


def dual_camera_tokens(params: dict, vision_rgb: torch.Tensor,
                       vision_gripper: Optional[torch.Tensor],
                       cfg: DeerConfig, stacked: Optional[dict] = None):
    """Same-resolution cameras share the ViT as one doubled batch."""
    if not cfg.use_gripper or vision_gripper is None:
        return vision_tokens(params, vision_rgb, cfg, stacked), None
    if vision_gripper.shape[-2:] != vision_rgb.shape[-2:]:
        raise NotImplementedError("cameras at different resolutions")
    both = torch.cat([vision_rgb, vision_gripper], dim=0)
    tok = vision_tokens(params, both, cfg, stacked)
    b = vision_rgb.shape[0]
    return tok[:b], tok[b:]


def vision_tokens(params: dict, v: torch.Tensor, cfg: DeerConfig,
                  stacked: Optional[dict] = None) -> torch.Tensor:
    """ViT forward -> token grid (B, T, F, P, width); with
    ``cfg.vit.tome_r`` > 0 the ToMe-merged tower (P less the merges; the
    perceiver reads tokens as a set).  The ViT is cut from the graph unless
    ``cfg.unfreeze_vit`` (the JAX package's ``stop_gradient``,
    flamingo.py:202-207): it runs under ``no_grad``, which also keeps none
    of its activations."""
    b, t, f = v.shape[:3]
    flat = v.reshape((b * t * f,) + v.shape[3:]).to(cfg.dtypes.cdt)
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and cfg.unfreeze_vit):
        if cfg.vit.tome_r > 0:
            _, tokens = vit_forward_tome(params["vit"], flat, cfg.vit,
                                         (stacked or {}).get("vit"))
        elif stacked and "vit" in stacked:
            _, tokens = vit_forward_stacked(params["vit"], stacked["vit"],
                                            flat, cfg.vit)
        else:
            _, tokens = vit_forward(params["vit"], flat, cfg.vit)
    return tokens.reshape(b, t, f, tokens.shape[-2], tokens.shape[-1])


def fuse_vision_tokens(params: dict, tok_rgb: torch.Tensor,
                       tok_grip: Optional[torch.Tensor], cfg: DeerConfig,
                       stacked: Optional[dict] = None) -> torch.Tensor:
    """Perceiver resample + 'post' fusion: (B, T, 2n, d) media."""
    def run_perceiver(tok):
        if stacked and "perceiver" in stacked:
            return perceiver_forward_stacked(params["perceiver"],
                                             stacked["perceiver"], tok,
                                             cfg.perceiver)
        return perceiver_forward(params["perceiver"], tok, cfg.perceiver)

    if tok_grip is None:
        return run_perceiver(tok_rgb)
    lat = run_perceiver(torch.cat([tok_rgb, tok_grip], dim=0))
    b = tok_rgb.shape[0]
    return torch.cat([lat[:b], lat[b:]], dim=2)


class TrainOutputs(NamedTuple):
    """Per-exit head outputs of the training forward (train_utils.py:503
    order: internal exits..., final, extra1, extra2)."""
    exit_outputs: Tuple[HeadOutput, ...]
    final_output: HeadOutput
    extra_output: HeadOutput
    extra_output2: HeadOutput
    hidden_states: torch.Tensor    # (L, B*W, S, D)
    rand_layer_feat: torch.Tensor  # (B*W, S, D) sampling-1 features
    rand_layer_ids: torch.Tensor   # (B, W) sampled layer indices


def forward_train(params: dict, vision_x: torch.Tensor,
                  lang_x: torch.Tensor, attention_mask: torch.Tensor,
                  cfg: DeerConfig, gen: Optional[torch.Generator] = None,
                  vision_gripper: Optional[torch.Tensor] = None,
                  state_tensor: Optional[torch.Tensor] = None,
                  no_backbone_grad: bool = False,
                  only_extra_exit: bool = False, train: bool = True,
                  rand_layer_ids: Optional[torch.Tensor] = None,
                  switch_layer_ids: Optional[torch.Tensor] = None,
                  dropout: Optional[Dropout] = None) -> TrainOutputs:
    """The Flamingo training forward (flamingo_mpt.py:308-517):
    vision_x / vision_gripper (B*W, 1, 1, 3, H, W), lang_x and
    attention_mask (B*W, S).

    ``no_backbone_grad`` (the exit-only phase) runs vision and decoder under
    ``no_grad``, so only the heads get gradients (JAX: ``stop_gradient`` on
    the hidden states).  The extra exit runs twice on features from random
    exit layers (flamingo_mpt.py:476-512): sampling 1 draws one exit per
    (b, t), sampling 2 one switch point and two exits per trajectory.  The
    draws come from ``gen`` (a generator seeded 0 on the batch's device
    when None), or from the caller as ``rand_layer_ids`` /
    ``switch_layer_ids`` (B, W) layer indices; the first is returned as
    ``rand_layer_ids``.  With ``train`` and a head dropout rate > 0 the
    heads drop through ``dropout`` (from ``gen`` when None), asked for in
    the order final head, internal exits, extra exit, extra exit again."""
    check_vision_supported(cfg)
    h = cfg.head
    if state_tensor is not None:
        raise NotImplementedError("proprio-state models are not ported")
    w = cfg.window_size
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not no_backbone_grad):
        media = encode_vision(params, vision_x, vision_gripper, cfg)
        hidden, _ = decoder_forward(params["decoder"], lang_x,
                                    attention_mask, media, cfg)
    dev = hidden.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    if not (train and (h.dropout > 0 or h.lstm_dropout > 0)):
        dropout = None
    elif dropout is None:
        dropout = Dropout(gen)

    def run_head(head_params, feat):
        return any_head_forward(head_params, feat, cfg, window=w,
                                dropout=dropout)

    final_out = run_head(params["lm_head"], hidden[-1])
    exit_outputs = ()
    if cfg.multi_exit and not only_extra_exit:
        exit_outputs = tuple(
            run_head(params["lm_head"] if cfg.share_exit
                     else params["lm_exits"][str(i)], hidden[i])
            for i in cfg.exit_layer_ids())

    exit_ids = torch.tensor(cfg.all_exit_ids(), device=dev)
    n_exit = cfg.num_exits
    bsw = hidden.shape[1]
    bs = bsw // w
    rows = torch.arange(bsw, device=dev)

    def draw(low, high, shape):
        return torch.randint(low, high, shape, generator=gen,
                             device=gen.device).to(dev)

    extra_head = params["lm_head"] if cfg.share_exit else params["extra_exit"]
    # sampling 1: an independent exit per (b, t)
    lay1 = (exit_ids[draw(0, n_exit, (bs, w))] if rand_layer_ids is None
            else rand_layer_ids.to(dev))
    rand_feat = hidden[lay1.reshape(bsw), rows]  # (B*W, S, D)
    extra_out = run_head(extra_head, rand_feat)
    # sampling 2: one switch point, two exits per trajectory
    if switch_layer_ids is None:
        prev_len = draw(1, w + 1, ())
        idx2 = draw(0, n_exit, (bs, 2))
        tpos = torch.arange(w, device=dev)[None, :]
        switch_layer_ids = exit_ids[torch.where(tpos < prev_len, idx2[:, :1],
                                                idx2[:, 1:])]
    feat2 = hidden[switch_layer_ids.to(dev).reshape(bsw), rows]
    extra_out2 = run_head(extra_head, feat2)
    return TrainOutputs(exit_outputs, final_out, extra_out, extra_out2,
                        hidden, rand_feat, lay1)


# ---------------------------------------------------------------------------
# fixed-exit inference forward (the exit_id path, flamingo_mpt.py:446-461)
# ---------------------------------------------------------------------------


def forward_fixed_exit(params: dict, vision_x: torch.Tensor,
                       lang_x: torch.Tensor, attention_mask: torch.Tensor,
                       cfg: DeerConfig, exit_id: int,
                       vision_gripper: Optional[torch.Tensor] = None,
                       carry=None) -> Tuple[HeadOutput, object]:
    """One streaming frame at a fixed exit: layers [0, exit_id] only (the
    layers above it never run), then the exit's head (``resolve_head``) in
    fp32 with its carry.  Returns (head output, new carry)."""
    check_vision_supported(cfg)
    if exit_id < 0:
        exit_id += cfg.n_layers
    if not 0 <= exit_id < cfg.n_layers:
        raise ValueError(f"exit_id {exit_id} out of range for a "
                         f"{cfg.n_layers}-layer decoder")
    media = encode_vision(params, vision_x, vision_gripper, cfg)
    x = embed_tokens(params["decoder"], lang_x, cfg.dtypes.cdt)
    _, x = decoder_segment_forward(params["decoder"], x, attention_mask,
                                   media, cfg, 0, exit_id + 1,
                                   lang_x == cfg.media_token_id)
    return any_head_step(resolve_head(params, cfg, exit_id), x.float(),
                         carry, cfg)


def resolve_head(params: dict, cfg: DeerConfig, exit_id: int) -> dict:
    """The head of an exit (flamingo_mpt.py:450-457): the shared ``lm_head``
    with ``share_exit``; else the extra exit, unless
    ``layerwise_exit_eval``, where each exit has its own (``lm_head`` at the
    last layer)."""
    if cfg.share_exit or not cfg.layerwise_exit_eval:
        return params["lm_head"] if cfg.share_exit else params["extra_exit"]
    if exit_id == cfg.n_layers - 1:
        return params["lm_head"]
    return params["lm_exits"][str(exit_id)]


# ---------------------------------------------------------------------------
# freeze policy (factory.py:203-237)
# ---------------------------------------------------------------------------


def cast_frozen_to_bf16(params: dict, mask: dict) -> dict:
    """Frozen leaves (mask False) never get updates, so they need no fp32
    master: floating ones are cast to bf16, the compute dtype."""
    return tree_map(lambda p, m: p if m or not p.is_floating_point()
                    else p.to(torch.bfloat16), params, mask)


def trainable_mask(params: dict, cfg: DeerConfig, phase: str = "joint"
                   ) -> dict:
    """Boolean tree of the trainable leaves, keyed off the tree's path names
    as in the JAX package (for the trees the port builds: no second
    resampler, state token or frame embeddings; ROADMAP.md M10).  The
    reference freezes everything, then unfreezes the gated x-attn,
    perceiver, token embeddings and every head (llama's untied LM head
    ``norm_f`` / ``lm_head_w`` too, like the embeddings);
    phase='exit_only' freezes the backbone too (the second post-strategy
    phase).  Knobs: ``freeze_sampler`` keeps the perceiver frozen,
    ``freeze_embed`` the embeddings, ``unfreeze_vit`` trains the ViT, and
    ``train_params >= 0`` trains only the last round(train_params / 140)
    x-attn layers (and freezes the perceiver)."""
    if cfg.train_params >= 0:
        k = int(cfg.train_params / 140 + 0.5)  # the reference's per layer
        xattn_layers = [i for i in range(cfg.n_layers) if cfg.has_xattn(i)]
        budget = set(xattn_layers[max(0, len(xattn_layers) - k):] if k
                     else [])
    else:
        budget = None
    joint = phase == "joint"

    def label(keys, _):
        top = keys[0]
        if top == "vit":
            return cfg.unfreeze_vit and joint
        if top == "perceiver":
            return joint and not cfg.freeze_sampler and cfg.train_params < 0
        if top == "decoder":
            if "xattn" in keys:
                if budget is not None \
                        and keys[keys.index("xattn") + 1] not in budget:
                    return False
                return joint
            if "wte" in keys:
                return joint and not cfg.freeze_embed
            if "norm_f" in keys or "lm_head_w" in keys:
                return joint  # llama's untied LM head (JAX :505-509)
            return False  # the decoder blocks and ln_f stay frozen
        return top in ("lm_head", "extra_exit", "lm_exits")

    return tree_map_with_path(label, params)


def checkpoint_mask(params: dict, cfg: DeerConfig) -> dict:
    """The leaves a delta checkpoint stores: the joint phase's trainable
    set (the exit-only set is a subset of it)."""
    return trainable_mask(params, cfg, "joint")
