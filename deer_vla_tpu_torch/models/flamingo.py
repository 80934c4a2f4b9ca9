"""The DeeR policy's vision path, parameter init, training forward and
the freeze policy of training.

The camera fusions of the JAX package (flamingo_mpt.py:585-777): 'post'
(both cameras through the ViT and the shared perceiver as one doubled
batch, their latents concatenated on the token dim), 'pre', 'two_way' and
'vit_concat', each with a second resampler (``sep_resampler``), a proprio
token (``use_state``), per-frame embeddings (``use_hist``) and a gripper
camera at its native size (``gripper_res``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.models.action_head import HeadOutput
from deer_vla_tpu_torch.models.diffusion import init_unet
from deer_vla_tpu_torch.models.heads import (any_head_forward, any_head_step,
                                             check_head_type,
                                             diffusion_head_config,
                                             head_uses_dropout, init_any_head)
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
from deer_vla_tpu_torch.ops.layers import (init_linear, linear, normal,
                                           tree_map, tree_map_with_path)


def init_variant_leaves(gen, cfg: DeerConfig, device, dtype) -> dict:
    """The leaves the vision and state variants add to the tree: a second
    resampler (``sep_resampler``), the proprio token's projection
    (``use_state``) and the per-frame embeddings (``use_hist``).  Drawn
    after everything else, so that a variant's backbone is the one the
    same seed draws for the plain model."""
    out = {}
    if cfg.sep_resampler:
        out["perceiver_gripper"] = init_perceiver(gen, cfg.perceiver, device,
                                                  dtype)
    if cfg.use_state:
        out["state_fc"] = init_linear(gen, cfg.state_dim, cfg.vis_dim, True,
                                      device, dtype)
    if cfg.use_hist:
        # added to the ViT tokens before the perceiver (flamingo_mpt.py:138)
        out["frame_embs"] = normal((cfg.window_size, cfg.vis_dim), 1.0, gen,
                                   device, dtype)
    return out


def init_diffusion_leaves(gen, cfg: DeerConfig, device, dtype) -> dict:
    """The diffusion head's model-level leaves (flamingo_mpt.py:168-176):
    one DDPM U-Net shared by every exit and the action normalizer's fp32
    affine, the identity until the trainer fits it
    (train_calvin_post_strategy.py:457-461)."""
    adim = cfg.head.out_features + 1
    return {"diffusion": {
        "unet": init_unet(gen, diffusion_head_config(cfg), device, dtype),
        "norm": {"scale": torch.ones(adim, device=device),
                 "offset": torch.zeros(adim, device=device)}}}


def init_deer(cfg: DeerConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's tree layout, the heads of
    ``cfg.head_type``, drawn from a seeded ``torch.Generator`` on
    ``device``.  The backbone is drawn first, so a head family's backbone
    is the plain model's for the same seed; the diffusion head's U-Net and
    normalizer come last."""
    check_head_type(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = cfg.dtypes.pdt
    params = {
        "vit": init_vit(gen, cfg.vit, dev, pdt),
        "perceiver": init_perceiver(gen, cfg.perceiver, dev, pdt),
        "decoder": init_decoder(gen, cfg, dev, pdt),
        "lm_head": init_any_head(gen, cfg, dev, pdt),
        "extra_exit": init_any_head(gen, cfg, dev, pdt),
        "lm_exits": {},
    }
    if cfg.multi_exit and not cfg.share_exit:
        for layer_id in cfg.exit_layer_ids():
            params["lm_exits"][str(layer_id)] = init_any_head(gen, cfg, dev,
                                                              pdt)
    if cfg.share_exit:
        del params["extra_exit"]
    params.update(init_variant_leaves(gen, cfg, dev, pdt))
    if cfg.head_type == "diffusion":
        params.update(init_diffusion_leaves(gen, cfg, dev, pdt))
    return params


def encode_vision(params: dict, vision_rgb: torch.Tensor,
                  vision_gripper: Optional[torch.Tensor], cfg: DeerConfig,
                  state_tensor: Optional[torch.Tensor] = None,
                  stacked: Optional[dict] = None,
                  window_size: int = 1) -> torch.Tensor:
    """Camera fusion (flamingo_mpt.py:585-777) by ``cfg.fusion_mode``, from
    (B, T, F, 3, H, W) cameras:

      'post': each camera through the perceiver, latents concatenated on
          the token dim -> (B, T, 2n(+1), d);
      'pre': both cameras' ViT tokens concatenated, one perceiver ->
          (B, T, n(+1), d);
      'two_way': the static camera only;
      'vit_concat': B*W frames in, each frame's latents folded into one
          media set per trajectory -> (B/W, T, 2nW(+1), d).

    ``use_hist`` adds the learned frame embedding to each window position's
    ViT tokens (rows stay per frame); ``use_state`` appends the projected
    proprio token.  ``window_size`` is the frame window the rows hold."""
    tok_rgb, tok_grip = dual_camera_tokens(params, vision_rgb,
                                           vision_gripper, cfg, stacked)
    return fuse_vision_tokens(params, tok_rgb, tok_grip, cfg, state_tensor,
                              stacked, window_size)


def dual_camera_tokens(params: dict, vision_rgb: torch.Tensor,
                       vision_gripper: Optional[torch.Tensor],
                       cfg: DeerConfig, stacked: Optional[dict] = None):
    """Camera -> ViT tokens.  Cameras at one resolution share the ViT as
    one doubled batch, unless each has its own resampler (and the fusion is
    not 'pre'); a gripper at its native size (``gripper_res``) runs its own
    pass.  'two_way' encodes the static camera only."""
    grip_on = (cfg.use_gripper and vision_gripper is not None
               and cfg.fusion_mode != "two_way")
    if not grip_on:
        return vision_tokens(params, vision_rgb, cfg, stacked), None
    same_res = vision_gripper.shape[-2:] == vision_rgb.shape[-2:]
    if same_res and (cfg.fusion_mode == "pre" or not cfg.sep_resampler):
        both = torch.cat([vision_rgb, vision_gripper], dim=0)
        tok = vision_tokens(params, both, cfg, stacked)
        b = vision_rgb.shape[0]
        return tok[:b], tok[b:]
    return (vision_tokens(params, vision_rgb, cfg, stacked),
            vision_tokens(params, vision_gripper, cfg, stacked))


def vision_tokens(params: dict, v: torch.Tensor, cfg: DeerConfig,
                  stacked: Optional[dict] = None) -> torch.Tensor:
    """ViT forward -> token grid (B, T, F, P, width), per frame and
    independent of the window position (so a rolling cache can keep them).
    With ``cfg.vit.tome_r`` > 0 the ToMe-merged tower (P less the merges;
    the perceiver reads tokens as a set), except at another resolution than
    the tower's (the native-size gripper), which runs the exact tower.  The
    ViT is cut from the graph unless ``cfg.unfreeze_vit`` (the JAX
    package's ``stop_gradient``, flamingo.py:202-207): it runs under
    ``no_grad``, which also keeps none of its activations."""
    stacked = stacked or {}
    b, t, f = v.shape[:3]
    flat = v.reshape((b * t * f,) + v.shape[3:]).to(cfg.dtypes.cdt)
    native = flat.shape[-2:] == (cfg.vit.image_size, cfg.vit.image_size)
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and cfg.unfreeze_vit):
        if cfg.vit.tome_r > 0 and native:
            _, tokens = vit_forward_tome(params["vit"], flat, cfg.vit,
                                         stacked.get("vit"))
        elif "vit" in stacked:
            _, tokens = vit_forward_stacked(params["vit"], stacked["vit"],
                                            flat, cfg.vit)
        else:
            _, tokens = vit_forward(params["vit"], flat, cfg.vit)
    return tokens.reshape(b, t, f, tokens.shape[-2], tokens.shape[-1])


def fuse_vision_tokens(params: dict, tok_rgb: torch.Tensor,
                       tok_grip: Optional[torch.Tensor], cfg: DeerConfig,
                       state_tensor: Optional[torch.Tensor] = None,
                       stacked: Optional[dict] = None,
                       window_size: int = 1) -> torch.Tensor:
    """Frame embeddings, perceiver resampling, the fusion fold and the state
    token, from (possibly cached) ViT tokens: ``encode_vision`` is this on
    ``dual_camera_tokens``' output."""
    stacked = stacked or {}

    def run_perceiver(pkey, tok):
        if pkey in stacked:
            return perceiver_forward_stacked(params[pkey], stacked[pkey], tok,
                                             cfg.perceiver)
        return perceiver_forward(params[pkey], tok, cfg.perceiver)

    def add_frame_embs(tokens):
        """(B*W, T, F, v, d) + frame_embs[w] at window position w
        (flamingo_mpt.py:713-721)."""
        if not (cfg.use_hist and "frame_embs" in params):
            return tokens
        fe = params["frame_embs"].to(tokens.dtype)[:window_size]
        fe = fe.repeat(tokens.shape[0] // window_size, 1)  # (B*W, d)
        return tokens + fe[:, None, None, None, :]

    def window_concat(lat):
        """(B*W, T, n, d) -> (B, T, n*W, d): the window folded into the
        media tokens."""
        bw, t, n, d = lat.shape
        lat = lat.reshape(bw // window_size, window_size, t, n, d)
        return lat.transpose(1, 2).reshape(bw // window_size, t,
                                           window_size * n, d)

    def per_camera(rgb_key, grip_key):
        """Both cameras' latents: one doubled-batch pass through a shared
        resampler at equal token counts, else one pass each."""
        if rgb_key == grip_key and tok_rgb.shape[3] == tok_grip.shape[3]:
            lat = run_perceiver(rgb_key, torch.cat([tok_rgb, tok_grip]))
            b = tok_rgb.shape[0]
            return lat[:b], lat[b:]
        return run_perceiver(rgb_key, tok_rgb), run_perceiver(grip_key,
                                                              tok_grip)

    tok_rgb = add_frame_embs(tok_rgb)
    if tok_grip is not None:
        tok_grip = add_frame_embs(tok_grip)
    grip_key = "perceiver_gripper" if cfg.sep_resampler else "perceiver"
    if tok_grip is None:
        media = run_perceiver("perceiver", tok_rgb)
        if cfg.fusion_mode == "vit_concat":
            media = window_concat(media)
    elif cfg.fusion_mode == "pre":
        # one resampler over the union of both cameras' tokens
        # (flamingo_mpt.py:596-601)
        media = run_perceiver("perceiver", torch.cat([tok_rgb, tok_grip],
                                                     dim=3))
    elif cfg.fusion_mode == "vit_concat":
        rgb_lat, grip_lat = per_camera("perceiver", grip_key)
        media = torch.cat([window_concat(rgb_lat), window_concat(grip_lat)],
                          dim=2)
    else:  # 'post'
        media = torch.cat(per_camera("perceiver", grip_key), dim=2)
    if cfg.use_state and state_tensor is not None and "state_fc" in params:
        st_in = state_tensor
        if cfg.fusion_mode == "vit_concat" and window_size > 1:
            # one media set a trajectory: the last frame's state (the
            # action target is the last step's)
            st_in = state_tensor.reshape(
                (-1, window_size) + state_tensor.shape[1:])[:, -1]
        st = linear(params["state_fc"], st_in.to(cfg.dtypes.cdt))
        media = torch.cat([media, st.to(media.dtype)], dim=2)
    return media


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
    attention_mask (B*W, S), state_tensor (B*W, 1, 1, state_dim) or None.
    Under 'vit_concat' the text is per window, (B, S): the decoder runs B
    rows with the frames folded into the media tokens and the heads see a
    window of 1 (the last frame's state).

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
    the order final head, internal exits, extra exit, extra exit again.
    The diffusion head's outputs are its (B, W, hidden) LSTM features, which
    the DDPM loss takes (``train/losses.multi_exit_diffusion_loss``)."""
    w = 1 if cfg.fusion_mode == "vit_concat" else cfg.window_size
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not no_backbone_grad):
        media = encode_vision(params, vision_x, vision_gripper, cfg,
                              state_tensor, window_size=cfg.window_size)
        hidden, _ = decoder_forward(params["decoder"], lang_x,
                                    attention_mask, media, cfg)
    st = (None if state_tensor is None
          else state_tensor.reshape(-1, state_tensor.shape[-1]))
    if st is not None and cfg.fusion_mode == "vit_concat":
        st = st.reshape(-1, cfg.window_size, st.shape[-1])[:, -1]
    dev = hidden.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    if not (train and head_uses_dropout(cfg)):
        dropout = None
    elif dropout is None:
        dropout = Dropout(gen)

    def run_head(head_params, feat):
        return any_head_forward(head_params, feat, cfg, st, window=w,
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
                       state_tensor: Optional[torch.Tensor] = None,
                       carry=None) -> Tuple[HeadOutput, object]:
    """One streaming frame at a fixed exit: layers [0, exit_id] only (the
    layers above it never run), then the exit's head (``resolve_head``) in
    fp32 with its carry.  Returns (head output, new carry)."""
    if exit_id < 0:
        exit_id += cfg.n_layers
    if not 0 <= exit_id < cfg.n_layers:
        raise ValueError(f"exit_id {exit_id} out of range for a "
                         f"{cfg.n_layers}-layer decoder")
    media = encode_vision(params, vision_x, vision_gripper, cfg,
                          state_tensor)
    x = embed_tokens(params["decoder"], lang_x, cfg.dtypes.cdt)
    _, x = decoder_segment_forward(params["decoder"], x, attention_mask,
                                   media, cfg, 0, exit_id + 1,
                                   lang_x == cfg.media_token_id)
    st = (None if state_tensor is None
          else state_tensor.reshape(-1, state_tensor.shape[-1]))
    return any_head_step(resolve_head(params, cfg, exit_id), x.float(),
                         carry, cfg, st)


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
    as in the JAX package.  The reference freezes everything, then
    unfreezes the gated x-attn, the perceiver(s), token embeddings, the
    state projection, the frame embeddings and every head (llama's untied
    LM head ``norm_f`` / ``lm_head_w`` too, like the embeddings);
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
        if top in ("perceiver", "perceiver_gripper"):
            return joint and not cfg.freeze_sampler and cfg.train_params < 0
        if top in ("state_fc", "frame_embs"):
            return joint
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
        if top == "diffusion":
            # the U-Net trains in both phases like the heads (factory.py:232);
            # the normalizer is fitted from data, never optimized
            return "norm" not in keys
        return top in ("lm_head", "extra_exit", "lm_exits")

    return tree_map_with_path(label, params)


def checkpoint_mask(params: dict, cfg: DeerConfig) -> dict:
    """The leaves a delta checkpoint stores: the joint phase's trainable
    set (the exit-only set is a subset of it) and the diffusion head's
    fitted normalizer, which no phase trains."""
    def label(keys, trained):
        return trained or keys[:2] == ("diffusion", "norm")

    return tree_map_with_path(
        lambda keys, m: label(keys, m), trainable_mask(params, cfg, "joint"))
