"""The DeeR policy's vision path and parameter init ('post' camera fusion).

Both cameras run through the ViT as ONE doubled batch, then through the
shared perceiver as one doubled batch, and the two cameras' latents are
concatenated on the token dim (flamingo_mpt.py:609-668).
"""

from __future__ import annotations

from typing import Optional

import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.models.action_head import init_head
from deer_vla_tpu_torch.models.mpt import init_decoder
from deer_vla_tpu_torch.models.perceiver import (init_perceiver,
                                                 perceiver_forward,
                                                 perceiver_forward_stacked)
from deer_vla_tpu_torch.models.vit import (init_vit, vit_forward,
                                           vit_forward_stacked)


def check_vision_supported(cfg: DeerConfig) -> None:
    """The ported vision path: 'post' fusion, one shared resampler, no
    proprio token, no frame window, exact (un-merged) ViT."""
    unsupported = {
        "fusion_mode": cfg.fusion_mode != "post",
        "sep_resampler": cfg.sep_resampler,
        "use_state": cfg.use_state,
        "use_hist": cfg.use_hist,
        "gripper_res": cfg.gripper_res != 0,
        "vit.tome_r": cfg.vit.tome_r != 0,
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
    """ViT forward -> token grid (B, T, F, P, width)."""
    b, t, f = v.shape[:3]
    flat = v.reshape((b * t * f,) + v.shape[3:]).to(cfg.dtypes.cdt)
    if stacked and "vit" in stacked:
        _, tokens = vit_forward_stacked(params["vit"], stacked["vit"], flat,
                                        cfg.vit)
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
