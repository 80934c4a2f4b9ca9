"""Static configuration dataclasses for the PyTorch port.

A copy of the JAX package's ``core/config.py``: the same frozen dataclasses,
field names and registry entries, so a JSON sidecar written by either package
loads in both.  The only difference is that dtypes resolve to torch dtypes.
The port keeps its own copy rather than importing the JAX module, which
imports ``jax.numpy``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class DTypePolicy:
    """Param / compute dtypes: fp32 master params, bf16 compute on the card."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


FP32 = DTypePolicy(param_dtype="float32", compute_dtype="float32")
BF16 = DTypePolicy(param_dtype="float32", compute_dtype="bfloat16")


@dataclass(frozen=True)
class ViTConfig:
    """CLIP visual tower (open_clip "ViT-L-14"), per-patch tokens after
    ln_post feed the perceiver."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    use_quick_gelu: bool = True
    tome_r: int = 0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:  # patches + CLS
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclass(frozen=True)
class PerceiverConfig:
    dim: int = 1024
    depth: int = 6
    dim_head: int = 64
    heads: int = 8
    num_latents: int = 64
    ff_mult: int = 4

    @property
    def inner_dim(self) -> int:
        return self.dim_head * self.heads


@dataclass(frozen=True)
class MPTConfig:
    """Truncated MPT decoder; truncation is ``n_layers``."""

    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 12
    vocab_size: int = 50432
    max_seq_len: int = 2048
    mlp_ratio: int = 4
    alibi: bool = True
    alibi_bias_max: float = 8.0
    no_bias: bool = True
    qk_ln: bool = False
    logit_scale: Optional[float] = None
    arch: str = "mpt"
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclass(frozen=True)
class HeadConfig:
    in_features: int = 2048
    hidden_size: int = 1024
    out_features: int = 6
    lstm_num_layers: int = 4
    lstm_layernorm: bool = False
    mlp_layernorm: bool = False
    mlp_num_hidden_layers: int = 3
    mlp_hidden_dims: Tuple[int, ...] = (1024, 512, 256)
    dropout: float = 0.0
    lstm_dropout: float = 0.0
    dropout_mode: str = "layerwise"
    window_size: int = 12
    multi_step_action: int = 1
    pooling: str = "max"
    use_state: bool = False
    fusion_mode: str = "post"
    last_action: bool = False


@dataclass(frozen=True)
class DeerConfig:
    """MPTFlamingo equivalent; field-for-field the JAX package's DeerConfig."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    perceiver: PerceiverConfig = field(default_factory=PerceiverConfig)
    mpt: MPTConfig = field(default_factory=MPTConfig)
    head: HeadConfig = field(default_factory=HeadConfig)

    cross_attn_every_n_layers: int = 1
    only_attend_immediate_media: bool = True
    xattn_dim_head: int = 64
    xattn_heads: int = 8
    xattn_ff_mult: int = 4

    text_len: int = 32
    media_token_id: int = 50277
    eoc_token_id: int = 50278

    multi_exit: bool = True
    share_exit: bool = False
    exit_interval: int = 2
    window_size: int = 12

    head_type: str = "deterministic"
    gpt_hidden_size: Optional[int] = None
    diff_horizon: int = 32
    diff_timesteps: int = 150
    diff_predict_epsilon: bool = True
    n_obs_steps: int = 6
    diff_down_dims: Tuple[int, ...] = (256, 512, 1024)

    fusion_mode: str = "post"
    use_hist: bool = False
    use_gripper: bool = True
    gripper_res: int = 0
    use_state: bool = False
    state_dim: int = 15
    clip_state: bool = False
    sep_resampler: bool = False
    sep_lm_head: bool = True
    freeze_embed: bool = False
    freeze_sampler: bool = False
    unfreeze_vit: bool = False
    train_params: int = -1
    layerwise_exit_eval: bool = False
    early_exit_layer: int = -1
    remat_layers: bool = False
    remat_policy: str = "full"

    dtypes: DTypePolicy = field(default_factory=lambda: BF16)

    @property
    def vis_dim(self) -> int:
        return self.vit.width

    @property
    def lang_dim(self) -> int:
        return self.mpt.d_model

    @property
    def n_layers(self) -> int:
        return self.mpt.n_layers

    def exit_layer_ids(self) -> Tuple[int, ...]:
        """Internal exit layer indices, not including the final layer.
        Layer 0 is never an exit: the criterion needs the layer below."""
        start = max(self.exit_interval - 1, 1)
        return tuple(range(start, self.n_layers - 1, self.exit_interval))

    def all_exit_ids(self) -> Tuple[int, ...]:
        return self.exit_layer_ids() + (self.n_layers - 1,)

    @property
    def num_exits(self) -> int:
        return len(self.all_exit_ids())

    def has_xattn(self, layer_idx: int) -> bool:
        return (layer_idx + 1) % self.cross_attn_every_n_layers == 0

    @property
    def num_media_tokens(self) -> int:
        n = self.perceiver.num_latents
        if self.fusion_mode == "vit_concat":
            n *= (2 if self.use_gripper else 1) * self.window_size
        elif self.use_gripper and self.fusion_mode == "post":
            n *= 2
        if self.use_state:
            n += 1
        return n

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "DeerConfig":
        raw = json.loads(s)
        raw["vit"] = ViTConfig(**raw["vit"])
        raw["perceiver"] = PerceiverConfig(**raw["perceiver"])
        raw["mpt"] = MPTConfig(**raw["mpt"])
        hd = raw["head"]
        hd["mlp_hidden_dims"] = tuple(hd["mlp_hidden_dims"])
        raw["head"] = HeadConfig(**hd)
        raw["dtypes"] = DTypePolicy(**raw["dtypes"])
        if "diff_down_dims" in raw:
            raw["diff_down_dims"] = tuple(raw["diff_down_dims"])
        return DeerConfig(**raw)


def deer_3b(max_layer: int = 12, exit_interval: int = 2, window_size: int = 12,
            dtypes: DTypePolicy = BF16) -> DeerConfig:
    """OpenFlamingo-3B: ViT-L/14 + MPT-1B(dolly), x-attn every layer."""
    return DeerConfig(
        vit=ViTConfig(),
        perceiver=PerceiverConfig(dim=1024),
        mpt=MPTConfig(d_model=2048, n_heads=16, n_layers=max_layer),
        head=HeadConfig(in_features=2048, window_size=window_size),
        cross_attn_every_n_layers=1,
        exit_interval=exit_interval,
        window_size=window_size,
        dtypes=dtypes,
    )


def deer_9b(max_layer: int = 12, exit_interval: int = 4, window_size: int = 12,
            dtypes: DTypePolicy = BF16) -> DeerConfig:
    """OpenFlamingo-9B: ViT-L/14 + MPT-7B, x-attn every 4 layers."""
    return DeerConfig(
        vit=ViTConfig(),
        perceiver=PerceiverConfig(dim=1024),
        mpt=MPTConfig(d_model=4096, n_heads=32, n_layers=max_layer,
                      vocab_size=50432),
        head=HeadConfig(in_features=4096, window_size=window_size),
        cross_attn_every_n_layers=4,
        exit_interval=exit_interval,
        window_size=window_size,
        dtypes=dtypes,
    )


def bc_llama(n_layers: int = 32, d_model: int = 4096, window_size: int = 12,
             dtypes: DTypePolicy = BF16) -> DeerConfig:
    """BCFlamingo legacy config (llama LM, no early exits,
    robot_flamingo/models/flamingo_bc.py:10)."""
    return DeerConfig(
        vit=ViTConfig(),
        perceiver=PerceiverConfig(dim=1024),
        mpt=MPTConfig(d_model=d_model, n_heads=d_model // 128,
                      n_layers=n_layers, vocab_size=32000, arch="llama",
                      alibi=False),
        head=HeadConfig(in_features=d_model, window_size=window_size),
        cross_attn_every_n_layers=4,
        multi_exit=False,
        window_size=window_size,
        dtypes=dtypes,
    )


def deer_tiny(n_layers: int = 4, exit_interval: int = 2, window_size: int = 4,
              dtypes: DTypePolicy = FP32) -> DeerConfig:
    """Small config for CPU tests: same topology, tiny dims."""
    return DeerConfig(
        vit=ViTConfig(image_size=28, patch_size=14, width=64, layers=2, heads=4),
        perceiver=PerceiverConfig(dim=64, depth=2, dim_head=16, heads=4, num_latents=8),
        mpt=MPTConfig(d_model=64, n_heads=4, n_layers=n_layers, vocab_size=128,
                      max_seq_len=64),
        head=HeadConfig(in_features=64, hidden_size=32, lstm_num_layers=2,
                        mlp_hidden_dims=(32, 16), mlp_num_hidden_layers=2,
                        window_size=window_size),
        cross_attn_every_n_layers=1,
        exit_interval=exit_interval,
        text_len=8,
        media_token_id=125,
        eoc_token_id=126,
        window_size=window_size,
        dtypes=dtypes,
    )


# the JAX package's registry keys (mirrors the reference's factory mpt_dict)
MODEL_REGISTRY = {
    "mpt_dolly_3b": deer_3b,
    "mpt_9b": deer_9b,
    "llama_9b": bc_llama,
    "tiny": deer_tiny,
}
