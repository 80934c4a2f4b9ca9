"""Dynamic-exit serving engine: the port of ``eval/scan_policy.py``.

The JAX engine runs the decoder as one ``lax.while_loop``; here the loop is
a host loop over SEGMENTS (``stride`` layers, then one exit check).  Each
check ends in one host read of "have all streams exited?", so a step syncs
at most once per exit (6 times for deer_3b).  The layer index reaches the
indexed-matmul kernel as a device tensor, so nothing else in the loop
depends on the host.  The kernels (K2, or K3 / K4 quantized) implement the
MPT block's four products; a llama decoder (bc_llama) runs each layer's
slice through ``linear``, as the JAX engine computes it outside any Pallas
kernel, and refuses ``indexed_mm``.

Semantics kept exactly:
  * the first exit of every timestep compares against the pseudo action
    from the layer below it; later exits against the previous exit's action;
  * the head eats fp32 activations and its carry is fp32;
  * an exit fires where ``~done & (delta <= thresholds[..., i])``, with
    (n_layers,) or per-stream (B, n_layers) threshold rows;
  * exactly one carry is committed per stream, from its chosen exit.

``encode`` / ``step_from_encoded`` split the step at the encoded prefix (the
vision cache reuses a prefix); ``encode_frame`` / ``step_from_tokens`` split
it at the per-frame ViT tokens (the rolling frame cache of the
window-folded variants); ``dispatch_batch`` / ``finish_batch`` split
``step_batch`` for the pipelined batched rollout.  Every vision, state and
window variant of the JAX package is served: state models take a proprio
row an image row (``state=``), 'vit_concat' and ``use_hist`` take each
stream's rolling W-frame window as W image rows (``folded_window``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.models.flamingo import (dual_camera_tokens,
                                                encode_vision,
                                                fuse_vision_tokens)
from deer_vla_tpu_torch.models.gated_xattn import gated_xattn_forward
from deer_vla_tpu_torch.models.heads import (any_head_forward, any_head_step,
                                             any_zero_carry,
                                             head_action_width,
                                             head_gripper_width, reset_carry,
                                             select_carry)
from deer_vla_tpu_torch.models.llama import llama_block_forward, rope_tables
from deer_vla_tpu_torch.models.mpt import (embed_tokens, make_attn_bias,
                                           mpt_block_forward,
                                           mpt_block_forward_stacked)
from deer_vla_tpu_torch.models.perceiver import stack_perceiver_layers
from deer_vla_tpu_torch.models.value_net import get_delta
from deer_vla_tpu_torch.models.vit import stack_vit_blocks
from deer_vla_tpu_torch.ops.layers import (layer_slice, stack_layer_tree,
                                           tree_map)
from deer_vla_tpu_torch.ops.quant import quantize_serving_stacked


def xattn_index(cfg: DeerConfig) -> np.ndarray:
    """Decoder layer -> row of the stacked cross-attention tree."""
    n_x = sum(cfg.has_xattn(i) for i in range(cfg.n_layers))
    xidx = np.zeros(cfg.n_layers, np.int64)
    j = 0
    for i in range(cfg.n_layers):
        xidx[i] = min(j, n_x - 1)
        j += cfg.has_xattn(i)
    return xidx


def prune_encoder_params(params: dict) -> dict:
    """The unstacked leaves the encode prefix reads: the ViT / perceiver(s)
    non-layer leaves, the token embedding, and the state projection and
    frame embeddings of the variants that have them (the layers ride the
    stacked encoder tree)."""
    vit = {k: v for k, v in params["vit"].items() if k != "blocks"}
    vit["blocks"] = []
    out = {"vit": vit, "decoder": {"wte": params["decoder"]["wte"]}}
    for pk in ("perceiver", "perceiver_gripper"):
        if pk in params:
            per = {k: v for k, v in params[pk].items() if k != "layers"}
            per["layers"] = []
            out[pk] = per
    for key in ("state_fc", "frame_embs"):
        if key in params:
            out[key] = params[key]
    return out


def stack_encoder_layers(params: dict, cdt) -> dict:
    out = {"vit": stack_vit_blocks(params["vit"], cdt)}
    for pk in ("perceiver", "perceiver_gripper"):
        if pk in params:
            out[pk] = stack_perceiver_layers(params[pk], cdt)
    return out


def stack_decoder_layers(params: dict, cfg: DeerConfig,
                         include_encoders: bool = False) -> dict:
    """Per-layer decoder (and optionally encoder) weights stacked with a
    leading L dim, matmul weights cast to the compute dtype.  ``layer_idx``
    holds 0..L-1 as int32 on the weights' device: row i is the device-side
    index the indexed-matmul kernel reads."""
    cdt = cfg.dtypes.cdt
    blocks = stack_layer_tree(params["decoder"]["blocks"], cdt)
    xattn = stack_layer_tree(
        [x for x in params["decoder"]["xattn"] if x is not None], cdt)
    dev = params["decoder"]["wte"]["w"].device
    out = {"blocks": blocks, "xattn": xattn,
           "layer_idx": torch.arange(cfg.n_layers, dtype=torch.int32,
                                     device=dev)}
    if include_encoders:
        out.update(stack_encoder_layers(params, cdt))
    return out


def prune_serving_params(params: dict, cfg: DeerConfig) -> dict:
    """Only the unstacked leaves the step reads: ViT / perceiver non-layer
    leaves, the token embedding and the one exit head."""
    head_key = "lm_head" if cfg.share_exit else "extra_exit"
    return dict(prune_encoder_params(params), **{head_key: params[head_key]})


def check_serving_supported(cfg: DeerConfig,
                            allow_window_folded: bool = False,
                            allow_any_head: bool = False) -> None:
    """The engines serve per-frame media; 'vit_concat' and ``use_hist`` fold
    the frame window into the media or the head, which only the engines
    that feed a rolling window serve (``allow_window_folded``: the scan
    engine and ``DeerPolicy``).  Both at once is refused, as in the JAX
    package.  The fc, gpt and diffusion heads serve through the engines
    that route every head family (``allow_any_head``: the scan engine and
    ``DeerPolicy``)."""
    if cfg.fusion_mode == "vit_concat" and not allow_window_folded:
        raise NotImplementedError(
            "this engine does not serve --fusion_mode vit_concat; use the "
            "scan engine (ScanDeerPolicy) with the windowed adapter")
    if cfg.use_hist and not allow_window_folded:
        raise NotImplementedError(
            "this engine does not serve --use_hist; use the scan engine "
            "(ScanDeerPolicy) with the windowed adapter (per-frame text + "
            "full-window head, flamingo_mpt.py:700-740)")
    if cfg.use_hist and cfg.fusion_mode == "vit_concat":
        raise NotImplementedError(
            "use_hist + vit_concat combined serving is undefined (per-frame "
            "text vs per-trajectory media); train/serve one or the other")
    if cfg.head_type != "deterministic" and not allow_any_head:
        raise NotImplementedError(
            f"this engine hardcodes the LSTM head; head_type "
            f"{cfg.head_type!r} serves through ScanDeerPolicy or "
            "DeerPolicy (cli.eval routes it automatically)")


def folded_window(cfg: DeerConfig) -> int:
    """Frames a step's image rows hold a stream: the window for the
    window-folded variants ('vit_concat', ``use_hist``), else 1."""
    return (cfg.window_size
            if cfg.fusion_mode == "vit_concat" or cfg.use_hist else 1)


def build_scan_step(cfg: DeerConfig, exit_ids: List[int],
                    threshold_type: str = "L2",
                    max_layer: Optional[int] = None,
                    indexed_mm: bool = False):
    """Returns (exits, encode, decode, encode_frame, decode_tokens), routed
    by ``cfg.head_type`` (``models/heads``; for diffusion the "arm" is the
    chosen exit's conditioning feature and the gripper a zero).

    ``encode(params, stacked, img, grip, ids, state=None)`` -> (media, x,
    media locations); ``decode(params, stacked, media, x, mloc, mask,
    carry, thresholds, state=None)`` -> (arm (B, 6k), grip (B, k), carry,
    exit_layer (B,) int32, x) where ``thresholds`` is (n_layers,) or
    (B, n_layers) with +1e30 at the forced last exit and -1e30 at non-exit
    layers, and ``x`` is the hidden state after the last decoder layer that
    ran.  ``encode_frame(params, stacked, img, grip)`` -> both cameras' ViT
    tokens of the frames given, and ``decode_tokens(params, stacked,
    tok_rgb, tok_grip, ids, mask, carry, thresholds, state=None)`` fuses a
    window of such tokens and decodes (the rolling frame cache).

    Window-folded models (``folded_window`` W > 1) take B*W stream-major
    frame rows: 'vit_concat' with B text rows (the window folded into the
    media, the head on the last frame's state), ``use_hist`` with B*W
    text rows (the head runs the whole window each step, the window being
    its memory, and emits the last step's action; its carry stays).
    ``state`` rows match the image rows.
    ``indexed_mm`` raises on a llama decoder: the layer-indexed kernels
    compute the MPT block's products (fused wqkv, out_proj, mlp_up,
    mlp_down), which a llama block does not have."""
    llama = cfg.mpt.arch == "llama"
    if indexed_mm and llama:
        raise ValueError("indexed_mm covers the MPT block's products "
                         "(K2-K4); a 'llama' decoder serves with "
                         "indexed_mm=False")
    ml = (max_layer if max_layer is not None else cfg.n_layers) - 1
    exits = [e for e in exit_ids if e <= ml]
    if not exits:
        raise ValueError(
            f"max_layer={max_layer} sits below the first exit layer "
            f"{exit_ids[0] + 1} (exit ids {list(exit_ids)})")
    last_exit = exits[-1]
    is_exit = np.zeros(cfg.n_layers, bool)
    is_exit[exits] = True
    # uniform exit spacing: one segment = `stride` layers + one head check
    seg_bounds = [-1] + exits
    seg_lens = {seg_bounds[i + 1] - seg_bounds[i] for i in range(len(exits))}
    use_strided = len(seg_lens) == 1
    stride = seg_lens.pop() if use_strided else 1
    n_segments = len(exits)
    xidx = xattn_index(cfg)
    has_xattn = [cfg.has_xattn(i) for i in range(cfg.n_layers)]
    head_key = "lm_head" if cfg.share_exit else "extra_exit"
    adim = head_action_width(cfg)
    gdim = head_gripper_width(cfg)
    enc_w = folded_window(cfg)

    def encode(params, stacked, img, grip, ids, state=None):
        media = encode_vision(params, img, grip, cfg, state, stacked,
                              window_size=enc_w)
        x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
        return media, x, ids == cfg.media_token_id

    def encode_frame(params, stacked, img, grip):
        return dual_camera_tokens(params, img, grip, cfg, stacked)

    def decode_tokens(params, stacked, tok_rgb, tok_grip, ids, mask, carry,
                      thresholds, state=None):
        media = fuse_vision_tokens(params, tok_rgb, tok_grip, cfg, state,
                                   stacked, window_size=enc_w)
        x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
        return decode(params, stacked, media, x, ids == cfg.media_token_id,
                      mask, carry, thresholds, state)

    def decode(params, stacked, media, x, mloc, mask, carry, thresholds,
               state=None):
        attn_bias = make_attn_bias(mask, cfg.mpt, x.dtype)
        rope = (rope_tables(x.shape[1], cfg.mpt.head_dim, device=x.device)
                if llama else None)
        head = params[head_key]
        # streams: the text rows, a window of them each under use_hist
        b = x.shape[0] // (enc_w if cfg.use_hist else 1)
        dev = x.device
        hstate = state
        if state is not None and enc_w > 1 and cfg.fusion_mode == "vit_concat":
            hstate = state.reshape((b, enc_w) + state.shape[1:])[:, -1]

        def eval_head(x_in):
            if cfg.use_hist:
                out = any_head_forward(head, x_in.float(), cfg, hstate,
                                       window=enc_w, last_action=True)
                cand = carry
            else:
                out, cand = any_head_step(head, x_in.float(), carry, cfg,
                                          hstate)
            return (out.actions[:, 0].float(), out.gripper_probs[:, 0].float(),
                    cand)

        def run_layer(i, x):
            """(layer input == hidden_states[i-1], layer output)."""
            x_in = x
            if has_xattn[i]:
                x = gated_xattn_forward(
                    layer_slice(stacked["xattn"], int(xidx[i])), x, media,
                    mloc, heads=cfg.xattn_heads, dim_head=cfg.xattn_dim_head,
                    only_attend_immediate_media=cfg.only_attend_immediate_media)
            if llama:
                return x_in, llama_block_forward(
                    layer_slice(stacked["blocks"], i), x, attn_bias, cfg.mpt,
                    rope)
            if indexed_mm:
                return x_in, mpt_block_forward_stacked(
                    stacked["blocks"], i, x, attn_bias, cfg.mpt,
                    stacked["layer_idx"][i])
            return x_in, mpt_block_forward(layer_slice(stacked["blocks"], i),
                                           x, attn_bias, cfg.mpt)

        st = {"done": torch.zeros(b, dtype=torch.bool, device=dev),
              "ref": torch.zeros(b, adim, device=dev),
              "arm": torch.zeros(b, adim, device=dev),
              "grip": torch.zeros(b, gdim, device=dev),
              "carry": carry,
              "exit": torch.full((b,), -1, dtype=torch.int32, device=dev)}

        def check(i, is_first, x, x_prev) -> bool:
            """Speculative head + delta at exit layer i, commit for the
            streams that take it; True when every stream has exited (the
            step's one host sync per exit)."""
            arm, grip, cand = eval_head(x)
            ref = eval_head(x_prev)[0] if is_first else st["ref"]
            delta = get_delta(arm, ref, threshold_type)
            done = st["done"]
            take = ~done & (delta <= thresholds[..., i])
            st["ref"] = torch.where(done[:, None], st["ref"], arm)
            st["arm"] = torch.where(take[:, None], arm, st["arm"])
            st["grip"] = torch.where(take[:, None], grip, st["grip"])
            st["carry"] = select_carry(cfg, take, cand, st["carry"])
            st["exit"] = st["exit"].masked_fill(take, i)
            st["done"] = done | take
            return bool(st["done"].all())

        if use_strided:
            for j in range(n_segments):
                x_prev = x
                for off in range(stride):
                    x_prev, x = run_layer(j * stride + off, x)
                if check(j * stride + stride - 1, j == 0, x, x_prev):
                    break
        else:
            for i in range(last_exit + 1):
                x_prev, x = run_layer(i, x)
                if is_exit[i] and check(i, i == exits[0], x, x_prev):
                    break
        return st["arm"], st["grip"], st["carry"], st["exit"], x

    return exits, encode, decode, encode_frame, decode_tokens


class HostInputs:
    """Moves a step's host inputs to ``self.device``: frames and proprio
    rows (numpy or tensors) as fp32, token ids checked against the
    vocabulary first, the attention mask as given."""

    def _upload(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _ids(self, input_ids) -> torch.Tensor:
        """Token ids are checked on the host before upload: an id outside
        [0, vocab_size) raises instead of gathering garbage."""
        ids = (input_ids.cpu().numpy() if isinstance(input_ids, torch.Tensor)
               else np.asarray(input_ids))
        vocab = self.cfg.mpt.vocab_size
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(f"token ids outside [0, {vocab}): min "
                             f"{ids.min()}, max {ids.max()}")
        return torch.as_tensor(ids.astype(np.int64), device=self.device)

    def _image(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _state(self, state) -> Optional[torch.Tensor]:
        """Proprio rows (numpy or a tensor) as fp32, or None."""
        return None if state is None else self._image(state)


def host_actions(arm: np.ndarray, grip: np.ndarray, k: int) -> np.ndarray:
    """(B, 6k) arm and (B, k) gripper probabilities -> (B, 7) actions, or
    (B, k, 7) plans for multi_step_action k > 1, the gripper at +-1."""
    b = arm.shape[0]
    g = np.where(grip > 0.5, 1.0, -1.0)
    if k > 1:
        acts = np.concatenate([arm.reshape(b, k, 6), g[:, :, None]], -1)
    else:
        acts = np.concatenate([arm, g], -1)
    return acts.astype(np.float32)


class ScanDeerPolicy(nn.Module, HostInputs):
    """Dynamic-exit policy over B >= 1 streams.  The weights (stacked
    layers and the pruned unstacked leaves) are registered buffers; the
    device is explicit and defaults to the card.  ``quantize`` is None or
    one of ``ops.quant.QUANT_MODES``: "int8" and "int4" serve the decoder
    through K3 / K4 when ``indexed_mm`` is on, the w8a8 modes through
    int8 x int8 -> int32 products.  ``indexed_mm`` needs an MPT decoder:
    on a llama one it raises (``build_scan_step``)."""

    def __init__(self, params: dict, cfg: DeerConfig,
                 exit_ids: Optional[List[int]] = None,
                 thresholds=None, threshold_type: str = "L2",
                 max_layer: Optional[int] = None, steps_per_stage: int = 1,
                 indexed_mm: bool = False, quantize: Optional[str] = None,
                 device=None):
        super().__init__()
        check_serving_supported(cfg, allow_window_folded=True,
                                allow_any_head=True)
        exit_ids = list(exit_ids or cfg.all_exit_ids())
        (self.exits, self._encode, self._decode, self._encode_frame,
         self._decode_tokens) = build_scan_step(
            cfg, exit_ids, threshold_type, max_layer, indexed_mm=indexed_mm)
        self.cfg = cfg
        self.device = resolve_device(device)
        params = to_torch(params, self.device)
        # quantized serving (ops/quant.py QUANT_MODES): the decoder,
        # cross-attention, ViT and perceiver stacks; the embedding and the
        # exit head stay in full precision
        stacked = quantize_serving_stacked(
            stack_decoder_layers(params, cfg, include_encoders=True),
            quantize)
        self._stacked_def = self._register_tree("stacked", stacked)
        self._params_def = self._register_tree(
            "params", prune_serving_params(params, cfg))
        self.steps_per_stage = steps_per_stage
        self.set_thresholds(thresholds if thresholds is not None
                            else [1e8] * len(self.exits))
        self._carry_rows = None
        self.reset()

    # -- weights -----------------------------------------------------------
    def _register_tree(self, prefix: str, tree):
        """Register every tensor leaf as a buffer named by its path; return
        the tree with buffer names in place of the tensors."""
        def walk(node, path):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: walk(v, path + (str(k),)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            name = "__".join(path)
            self.register_buffer(name, node)
            return name
        return walk(tree, (prefix,))

    @property
    def params(self) -> dict:
        return tree_map(lambda name: getattr(self, name), self._params_def)

    @property
    def stacked(self) -> dict:
        return tree_map(lambda name: getattr(self, name), self._stacked_def)

    # -- thresholds --------------------------------------------------------
    def threshold_row(self, thresholds) -> np.ndarray:
        """One per-exit threshold list/dict -> the (n_layers,) runtime row:
        -1e30 at non-exit layers, the value at each exit, +1e30 at the last
        exit (always fires)."""
        if isinstance(thresholds, dict):
            thresholds = [thresholds[e] for e in self.exits]
        if len(thresholds) != len(self.exits):
            raise ValueError(f"{len(thresholds)} thresholds for exits "
                             f"{self.exits}")
        full = np.full(self.cfg.n_layers, -1e30, np.float32)
        for e, t in zip(self.exits, thresholds):
            full[e] = t
        full[self.exits[-1]] = 1e30
        return full

    def set_thresholds(self, thresholds) -> None:
        self.thresholds = self._upload(self.threshold_row(thresholds))

    def set_thresholds_batch(self, rows) -> None:
        """One per-exit threshold list/dict per stream -> (B, n_layers)."""
        self.thresholds = self._upload(
            np.stack([self.threshold_row(th) for th in rows]))

    def set_threshold_array(self, arr) -> None:
        """Raw (n_layers,) or (B, n_layers) row array, laid out as
        threshold_row builds it."""
        self.thresholds = self._upload(np.asarray(arr, np.float32))

    def _stage_thresholds(self) -> torch.Tensor:
        """steps_per_stage > 1: mid-stage, force the exit at the previous
        step's layer."""
        if (self.steps_per_stage <= 1
                or self.cur_step % self.steps_per_stage == 0
                or self.last_exit_layer < 0):
            return self.thresholds
        full = np.full(self.cfg.n_layers, -1e30, np.float32)
        full[self.last_exit_layer] = 1e30
        return self._upload(full)

    # -- episode state -----------------------------------------------------
    def reset(self) -> None:
        self.carry = None
        self.cur_step = 0
        self.last_exit_layer = -1
        self.last_hidden = None

    def set_timestep(self, t: int) -> None:
        self.cur_step = t

    def _ensure_carry(self, text_rows: int) -> None:
        """A fresh carry when the stream count changes: one stream a text
        row, a window of text rows each under ``use_hist``."""
        b = text_rows // (self.cfg.window_size if self.cfg.use_hist else 1)
        if self.carry is None or self._carry_rows != b:
            self.carry = any_zero_carry(self.cfg, b, device=self.device)
        self._carry_rows = b

    @torch.inference_mode()
    def reset_streams(self, stream_mask) -> None:
        """Zero the carry of the streams where ``stream_mask`` is true, by
        carry layout (the fc head has none)."""
        if self.carry is None:
            return
        m = torch.as_tensor(np.asarray(stream_mask, bool), device=self.device)
        self.carry = reset_carry(self.cfg, self.carry, m)

    # -- inputs --------------------------------------------------------------
    def _run(self, image, gripper, input_ids, attention_mask, thresholds,
             state=None):
        state = self._state(state)
        media, x, mloc = self.encode(image, gripper, input_ids, state)
        return self._run_decode(media, x, mloc, attention_mask, thresholds,
                                state)

    def _run_decode(self, media, x, mloc, attention_mask, thresholds,
                    state=None):
        self._ensure_carry(x.shape[0])
        arm, grip, self.carry, exit_layer, self.last_hidden = self._decode(
            self.params, self.stacked, media, x, mloc,
            self._upload(attention_mask), self.carry, thresholds,
            self._state(state))
        return arm, grip, exit_layer

    # -- serving -----------------------------------------------------------
    @torch.inference_mode()
    def step(self, image, gripper, input_ids, attention_mask,
             state=None) -> np.ndarray:
        """One env step of one stream: a 7-dof action (or a (k, 7) plan
        for multi_step_action k > 1).  Window-folded models take the
        stream's W frames as image rows (``folded_window``); ``state``
        (state models) one proprio row an image row."""
        if state is not None and state.shape[0] != image.shape[0]:
            raise ValueError(
                f"state rows ({state.shape[0]}) must match the image batch "
                f"({image.shape[0]}): window-folded models take one proprio "
                "row a frame of the rolling window")
        arm, grip, exit_layer = self._run(image, gripper, input_ids,
                                          attention_mask,
                                          self._stage_thresholds(), state)
        self.last_exit_layer = int(exit_layer[0])
        return self._postprocess(arm, grip)

    @torch.inference_mode()
    def encode(self, image, gripper, input_ids, state=None):
        """The vision and embedding prefix on its own: (media, x,
        media_locations) on the device, for ``step_from_encoded``."""
        return self._encode(self.params, self.stacked, self._image(image),
                            self._image(gripper), self._ids(input_ids),
                            self._state(state))

    @torch.inference_mode()
    def step_from_encoded(self, media, x, mloc, attention_mask,
                          state=None) -> np.ndarray:
        """``step`` from a (possibly cached) encoded prefix."""
        arm, grip, exit_layer = self._run_decode(media, x, mloc,
                                                 attention_mask,
                                                 self._stage_thresholds(),
                                                 state)
        self.last_exit_layer = int(exit_layer[0])
        return self._postprocess(arm, grip)

    @torch.inference_mode()
    def encode_frame(self, image, gripper):
        """Both cameras' ViT tokens of the frames given (per frame and
        independent of the window position): the rolling frame cache's
        encode half (``eval/caching.FrameCachePolicy``)."""
        return self._encode_frame(self.params, self.stacked,
                                  self._image(image), self._image(gripper))

    @torch.inference_mode()
    def step_from_tokens(self, tok_rgb, tok_grip, input_ids, attention_mask,
                         state=None) -> np.ndarray:
        """One env step from a window of cached per-frame ViT tokens:
        perceiver, window fold and the dynamic-exit decode."""
        ids = self._ids(input_ids)
        self._ensure_carry(ids.shape[0])
        arm, grip, self.carry, exit_layer, self.last_hidden = \
            self._decode_tokens(self.params, self.stacked, tok_rgb, tok_grip,
                                ids, self._upload(attention_mask),
                                self.carry, self._stage_thresholds(),
                                self._state(state))
        self.last_exit_layer = int(exit_layer[0])
        return self._postprocess(arm, grip)

    @torch.inference_mode()
    def run_batch(self, image, gripper, input_ids, attention_mask,
                  state=None):
        """``step_batch``'s step on the device: (arm (B, 6k), gripper
        (B, k), exit layers (B,)) as device tensors, the carry committed.
        Window-folded models take B*W stream-major frame rows, and B text
        rows ('vit_concat') or B*W (``use_hist``, the goal tiled a
        frame)."""
        w = folded_window(self.cfg)
        streams = input_ids.shape[0] // (w if self.cfg.use_hist else 1)
        if image.shape[0] != streams * w:
            raise ValueError(
                f"batched window-folded step: image rows ({image.shape[0]}) "
                f"must be streams*window ({streams}*{w}) stream-major frame "
                "windows")
        return self._run(image, gripper, input_ids, attention_mask,
                         self.thresholds, state)

    def dispatch_batch(self, image, gripper, input_ids, attention_mask,
                       state=None):
        """The first half of ``step_batch``: runs the step, commits the
        carry, and starts copying (arm, grip, exit) to the host.

        The decode reads the host once per exit segment, so this returns
        only after the layer loop has ended; what it defers is the
        device-to-host copy of the step's outputs, a ``non_blocking`` copy
        into pinned memory with an event that ``finish_batch`` waits on.
        The pipelined rollout steps another lane group's envs meanwhile;
        true overlap of one group's layers with another's host work waits
        for a loop without host reads (ROADMAP.md M7b).  The rows are
        ``run_batch``'s."""
        outs = self.run_batch(image, gripper, input_ids, attention_mask,
                              state)
        if self.device.type != "cuda":
            return outs + (None,)
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in outs)
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host + (copied,)

    def finish_batch(self, handles):
        """The blocking half: waits for the copy, then (actions (B, 7) or
        (B, k, 7) plans, exit_layers (B,) int64); a diffusion model's
        (B, hidden) features in place of the actions."""
        arm, grip, exit_layer, copied = handles
        if copied is not None:
            copied.synchronize()
        exits = exit_layer.cpu().numpy().astype(np.int64)
        if self.cfg.head_type == "diffusion":
            # the chosen exits' (B, hidden) features, as ``step`` gives
            return arm.float().cpu().numpy(), exits
        return (host_actions(arm.cpu().numpy(), grip.cpu().numpy(),
                             self.cfg.head.multi_step_action), exits)

    def step_batch(self, image, gripper, input_ids, attention_mask,
                   state=None):
        """B parallel streams with per-stream exits: (actions (B, 7) or
        (B, k, 7), exit_layers (B,) int64)."""
        return self.finish_batch(self.dispatch_batch(
            image, gripper, input_ids, attention_mask, state))

    def _postprocess(self, arm, grip) -> np.ndarray:
        if self.cfg.head_type == "diffusion":
            # the chosen exit's conditioning feature, for the DDPM sampler
            # (eval/diffusion_policy.DiffusionSamplerPolicy)
            return arm[0].float().cpu().numpy()
        return host_actions(arm[:1].cpu().numpy(), grip[:1].cpu().numpy(),
                            self.cfg.head.multi_step_action)[0]
