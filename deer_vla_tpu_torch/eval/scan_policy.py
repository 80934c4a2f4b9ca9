"""Dynamic-exit serving engine: the port of ``eval/scan_policy.py``.

The JAX engine runs the decoder as one ``lax.while_loop``; here the loop is
a host loop over SEGMENTS (``decode_segments``).  Segment j is a function
of explicit tensors: it runs the layers after exit j - 1 up to exit j,
then the exit check (head, delta, commit), and returns the hidden state
and the exit state (``done``, ``ref``, ``arm``, ``grip``, ``carry``,
``exit``).  The loop reads "have all streams exited?" once after each
segment, so a step syncs at most once per exit (6 times for deer_3b).  The
layer index reaches the indexed-matmul kernel as a device tensor, so
nothing else in a segment depends on the host, and each segment (and the
encode prefix) can be exported as one program (``serving/export.py``),
which the artifact runs in the same loop.  The kernels (K2, or K3 / K4
quantized) implement the MPT block's four products; a llama decoder
(bc_llama) runs each layer's slice through ``linear``, as the JAX engine
computes it outside any Pallas kernel, and refuses ``indexed_mm``.

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
``step_batch`` for the pipelined batched rollout: ``dispatch_batch`` hands
the step to the engine's worker thread (``eval/step_worker.py``) and
returns at once, as JAX's dispatch does.  Every vision, state and
window variant of the JAX package is served: state models take a proprio
row an image row (``state=``), 'vit_concat' and ``use_hist`` take each
stream's rolling W-frame window as W image rows (``folded_window``).

Tensor parallelism (``tp``, this rank's ``parallel.mesh.AxisGroup`` of the
tp axis): the engine takes this rank's local tree
(``parallel.sharding.shard_params(..., tp=True)``) and stacks it, so K2-K4
read contiguous (L, K_loc, N_loc) stacks (quantized as the whole weight
would be, then split: ``ops/quant.py``); the row-parallel products are
summed over the group.  Every exit test reads values that are equal on
every rank (the heads run on the summed hidden state, replicated), so the
ranks break out of the layer loop together; ``check_tp_exits`` gathers
the exit layers after each step and raises where the ranks differ.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.eval.step_worker import (Dispatched, StepWorker,
                                                 run_inline)
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


class ScanStep(NamedTuple):
    """What ``build_scan_step`` returns (its docstring has the
    signatures)."""
    exits: List[int]
    encode: Callable
    decode: Callable
    encode_frame: Callable
    decode_tokens: Callable
    first_segment: Callable
    segments: Sequence[Callable]


def decode_segments(first_segment, segments, params, stacked, media, x,
                    mloc, mask, carry, thresholds, state=None):
    """The dynamic-exit decode as a host loop over exit segments:
    ``first_segment`` (the step's context, then segment 0), then each of
    ``segments`` (1, 2, ...) until every stream has exited.  The one host
    read a segment is ``bool(done.all())``.  Returns (arm, grip, carry,
    exit layer, hidden state after the last layer run).  The live engine
    and the serving artifact both decode through it, with the same segment
    functions or the programs exported from them."""
    x, ctx, st = first_segment(params, stacked, media, mloc, x, mask, carry,
                               thresholds, state)
    if not bool(st["done"].all()):
        for segment in segments:
            x, st = segment(params, stacked, media, mloc, ctx, thresholds,
                            x, st)
            if bool(st["done"].all()):
                break
    return st["arm"], st["grip"], st["carry"], st["exit"], x


def build_scan_step(cfg: DeerConfig, exit_ids: List[int],
                    threshold_type: str = "L2",
                    max_layer: Optional[int] = None,
                    indexed_mm: bool = False, tp=None) -> ScanStep:
    """A ``ScanStep`` routed by ``cfg.head_type`` (``models/heads``; for
    diffusion the "arm" is the chosen exit's conditioning feature and the
    gripper a zero).

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

    ``decode`` is ``decode_segments`` over ``first_segment(params, stacked,
    media, mloc, x, mask, carry, thresholds, state)`` -> (x, ctx, st) and
    ``segments[j - 1](params, stacked, media, mloc, ctx, thresholds, x,
    st)`` -> (x, st) for j >= 1: segment j runs the layers after exit j - 1
    up to exit j, then the exit check.  ``ctx`` holds the step's attention
    bias, rope tables (llama), the head's proprio rows and the incoming
    carry; ``st`` the exit state, a dict of ``done``, ``ref``, ``arm``,
    ``grip``, ``carry`` and ``exit`` tensors.  Uniformly spaced and
    non-uniform exits are the same loop.

    Window-folded models (``folded_window`` W > 1) take B*W stream-major
    frame rows: 'vit_concat' with B text rows (the window folded into the
    media, the head on the last frame's state), ``use_hist`` with B*W
    text rows (the head runs the whole window each step, the window being
    its memory, and emits the last step's action; its carry stays).
    ``state`` rows match the image rows.
    ``indexed_mm`` raises on a llama decoder: the layer-indexed kernels
    compute the MPT block's products (fused wqkv, out_proj, mlp_up,
    mlp_down), which a llama block does not have.  ``tp``: the stacks are a
    tp rank's local ones (the module docstring)."""
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
    seg_bounds = [-1] + exits
    xidx = xattn_index(cfg)
    has_xattn = [cfg.has_xattn(i) for i in range(cfg.n_layers)]
    head_key = "lm_head" if cfg.share_exit else "extra_exit"
    adim = head_action_width(cfg)
    gdim = head_gripper_width(cfg)
    enc_w = folded_window(cfg)

    def encode(params, stacked, img, grip, ids, state=None):
        media = encode_vision(params, img, grip, cfg, state, stacked,
                              window_size=enc_w, tp=tp)
        x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
        return media, x, ids == cfg.media_token_id

    def encode_frame(params, stacked, img, grip):
        return dual_camera_tokens(params, img, grip, cfg, stacked)

    def decode_tokens(params, stacked, tok_rgb, tok_grip, ids, mask, carry,
                      thresholds, state=None):
        media = fuse_vision_tokens(params, tok_rgb, tok_grip, cfg, state,
                                   stacked, window_size=enc_w, tp=tp)
        x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
        return decode(params, stacked, media, x, ids == cfg.media_token_id,
                      mask, carry, thresholds, state)

    def begin(x, mask, carry, state):
        """(ctx, st) before the first layer: the step's attention bias, rope
        tables, head proprio rows and incoming carry (every exit's head
        steps from it), and the exit state of no exit yet."""
        # streams: the text rows, a window of them each under use_hist
        b = x.shape[0] // (enc_w if cfg.use_hist else 1)
        dev = x.device
        hstate = state
        if state is not None and enc_w > 1 and cfg.fusion_mode == "vit_concat":
            hstate = state.reshape((b, enc_w) + state.shape[1:])[:, -1]
        ctx = {"attn_bias": make_attn_bias(mask, cfg.mpt, x.dtype, tp),
               "rope": (rope_tables(x.shape[1], cfg.mpt.head_dim,
                                    device=x.device) if llama else None),
               "hstate": hstate, "carry": carry}
        st = {"done": torch.zeros(b, dtype=torch.bool, device=dev),
              "ref": torch.zeros(b, adim, device=dev),
              "arm": torch.zeros(b, adim, device=dev),
              "grip": torch.zeros(b, gdim, device=dev),
              "carry": carry,
              "exit": torch.full((b,), -1, dtype=torch.int32, device=dev)}
        return ctx, st

    def eval_head(params, ctx, x_in):
        head = params[head_key]
        if cfg.use_hist:
            out = any_head_forward(head, x_in.float(), cfg, ctx["hstate"],
                                   window=enc_w, last_action=True)
            cand = ctx["carry"]
        else:
            out, cand = any_head_step(head, x_in.float(), ctx["carry"], cfg,
                                      ctx["hstate"])
        return (out.actions[:, 0].float(), out.gripper_probs[:, 0].float(),
                cand)

    def run_layer(stacked, i, x, media, mloc, ctx):
        """Layer i's output (its input is hidden_states[i-1])."""
        if has_xattn[i]:
            x = gated_xattn_forward(
                layer_slice(stacked["xattn"], int(xidx[i])), x, media,
                mloc, heads=cfg.xattn_heads, dim_head=cfg.xattn_dim_head,
                only_attend_immediate_media=cfg.only_attend_immediate_media,
                tp=tp)
        if llama:
            return llama_block_forward(layer_slice(stacked["blocks"], i), x,
                                       ctx["attn_bias"], cfg.mpt,
                                       ctx["rope"])
        if indexed_mm:
            return mpt_block_forward_stacked(
                stacked["blocks"], i, x, ctx["attn_bias"], cfg.mpt,
                stacked["layer_idx"][i], tp)
        return mpt_block_forward(layer_slice(stacked["blocks"], i), x,
                                 ctx["attn_bias"], cfg.mpt, tp)

    def check(params, ctx, thresholds, i, is_first, x, x_prev, st):
        """Speculative head + delta at exit layer i, committed for the
        streams that take it; the new exit state.  Under tp, x is the
        summed hidden state, equal on every rank, so every rank reads the
        same ``done`` and leaves the loop at the same layer."""
        arm, grip, cand = eval_head(params, ctx, x)
        ref = eval_head(params, ctx, x_prev)[0] if is_first else st["ref"]
        delta = get_delta(arm, ref, threshold_type)
        done = st["done"]
        take = ~done & (delta <= thresholds[..., i])
        return {"done": done | take,
                "ref": torch.where(done[:, None], st["ref"], arm),
                "arm": torch.where(take[:, None], arm, st["arm"]),
                "grip": torch.where(take[:, None], grip, st["grip"]),
                "carry": select_carry(cfg, take, cand, st["carry"]),
                "exit": st["exit"].masked_fill(take, i)}

    def make_segment(j):
        layers = range(seg_bounds[j] + 1, seg_bounds[j + 1] + 1)

        def segment(params, stacked, media, mloc, ctx, thresholds, x, st):
            x_prev = x
            for i in layers:
                x_prev, x = x, run_layer(stacked, i, x, media, mloc, ctx)
            return x, check(params, ctx, thresholds, exits[j], j == 0, x,
                            x_prev, st)
        return segment

    segment_fns = [make_segment(j) for j in range(len(exits))]

    def first_segment(params, stacked, media, mloc, x, mask, carry,
                      thresholds, state=None):
        ctx, st = begin(x, mask, carry, state)
        x, st = segment_fns[0](params, stacked, media, mloc, ctx,
                               thresholds, x, st)
        return x, ctx, st

    def decode(params, stacked, media, x, mloc, mask, carry, thresholds,
               state=None):
        return decode_segments(first_segment, segment_fns[1:], params,
                               stacked, media, x, mloc, mask, carry,
                               thresholds, state)

    return ScanStep(exits, encode, decode, encode_frame, decode_tokens,
                    first_segment, segment_fns[1:])


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
    on a llama one it raises (``build_scan_step``).  ``tp``: ``params`` is
    this tp rank's local tree and the engine one rank of a tensor-parallel
    group (the module docstring); with ``check_tp_exits`` every step
    checks that the group's ranks took the same exits."""

    def __init__(self, params: dict, cfg: DeerConfig,
                 exit_ids: Optional[List[int]] = None,
                 thresholds=None, threshold_type: str = "L2",
                 max_layer: Optional[int] = None, steps_per_stage: int = 1,
                 indexed_mm: bool = False, quantize: Optional[str] = None,
                 device=None, tp=None, check_tp_exits: bool = False):
        super().__init__()
        check_serving_supported(cfg, allow_window_folded=True,
                                allow_any_head=True)
        exit_ids = list(exit_ids or cfg.all_exit_ids())
        self.scan_step = build_scan_step(cfg, exit_ids, threshold_type,
                                         max_layer, indexed_mm=indexed_mm,
                                         tp=tp)
        (self.exits, self._encode, self._decode, self._encode_frame,
         self._decode_tokens) = self.scan_step[:5]
        self.cfg = cfg
        self.tp = tp
        self.check_tp_exits = check_tp_exits
        self.device = resolve_device(device)
        params = to_torch(params, self.device)
        # quantized serving (ops/quant.py QUANT_MODES): the decoder,
        # cross-attention, ViT and perceiver stacks; the embedding and the
        # exit head stay in full precision
        stacked = quantize_serving_stacked(
            stack_decoder_layers(params, cfg, include_encoders=True),
            quantize, tp=tp)
        self._stacked_def = self._register_tree("stacked", stacked)
        self._params_def = self._register_tree(
            "params", prune_serving_params(params, cfg))
        self.steps_per_stage = steps_per_stage
        self.quantize = quantize
        self._init_dispatch()
        self.set_thresholds(thresholds if thresholds is not None
                            else [1e8] * len(self.exits))
        self._carry_rows = None
        self.reset()

    # -- weights -----------------------------------------------------------
    def _register_tree(self, prefix: str, tree):
        """Register every tensor leaf as a buffer named by its path; return
        the tree with buffer names in place of the tensors, its dicts in
        sorted key order (so the trees an exported program takes do not
        depend on the order a checkpoint or a draw built them in)."""
        def walk(node, path):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: walk(node[k], path + (str(k),))
                        for k in sorted(node, key=str)}
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
        self._check_idle("set_thresholds")
        self.thresholds = self._upload(self.threshold_row(thresholds))

    def set_thresholds_batch(self, rows) -> None:
        """One per-exit threshold list/dict per stream -> (B, n_layers)."""
        self._check_idle("set_thresholds_batch")
        self.thresholds = self._upload(
            np.stack([self.threshold_row(th) for th in rows]))

    def set_threshold_array(self, arr) -> None:
        """Raw (n_layers,) or (B, n_layers) row array, laid out as
        threshold_row builds it."""
        self._check_idle("set_threshold_array")
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
        self._check_idle("reset")
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
        self._check_idle("reset_streams")
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
        self._check_exits(exit_layer)
        return arm, grip, exit_layer

    def _check_exits(self, exit_layer: torch.Tensor) -> None:
        """With ``check_tp_exits``: every rank of the tp group took the
        same exit layers (a debug check: one gather a step)."""
        if not self.check_tp_exits or self.tp is None or self.tp.size == 1:
            return
        from deer_vla_tpu_torch.parallel.collectives import all_gather
        every = all_gather(exit_layer[None], self.tp, 0)
        if not bool((every == exit_layer[None]).all()):
            raise RuntimeError(f"the tp ranks {list(self.tp.ranks)} took "
                               f"different exits: {every.tolist()}")

    # -- serving -----------------------------------------------------------
    @torch.inference_mode()
    def step(self, image, gripper, input_ids, attention_mask,
             state=None) -> np.ndarray:
        """One env step of one stream: a 7-dof action (or a (k, 7) plan
        for multi_step_action k > 1).  Window-folded models take the
        stream's W frames as image rows (``folded_window``); ``state``
        (state models) one proprio row an image row."""
        self._check_idle("step")
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
        self._check_idle("step_from_encoded")
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
        self._check_idle("step_from_tokens")
        ids = self._ids(input_ids)
        self._ensure_carry(ids.shape[0])
        arm, grip, self.carry, exit_layer, self.last_hidden = \
            self._decode_tokens(self.params, self.stacked, tok_rgb, tok_grip,
                                ids, self._upload(attention_mask),
                                self.carry, self._stage_thresholds(),
                                self._state(state))
        self._check_exits(exit_layer)
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

    def _run_to_host(self, image, gripper, input_ids, attention_mask,
                     state=None):
        """``run_batch``, then (arm, grip, exit) started on their way to
        the host: on the card a ``non_blocking`` copy into pinned memory
        and the event that marks its end."""
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

    def _init_dispatch(self) -> None:
        """``dispatch_batch``'s worker thread, shared by shallow copies (the
        pipelined rollout's lane groups) and stopped when this engine is
        collected; no step in flight."""
        self._worker = StepWorker()
        weakref.finalize(self, self._worker.close)
        self._in_flight: Optional[Dispatched] = None

    def _check_idle(self, what: str) -> None:
        """A dispatched step owns this engine's carry and threshold rows
        until ``finish_batch`` (or ``settle``) has waited on it."""
        if self._in_flight is not None:
            raise RuntimeError(f"{what} while a dispatched step is in "
                               "flight: finish_batch it first")

    def submit(self, fn: Callable) -> Dispatched:
        """Run ``fn()`` (a step that reads or writes this engine's state) on
        the engine's worker thread, after the steps dispatched before it;
        returns its handle at once.  Until the handle is waited on
        (``collect`` / ``settle``) the engine refuses another dispatch and
        any change to its carry or threshold rows."""
        self._check_idle("dispatch_batch")
        handle = self._worker.submit(fn, self.device)
        self._in_flight = handle
        return handle

    def collect(self, handle: Dispatched):
        """Wait for ``handle`` and return its step's result; the step's
        exception, if it raised, is raised here."""
        try:
            return handle.wait()
        finally:
            if self._in_flight is handle:
                self._in_flight = None

    def settle(self, handle: Dispatched) -> None:
        """Wait for ``handle`` and drop its result and any error: for a
        caller that is leaving on another error and must leave no step
        running (the rollout's ``finally``)."""
        try:
            self.collect(handle)
        except Exception:  # noqa: BLE001 - the caller's error is raised
            pass

    def close(self) -> None:
        """Stop the worker thread (after the steps already dispatched); a
        later ``dispatch_batch`` starts a new one."""
        self._worker.close()

    def dispatch_batch(self, image, gripper, input_ids, attention_mask,
                       state=None) -> Dispatched:
        """The first half of ``step_batch``, asynchronous as JAX's
        dispatch is: hands the step (``run_batch``, the carry committed,
        then the outputs' copy into pinned memory) to the engine's worker
        thread and returns its handle at once, so the caller can step
        other envs while the layers run.  Steps run in the order they were
        dispatched, shallow copies included (they share the worker), on
        the caller's device and CUDA stream under the caller's grad and
        inference modes.  The inputs must not change until
        ``finish_batch``; meanwhile the engine refuses another dispatch
        and any change to its carry or thresholds.  The rows are
        ``run_batch``'s."""
        return self.submit(functools.partial(
            self._run_to_host, image, gripper, input_ids, attention_mask,
            state))

    def finish_batch(self, handle: Dispatched):
        """The blocking half: waits for the step and its copy (a step's
        exception is raised here), then (actions (B, 7) or (B, k, 7)
        plans, exit_layers (B,) int64); a diffusion model's (B, hidden)
        features in place of the actions."""
        arm, grip, exit_layer, copied = self.collect(handle)
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
        (B, k, 7), exit_layers (B,) int64).  The step runs on the calling
        thread, then goes through ``finish_batch`` as a dispatched one
        does: the same outputs."""
        self._check_idle("step_batch")
        return self.finish_batch(run_inline(functools.partial(
            self._run_to_host, image, gripper, input_ids, attention_mask,
            state), self.device))

    def _postprocess(self, arm, grip) -> np.ndarray:
        if self.cfg.head_type == "diffusion":
            # the chosen exit's conditioning feature, for the DDPM sampler
            # (eval/diffusion_policy.DiffusionSamplerPolicy)
            return arm[0].float().cpu().numpy()
        return host_actions(arm[:1].cpu().numpy(), grip[:1].cpu().numpy(),
                            self.cfg.head.multi_step_action)[0]
