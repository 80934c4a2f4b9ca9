"""Dynamic-exit serving engine: the port of ``eval/scan_policy.py``.

The JAX engine runs the decoder as one ``lax.while_loop``; here the loop is
a host loop over SEGMENTS (``stride`` layers, then one exit check).  Each
check ends in one host read of "have all streams exited?", so a step syncs
at most once per exit (6 times for deer_3b).  The layer index reaches the
indexed-matmul kernel as a device tensor, so nothing else in the loop
depends on the host.

Semantics kept exactly:
  * the first exit of every timestep compares against the pseudo action
    from the layer below it; later exits against the previous exit's action;
  * the head eats fp32 activations and its carry is fp32;
  * an exit fires where ``~done & (delta <= thresholds[..., i])``, with
    (n_layers,) or per-stream (B, n_layers) threshold rows;
  * exactly one carry is committed per stream, from its chosen exit.

``encode`` / ``step_from_encoded`` split the step at the encoded prefix (the
vision cache reuses a prefix); ``dispatch_batch`` / ``finish_batch`` split
``step_batch`` for the pipelined batched rollout.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.models.flamingo import (check_vision_supported,
                                                encode_vision)
from deer_vla_tpu_torch.models.gated_xattn import gated_xattn_forward
from deer_vla_tpu_torch.models.heads import (any_head_step, any_zero_carry,
                                             head_action_width)
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
    """The unstacked leaves the encode prefix reads: the ViT / perceiver
    non-layer leaves and the token embedding (their layers ride the stacked
    encoder tree)."""
    vit = {k: v for k, v in params["vit"].items() if k != "blocks"}
    vit["blocks"] = []
    per = {k: v for k, v in params["perceiver"].items() if k != "layers"}
    per["layers"] = []
    return {"vit": vit, "perceiver": per,
            "decoder": {"wte": params["decoder"]["wte"]}}


def stack_encoder_layers(params: dict, cdt) -> dict:
    return {"vit": stack_vit_blocks(params["vit"], cdt),
            "perceiver": stack_perceiver_layers(params["perceiver"], cdt)}


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
    dev = blocks["wqkv"]["w"].device
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


def check_serving_supported(cfg: DeerConfig) -> None:
    check_vision_supported(cfg)
    if cfg.head_type != "deterministic":
        raise NotImplementedError(
            f"head_type {cfg.head_type!r} is not ported")
    if cfg.mpt.arch != "mpt":
        raise NotImplementedError(f"decoder arch {cfg.mpt.arch!r} is not "
                                  "ported")


def build_scan_step(cfg: DeerConfig, exit_ids: List[int],
                    threshold_type: str = "L2",
                    max_layer: Optional[int] = None,
                    indexed_mm: bool = False):
    """Returns (exits, encode, decode).

    ``encode(params, stacked, img, grip, ids)`` -> (media, x, media
    locations); ``decode(params, stacked, media, x, mloc, mask, carry,
    thresholds)`` -> (arm (B, 6k), grip (B, k), carry, exit_layer (B,)
    int32, x) where ``thresholds`` is (n_layers,) or (B, n_layers) with
    +1e30 at the forced last exit and -1e30 at non-exit layers, and ``x``
    is the hidden state after the last decoder layer that ran."""
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
    gdim = cfg.head.multi_step_action

    def encode(params, stacked, img, grip, ids):
        media = encode_vision(params, img, grip, cfg, stacked)
        x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
        return media, x, ids == cfg.media_token_id

    def decode(params, stacked, media, x, mloc, mask, carry, thresholds):
        attn_bias = make_attn_bias(mask, cfg.mpt, x.dtype)
        head = params[head_key]
        b = x.shape[0]
        dev = x.device

        def eval_head(x_in):
            out, cand = any_head_step(head, x_in.float(), carry, cfg)
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
            st["carry"] = tuple(torch.where(take[None, :, None], c, bc)
                                for c, bc in zip(cand, st["carry"]))
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

    return exits, encode, decode


class HostInputs:
    """Moves a step's host inputs to ``self.device``: frames (numpy or
    tensors) as fp32, token ids checked against the vocabulary first, the
    attention mask as given."""

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
    int8 x int8 -> int32 products."""

    def __init__(self, params: dict, cfg: DeerConfig,
                 exit_ids: Optional[List[int]] = None,
                 thresholds=None, threshold_type: str = "L2",
                 max_layer: Optional[int] = None, steps_per_stage: int = 1,
                 indexed_mm: bool = False, quantize: Optional[str] = None,
                 device=None):
        super().__init__()
        check_serving_supported(cfg)
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
        exit_ids = list(exit_ids or cfg.all_exit_ids())
        self.exits, self._encode, self._decode = build_scan_step(
            cfg, exit_ids, threshold_type, max_layer, indexed_mm=indexed_mm)
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

    def _ensure_carry(self, b: int) -> None:
        if self.carry is None or self._carry_rows != b:
            self.carry = any_zero_carry(self.cfg, b, device=self.device)
        self._carry_rows = b

    @torch.inference_mode()
    def reset_streams(self, stream_mask) -> None:
        """Zero the carry of the streams where ``stream_mask`` is true."""
        if self.carry is None:
            return
        m = torch.as_tensor(np.asarray(stream_mask, bool), device=self.device)
        fresh = any_zero_carry(self.cfg, int(m.shape[0]), device=self.device)
        self.carry = tuple(torch.where(m[None, :, None], f, c)
                           for f, c in zip(fresh, self.carry))

    # -- inputs --------------------------------------------------------------
    def _run(self, image, gripper, input_ids, attention_mask, thresholds):
        media, x, mloc = self.encode(image, gripper, input_ids)
        return self._run_decode(media, x, mloc, attention_mask, thresholds)

    def _run_decode(self, media, x, mloc, attention_mask, thresholds):
        self._ensure_carry(x.shape[0])
        arm, grip, self.carry, exit_layer, self.last_hidden = self._decode(
            self.params, self.stacked, media, x, mloc,
            self._upload(attention_mask), self.carry, thresholds)
        return arm, grip, exit_layer

    # -- serving -----------------------------------------------------------
    @torch.inference_mode()
    def step(self, image, gripper, input_ids, attention_mask) -> np.ndarray:
        """One env step of one stream: a 7-dof action (or a (k, 7) plan
        for multi_step_action k > 1)."""
        arm, grip, exit_layer = self._run(image, gripper, input_ids,
                                          attention_mask,
                                          self._stage_thresholds())
        self.last_exit_layer = int(exit_layer[0])
        return self._postprocess(arm, grip)

    @torch.inference_mode()
    def encode(self, image, gripper, input_ids):
        """The vision and embedding prefix on its own: (media, x,
        media_locations) on the device, for ``step_from_encoded``."""
        return self._encode(self.params, self.stacked, self._image(image),
                            self._image(gripper), self._ids(input_ids))

    @torch.inference_mode()
    def step_from_encoded(self, media, x, mloc,
                          attention_mask) -> np.ndarray:
        """``step`` from a (possibly cached) encoded prefix."""
        arm, grip, exit_layer = self._run_decode(media, x, mloc,
                                                 attention_mask,
                                                 self._stage_thresholds())
        self.last_exit_layer = int(exit_layer[0])
        return self._postprocess(arm, grip)

    @torch.inference_mode()
    def dispatch_batch(self, image, gripper, input_ids, attention_mask):
        """The first half of ``step_batch``: runs the step, commits the
        carry, and starts copying (arm, grip, exit) to the host.

        The decode reads the host once per exit segment, so this returns
        only after the layer loop has ended; what it defers is the
        device-to-host copy of the step's outputs, a ``non_blocking`` copy
        into pinned memory with an event that ``finish_batch`` waits on.
        The pipelined rollout steps another lane group's envs meanwhile;
        true overlap of one group's layers with another's host work waits
        for a loop without host reads (ROADMAP.md M7b)."""
        outs = self._run(image, gripper, input_ids, attention_mask,
                         self.thresholds)
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
        (B, k, 7) plans, exit_layers (B,) int64)."""
        arm, grip, exit_layer, copied = handles
        if copied is not None:
            copied.synchronize()
        return (host_actions(arm.cpu().numpy(), grip.cpu().numpy(),
                             self.cfg.head.multi_step_action),
                exit_layer.cpu().numpy().astype(np.int64))

    def step_batch(self, image, gripper, input_ids, attention_mask):
        """B parallel streams with per-stream exits: (actions (B, 7) or
        (B, k, 7), exit_layers (B,) int64)."""
        return self.finish_batch(self.dispatch_batch(
            image, gripper, input_ids, attention_mask))

    def _postprocess(self, arm, grip) -> np.ndarray:
        return host_actions(arm[:1].cpu().numpy(), grip[:1].cpu().numpy(),
                            self.cfg.head.multi_step_action)[0]
