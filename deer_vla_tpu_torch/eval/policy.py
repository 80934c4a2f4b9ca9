"""Host-bucketed dynamic-exit serving: the port of the JAX package's
``eval/policy.DeerPolicy`` (the reference's ModelWrapper and its per-layer
break, eval_utils.py:187-490, mosaic_gpt_3b.py:438-443).

The decoder runs as one function per exit segment (the layers between two
exits, then the exit head and its action delta).  After each segment the
host reads the delta (with the segment's action, in one copy) and compares
it with the threshold; once an exit fires no later segment is issued, so
the work past the exit never runs (the DeeR paper's FLOPs claim).

Per step, as in the JAX package (value_net.py:120-133, flamingo_mpt.py:
443-461):
  1. encode prefix: both cameras through the ViT, the perceiver, the token
     embedding;
  2. segment k runs layers (exit_{k-1}, exit_k] and the speculative exit
     head (its carry not committed); segment 0 compares its action with the
     pseudo action from the layer below it, segment k > 0 with segment
     k-1's action;
  3. the exit's candidate carry is committed: one commit per env step.

A fixed ``exit_id`` (``controller=None``) runs one segment and reads
nothing in between.  ``steps_per_stage`` reuses the stage's exit through
``ExitController.reuse_stage_exit``; ``use_action_ensemble`` averages the
last two evaluated exits; ``multi_execution`` m tiles the action into an
(m, 7) plan; ``layerwise_exit_eval`` takes the final action from the chosen
exit's own head, each head streaming its own carry, while the criterion
stays on the extra exit (eval_calvin.py:583).

The decoder runs ``linear`` on the unstacked per-layer weights, as the JAX
package's segment programs do, so K2-K4 do not run here; K1 runs in the
ViT of the encode prefix.  Every head family is served (``models/heads``);
a diffusion model's step returns the chosen exit's conditioning feature,
which ``eval/diffusion_policy.DiffusionSamplerPolicy`` turns into a plan.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.eval.scan_policy import (HostInputs,
                                                 check_serving_supported,
                                                 folded_window,
                                                 prune_encoder_params,
                                                 stack_encoder_layers)
from deer_vla_tpu_torch.models.flamingo import encode_vision
from deer_vla_tpu_torch.models.heads import (any_head_forward, any_head_step,
                                             any_zero_carry,
                                             head_action_width)
from deer_vla_tpu_torch.models.mpt import decoder_segment_forward, embed_tokens
from deer_vla_tpu_torch.models.value_net import ExitController, get_delta
from deer_vla_tpu_torch.ops.quant import (QUANT_MODES,
                                          quantize_serving_stacked)


class DeerPolicy(HostInputs):
    """One rollout stream's segment functions and its state.

    controller: an ExitController for dynamic exit, or None for the fixed
    ``exit_id`` (None or -1: the last layer).  quantize: None, "none" or
    one of ``ops.quant.QUANT_MODES``: the decoder blocks and cross-attention
    (per layer) and the stacked encoder are quantized, the embedding and
    the heads stay in full precision.  device: the card unless given."""

    def __init__(self, params: dict, cfg: DeerConfig,
                 controller: Optional[ExitController] = None,
                 exit_id: Optional[int] = None,
                 threshold_type: str = "L2",
                 use_action_ensemble: bool = False,
                 multi_execution: int = 1,
                 quantize: Optional[str] = None, device=None):
        check_serving_supported(cfg, allow_window_folded=True,
                                allow_any_head=True)
        if cfg.head_type == "diffusion" and use_action_ensemble:
            raise NotImplementedError(
                "action ensembling averages exit ACTIONS; the diffusion "
                "head's exits emit conditioning features")
        self.device = resolve_device(device)
        params = to_torch(params, self.device)
        self.quantize = None if quantize in (None, "none") else quantize
        if self.quantize:
            if self.quantize not in QUANT_MODES:
                raise ValueError(f"unknown quantize mode {quantize!r} "
                                 f"(want one of {QUANT_MODES})")
            dec = params["decoder"]
            params = dict(params, decoder=dict(dec, **quantize_serving_stacked(
                {"blocks": dec["blocks"], "xattn": dec["xattn"]},
                self.quantize, parts=("blocks", "xattn"))))
        self.params = params
        self.cfg = cfg
        self.controller = controller
        self.threshold_type = threshold_type
        self.use_action_ensemble = use_action_ensemble
        self.multi_execution = multi_execution
        if exit_id is None:
            exit_id = cfg.n_layers - 1
        if exit_id < 0:
            exit_id += cfg.n_layers
        if not 0 <= exit_id < cfg.n_layers:
            raise ValueError(f"exit_id {exit_id} out of range for a "
                             f"{cfg.n_layers}-layer decoder")
        self.exit_id = exit_id
        if controller is not None:
            self.bucket_exits: List[int] = [
                i for i in controller.exit_id_list
                if i <= controller.effective_max]
        else:
            self.bucket_exits = [exit_id]
        self._build_programs()
        self.reset()

    # -- segment functions ---------------------------------------------------

    def _build_programs(self):
        cfg = self.cfg
        params = self.params
        self.enc_params = prune_encoder_params(params)
        self.enc_stacked = quantize_serving_stacked(
            stack_encoder_layers(params, cfg.dtypes.cdt), self.quantize)
        # window-folded models: the adapter feeds the rolling W-frame window
        # a step, as to the scan engine
        enc_w = self._enc_w = folded_window(cfg)

        def encode_prefix(params, stacked, img, grip, ids, state=None):
            media = encode_vision(params, img, grip, cfg, state, stacked,
                                  window_size=enc_w)
            x = embed_tokens(params["decoder"], ids, cfg.dtypes.cdt)
            return media, x, ids == cfg.media_token_id

        self._encode_prefix = encode_prefix
        head_key = "lm_head" if cfg.share_exit else "extra_exit"

        def seg_params(start, stop):
            """Segment [start, stop)'s leaves: its layers (``None`` below
            ``start`` keeps the absolute layer index) and the criterion head,
            always the extra exit (eval_calvin.py:583)."""
            dec = params["decoder"]
            return {"decoder": {
                "blocks": [None] * start + list(dec["blocks"][start:stop]),
                "xattn": [None] * start + list(dec["xattn"][start:stop])},
                head_key: params[head_key]}

        def segment(start, stop, first_exit, sp, x, mask, media, mloc, carry,
                    prev_action, state):
            """Layers [start, stop), the speculative head and the delta."""
            x_prev, x_out = decoder_segment_forward(
                sp["decoder"], x, mask, media, cfg, start, stop, mloc)
            out, cand_carry = self._head(sp[head_key], x_out, carry, state)
            action = out.actions[:, 0]
            if first_exit:
                # the pseudo previous action from the layer below the first
                # exit (value_net.py:122-126), same uncommitted carry
                pseudo, _ = self._head(sp[head_key], x_prev, carry, state)
                ref_action = pseudo.actions[:, 0]
            else:
                ref_action = prev_action
            delta = get_delta(action, ref_action, self.threshold_type)
            return x_out, out, cand_carry, delta.mean()

        self._segments = []
        self._seg_params = []
        prev = 0
        for k, e in enumerate(self.bucket_exits):
            self._segments.append((
                prev, e, functools.partial(segment, prev, e + 1, False),
                functools.partial(segment, prev, e + 1, True) if k == 0
                else None))
            self._seg_params.append(seg_params(prev, e + 1))
            prev = e + 1

        # layerwise_exit_eval: the chosen exit's own head (lm_exits[e], the
        # lm_head at the last layer) gives the action, with its own carry
        self._layerwise = cfg.layerwise_exit_eval and not cfg.share_exit
        self._final_heads = {}
        if self._layerwise:
            for e in self.bucket_exits:
                if e == cfg.n_layers - 1:
                    self._final_heads[e] = params["lm_head"]
                elif str(e) in params.get("lm_exits", {}):
                    self._final_heads[e] = params["lm_exits"][str(e)]
                else:
                    raise ValueError(
                        f"layerwise_exit_eval: no lm_exits[{e}] head in the "
                        "checkpoint (model not trained multi_exit?)")

    def _head(self, head, x, carry, state):
        """A head on a segment's output: one streamed step, or under
        ``use_hist`` the whole window (it is the memory, the carry stays)
        giving the last step's action (flamingo_mpt.py:700-740)."""
        if self.cfg.use_hist:
            return any_head_forward(head, x.float(), self.cfg, state,
                                    window=self._enc_w,
                                    last_action=True), carry
        return any_head_step(head, x.float(), carry, self.cfg, state)

    # -- state ---------------------------------------------------------------

    def reset(self):
        """A new subtask: clear the carries and the controller's state
        (ModelWrapper.reset, eval_utils.py:252-277)."""
        self.carry = None
        self.layer_carries = {}
        self.last_exit_layer = -1
        if self.controller is not None:
            self.controller.reset_episode()

    def set_timestep(self, t: int):
        if self.controller is not None:
            self.controller.set_timestep(t)

    # -- stepping ------------------------------------------------------------

    @torch.inference_mode()
    def encode(self, image, gripper, input_ids, state=None):
        """The encode prefix from host inputs: (media, x, media_locations)
        on the device."""
        return self._encode_prefix(self.enc_params, self.enc_stacked,
                                   self._image(image), self._image(gripper),
                                   self._ids(input_ids), self._state(state))

    def step(self, image, gripper, input_ids, attention_mask,
             state=None) -> np.ndarray:
        """One env step: image / gripper (1, 1, 1, 3, H, W) preprocessed (a
        window-folded model's W frames as rows); the 7-dof action with the
        gripper at +-1 (eval_utils.py:458-475), or a (k, 7) / (m, 7) plan.
        ``state``: a state model's proprio rows, one an image row."""
        media, x, mloc = self.encode(image, gripper, input_ids, state)
        return self.step_from_encoded(media, x, mloc, attention_mask, state)

    @torch.inference_mode()
    def step_from_encoded(self, media, x, mloc, attention_mask,
                          state=None) -> np.ndarray:
        """The segment loop from a (possibly cached) encoded prefix."""
        cfg = self.cfg
        mask = self._upload(attention_mask)
        # streams: the text rows, a window of them each under use_hist
        streams = x.shape[0] // (self._enc_w if cfg.use_hist else 1)
        if self.carry is None:
            self.carry = any_zero_carry(cfg, streams, device=self.device)
        # the head's state rows: under vit_concat the last frame's
        hstate = self._state(state)
        if (hstate is not None and self._enc_w > 1
                and cfg.fusion_mode == "vit_concat"):
            hstate = hstate.reshape((streams, self._enc_w)
                                    + hstate.shape[1:])[:, -1]
        ctrl = self.controller
        prev_action = torch.zeros(streams, head_action_width(cfg),
                                  device=self.device)
        reuse = ctrl is not None and ctrl.reuse_stage_exit()
        chosen = None
        for k, (_, e, fn, fn_first) in enumerate(self._segments):
            run_fn = fn_first if (k == 0 and ctrl is not None) else fn
            x, out, cand_carry, delta = run_fn(
                self._seg_params[k], x, mask, media, mloc, self.carry,
                prev_action, hstate)
            prev_action = out.actions[:, 0]
            if ctrl is None:
                chosen = (e, out, cand_carry)
                break
            if reuse:
                if e >= min(ctrl.cur_exit_id, ctrl.effective_max):
                    chosen = (e, out, cand_carry)
                    break
                continue
            # the one host read of the segment: delta, action, gripper
            d, arm, grip = _host_read(delta, out)
            ctrl.record_action((arm, grip))
            if ctrl.should_exit(e, d):
                chosen = (e, out, cand_carry)
                break
        if chosen is None:
            raise RuntimeError("the last segment did not exit")
        exit_layer, out, cand_carry = chosen
        self.carry = cand_carry  # the one commit of the step
        self.last_exit_layer = exit_layer
        crit_out = out
        if self._layerwise:
            # x is the chosen segment's output; its own head, own carry
            lc = self.layer_carries.get(exit_layer)
            if lc is None:
                lc = any_zero_carry(cfg, streams, device=self.device)
            out, self.layer_carries[exit_layer] = self._head(
                self._final_heads[exit_layer], x, lc, hstate)
        if cfg.head_type == "diffusion":
            # the chosen exit's conditioning feature, for the DDPM sampler
            # (eval/diffusion_policy.DiffusionSamplerPolicy)
            return out.actions[0, 0].float().cpu().numpy()
        if ctrl is not None and reuse:
            ctrl.cur_exit_id = exit_layer
            ctrl.record_action(_host_read(None, crit_out)[1:])

        if self.use_action_ensemble and ctrl is not None:
            # the last two evaluated exits, arm and gripper, then cleared so
            # that it never spans env steps (eval_utils.py:457-463)
            arm_e, grip_e = ctrl.get_ensemble_action()
            ctrl.action_list.clear()
            arm = np.asarray(arm_e[0], np.float32)
            gp = np.asarray(grip_e, np.float32).reshape(-1)
        else:
            arm = out.actions[0, 0].float().cpu().numpy()
            gp = out.gripper_probs[0, 0].float().cpu().numpy().reshape(-1)
        k = cfg.head.multi_step_action
        if k > 1:
            grip = np.where(gp > 0.5, 1.0, -1.0).astype(np.float32)
            plan = np.concatenate([arm.reshape(k, 6), grip[:, None]],
                                  -1).astype(np.float32)
            if self.multi_execution > 1:
                plan = np.repeat(plan, self.multi_execution, axis=0)
            return plan
        grip = 1.0 if float(gp[0]) > 0.5 else -1.0
        action = np.concatenate([arm, [grip]]).astype(np.float32)
        if self.multi_execution > 1:
            # one action repeated m times (ModelWrapper multi_execution,
            # eval_utils.py:469-471), consumed one env step at a time
            return np.tile(action, (self.multi_execution, 1))
        return action


def _host_read(delta, out):
    """One device-to-host copy of (delta, arm (B, 6k), gripper (B, k)):
    (float delta or None, arm, gripper) as numpy."""
    arm = out.actions[:, 0].float()
    grip = out.gripper_probs[:, 0].float()
    parts = [arm.reshape(-1), grip.reshape(-1)]
    if delta is not None:
        parts.insert(0, delta.float().reshape(1))
    flat = torch.cat(parts).cpu().numpy()
    d = None
    if delta is not None:
        d, flat = float(flat[0]), flat[1:]
    return (d, flat[:arm.numel()].reshape(arm.shape),
            flat[arm.numel():].reshape(grip.shape))
