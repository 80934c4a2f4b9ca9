"""Evaluation CLI of the port: calibrate the exit thresholds, then serve
them in closed-loop rollouts (the JAX package's ``cli/eval.py``).  The
calibration batches are DebugBatcher's with ``--debug`` or without
``--calvin_dataset``, else the CALVIN loader over ``DIR/validation``; the
rollouts run in the DebugEnv.  Rollouts in the CALVIN env are dropped for
good (ROADMAP.md), so a run on ``--calvin_dataset`` without ``--debug``
calibrates, writes the values sidecar (``--value_cache``) and then raises
SystemExit naming that item; a ``--debug`` run given the same
``--value_cache`` serves those values.

The sequential rollouts serve through ``ScanDeerPolicy`` or the
host-bucketed ``DeerPolicy`` (``--engine``, ``--exit_id``,
``--use_action_ensemble``, ``--multi_execution``,
``--layerwise_exit_eval``), optionally behind the vision and action caches;
``--lanes`` through ``ScanDeerPolicy.step_batch`` (``--pipeline``,
``--env_workers``); ``--vit_tome_r`` merges ViT tokens in calibration and
serving (``build_policy``).  The fc, gpt and diffusion heads
(``--head_type`` for a seeded model, else the checkpoint's) serve through
the same engines; a diffusion model's plans come from the DDPM chain or
``--diff_steps`` DDIM steps (``--ddim_eta``, ``--future_act_len``),
through ``BatchedDiffusionSampler`` under ``--lanes``.  The model variant comes from the checkpoint's
sidecar config ('pre' / 'two_way' / 'vit_concat' fusion, a second
resampler, proprio state, ``use_hist``, a native-size gripper,
``multi_step_action``); ``--gripper_res`` sets the gripper's size,
``--frame_cache`` caches a window-folded model's per-frame ViT tokens, and
``--calib_warm`` warms its calibration head with other trajectories'
frames.

    python -m deer_vla_tpu_torch.cli.eval --debug --model deer_3b \
        --calib_batches 2 --num_sequences_override 2 --exit_ratio 0.5
    python -m deer_vla_tpu_torch.cli.eval --calvin_dataset DIR \
        --evaluate_from_checkpoint runs/deer/deer_8.ckpt --value_cache v

``--model`` takes the JAX registry's names (mpt_dolly_3b, mpt_9b,
llama_9b, tiny) and deer_3b.  ``main(argv, device=None)`` runs on the card;
``device="cpu"`` runs the plain versions on the CPU.  The weights are
``init_deer`` draws from ``--seed``, or a checkpoint
(``--evaluate_from_checkpoint``, its config from the ``.json`` sidecar)
overlaid on the backbone it was trained over.
The flags keep the JAX names; a JAX flag this CLI does not serve raises
SystemExit naming the ROADMAP.md item that will serve it.

The parse contract of the reference's log readers is kept: the last three
stdout lines are the thresholds (comma separated), the average successful
sequence length and the average exit layer - 1 (eval_calvin.py:646-653).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import (BF16, FP32, MODEL_REGISTRY,
                                            bc_llama, deer_3b)
from deer_vla_tpu_torch.core.device import resolve_device

# the JAX registry's keys, and deer_3b under its own name too
MODELS = dict(MODEL_REGISTRY, deer_3b=deer_3b)
# trajectories per DebugBatcher calibration batch
CALIB_BATCH_SIZE = 2
# what a run on --calvin_dataset without --debug ends with, once its values
# sidecar is written
CALVIN_ENV_DROPPED = ("rollouts in the CALVIN env are not served: the CALVIN "
                      "env (calvin_env and its data) is dropped for good "
                      "(ROADMAP.md \"Dropped for good\"); run --debug for "
                      "DebugEnv rollouts")

# JAX flags not served yet: (flag, JAX default, argparse keywords, the
# ROADMAP.md item that serves it).  A value other than the default raises.
_FLAG = {"action": "store_true"}
UNSERVED = (
    ("--calvin_conf_path", "", {}, "M9 (the CALVIN env and data)"),
    ("--eval_sequences", "eval_sequences.json", {},
     "M9 (the CALVIN env and data)"),
    ("--diverse_inst", False, _FLAG, "M9b (enriched instructions)"),
    ("--annotation_cache", "lang_annotation_cache.json", {},
     "M9b (enriched instructions)"),
    ("--tokenizer_path", "", {}, "M9 (a transformers tokenizer)"),
    ("--tcp_rel", False, _FLAG, "M9b (tcp-frame actions)"),
    ("--visualize", "", {}, "M9b (rollout GIFs)"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeeR-VLA evaluation on the PyTorch port")
    p.add_argument("--model", default="tiny", choices=sorted(MODELS))
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--num_seq", type=int, default=224)
    p.add_argument("--ep_len", type=int, default=360)
    p.add_argument("--exit_ratio", type=float, default=1.0)
    p.add_argument("--exit_dist", default="exp",
                   choices=["exp", "gauss", "gamma"])
    p.add_argument("--threshold_type", default="L2",
                   choices=["mean", "L2", "max", "cosine"])
    p.add_argument("--steps_per_stage", type=int, default=1)
    p.add_argument("--thresholds", type=float, nargs="*", default=None,
                   help="per-exit thresholds instead of calibrating (BO "
                        "mode); the last exit always fires")
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8_w8a8", "int4",
                            "int4_w8a8"],
                   help="quantized serving (ops/quant.py); the decoder of "
                        "int8 / int4 runs through K3 / K4")
    p.add_argument("--replan", type=int, default=-1)
    p.add_argument("--reset", action="store_true",
                   help="reset the env to the chain's initial state before "
                        "every subtask (eval_utils.py:603-606)")
    p.add_argument("--lanes", type=int, default=1,
                   help=">1: that many env streams in lockstep through one "
                        "batched policy step (eval/batched_rollout.py)")
    p.add_argument("--pipeline", type=int, default=1,
                   help=">1: split the lanes into this many groups, one "
                        "group's env steps overlapping the others' steps; "
                        "rounded down to a divisor of --lanes")
    p.add_argument("--env_workers", type=int, default=0,
                   help=">1: step a lane group's envs through a thread pool "
                        "(needs --lanes)")
    p.add_argument("--exit_id", type=int, default=None,
                   help="fixed exit layer (no calibration, no dynamic exit)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "fused", "bucketed"],
                   help="fused: ScanDeerPolicy (one host loop a step, "
                        "stacked weights); bucketed: the host-bucketed "
                        "DeerPolicy (steps_per_stage, ensemble, "
                        "--multi_execution, --layerwise_exit_eval)")
    p.add_argument("--use_action_ensemble", action="store_true",
                   help="average the last two evaluated exits' actions "
                        "(bucketed engine, value_net.py:92-95)")
    p.add_argument("--multi_execution", type=int, default=1,
                   help="repeat each action this many env steps")
    p.add_argument("--head_type", default=None,
                   choices=["deterministic", "fc", "gpt", "diffusion"],
                   help="the head family of the seeded --model (fc needs a "
                        "window-folded checkpoint); a checkpoint's is its "
                        "sidecar's")
    p.add_argument("--diff_steps", type=int, default=0,
                   help="diffusion head: >0 samples plans with a DDIM "
                        "subsequence of this many U-Net evaluations instead "
                        "of the full n_timesteps DDPM chain (the reference "
                        "always runs full DDPM, action_head.py:1028)")
    p.add_argument("--ddim_eta", type=float, default=0.0,
                   help="DDIM stochasticity (0 = deterministic)")
    p.add_argument("--future_act_len", type=int, default=-1,
                   help="diffusion head: execute only the first K sampled "
                        "actions of each plan (eval_calvin.py:209)")
    p.add_argument("--layerwise_exit_eval", action="store_true",
                   help="the final action from the chosen exit's own head "
                        "(lm_exits[i] / lm_head), each head streaming its "
                        "own carry; the criterion stays on the extra exit")
    p.add_argument("--action_cache_tau", type=float, default=0.0,
                   help=">0: replay the previous action while the frame "
                        "delta stays at or below tau (eval/caching.py)")
    p.add_argument("--action_cache_refresh", type=int, default=5)
    p.add_argument("--vision_cache_tau", type=float, default=0.0,
                   help=">0: reuse the encoded vision prefix while the frame "
                        "delta stays at or below tau (both engines; not "
                        "with --lanes)")
    p.add_argument("--vit_tome_r", type=int, default=0,
                   help="ToMe: merge N ViT patch-token pairs a layer "
                        "(ops/tome.py), in calibration and serving; 0 = the "
                        "exact tower")
    p.add_argument("--value_cache", default="",
                   help="calibration values .npz sidecar stem (reused "
                        "unless --recompute_values)")
    p.add_argument("--recompute_values", action="store_true")
    p.add_argument("--calib_batches", type=int, default=8)
    p.add_argument("--calib_streamed", action="store_true",
                   help="calibrate with one LSTM carry threaded across each "
                        "window and exits committed from the target "
                        "distribution (the serving carry regime)")
    p.add_argument("--calib_warm", type=int, default=0,
                   help="window-folded (w=1) models: warm the calibration "
                        "head carry with N frames of other trajectories "
                        "(models/value_net.py warm_prefix)")
    p.add_argument("--gripper_res", type=int, default=-1,
                   help="the gripper camera's input size for the shared ViT "
                        "(84 = CALVIN's native); -1 = the checkpoint "
                        "config's, 0 = the tower's")
    p.add_argument("--frame_cache", action="store_true",
                   help="window-folded models (vit_concat / use_hist): "
                        "cache per-frame ViT tokens in a rolling window and "
                        "encode only the newest frame a step (exact)")
    p.add_argument("--validation_set", action="store_true", default=True)
    p.add_argument("--amp", type=int, default=0)  # accepted, no effect
    p.add_argument("--report_json", default="",
                   help="also write the full report to this JSON path")
    p.add_argument("--debug", action="store_true",
                   help="DebugBatcher calibration data (also without "
                        "--calvin_dataset) and DebugEnv rollouts")
    p.add_argument("--calvin_dataset", default="",
                   help="a CALVIN-format directory: calibrate on its "
                        "validation/ split (unless --debug)")
    p.add_argument("--batch_size_calvin", type=int, default=6,
                   help="trajectories per CALVIN calibration batch")
    p.add_argument("--num_sequences_override", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--evaluate_from_checkpoint", default="",
                   help="a .ckpt written by cli/train (or any full "
                        "checkpoint); its .json sidecar gives the config")
    for flag, default, kw, _ in UNSERVED:
        p.add_argument(flag, default=default, **kw)
    return p


def check_served(args) -> None:
    for flag, default, _, item in UNSERVED:
        if getattr(args, flag[2:]) != default:
            raise SystemExit(f"{flag} is not served by the PyTorch port yet "
                             f"(ROADMAP.md {item})")
    if args.env_workers > 1 and args.lanes <= 1:
        raise SystemExit("--env_workers only applies to the batched "
                         "rollout; add --lanes N")
    if args.lanes > 1:
        for bad, why in (
                (args.exit_id is not None, "--exit_id (it needs dynamic "
                                           "exit)"),
                (args.frame_cache, "--frame_cache (per-lane device token "
                                   "queues are not implemented); "
                                   "window-folded models run --lanes with "
                                   "the uncached window re-encode"),
                (args.vision_cache_tau > 0, "--vision_cache_tau (per-lane "
                                            "frame caching is not "
                                            "implemented)"),
                (args.action_cache_tau > 0, "--action_cache_tau (per-lane "
                                            "action caching is not "
                                            "implemented)"),
                (args.multi_execution > 1 or args.use_action_ensemble,
                 "--multi_execution / --use_action_ensemble (they need the "
                 "sequential harness)"),
                (args.replan != -1, "--replan (no per-lane replan "
                                    "counter)")):
            if bad:
                raise SystemExit(f"--lanes does not compose with {why}")


def check_layerwise(args, cfg):
    """--layerwise_exit_eval's config and refusals (JAX cli/eval.py:252-272):
    the config with ``layerwise_exit_eval`` set, or as it was under
    ``share_exit`` (a no-op there)."""
    if cfg.share_exit:
        print("WARNING: --layerwise_exit_eval is a no-op with share_exit "
              "(every exit IS the shared lm_head)")
    elif not cfg.multi_exit:
        raise SystemExit("--layerwise_exit_eval needs a multi-exit "
                         "checkpoint (per-layer lm_exits heads)")
    else:
        cfg = dataclasses.replace(cfg, layerwise_exit_eval=True)
    if args.engine == "fused":
        raise SystemExit("--layerwise_exit_eval serves through the "
                         "host-bucketed engine (per-exit-head carries); drop "
                         "--engine fused")
    if args.lanes > 1 or args.frame_cache:
        raise SystemExit("--layerwise_exit_eval does not compose with "
                         "--lanes / --frame_cache")
    if args.use_action_ensemble:
        raise SystemExit("--layerwise_exit_eval does not compose with "
                         "--use_action_ensemble: the ensemble averages the "
                         "extra-exit criterion actions, which would override "
                         "the layerwise head's action")
    return cfg


def calibration_batches(args, cfg, tok):
    """The calibration batches (JAX ``cli/eval._calibration_batches``):
    DebugBatcher's with ``--debug`` or without ``--calvin_dataset``, else
    the CALVIN loader over ``DIR/validation`` (hash-fixed windows, no
    shuffle, ``--batch_size_calvin`` trajectories a batch)."""
    if args.debug or not args.calvin_dataset:
        from deer_vla_tpu_torch.data.debug_data import DebugBatcher
        return DebugBatcher(cfg, tok, batch_size=CALIB_BATCH_SIZE,
                            num_batches=args.calib_batches,
                            img_hw=cfg.vit.image_size,
                            grip_hw=cfg.vit.image_size)
    from deer_vla_tpu_torch.data.calvin import (CalvinDataConfig,
                                                CalvinLoader,
                                                DiskCalvinDataset)
    dcfg = CalvinDataConfig(
        dataset_dir=os.path.join(args.calvin_dataset, "validation"),
        window_size=cfg.window_size, seed=args.seed)
    ds = DiskCalvinDataset(dcfg, validation=True)
    return CalvinLoader(ds, tok, args.batch_size_calvin, shuffle=False)


def model_config(args):
    """The preset ``--model`` names, its decoder cut to ``--max_layer``
    layers (12 unless given, as in the JAX CLI; tiny keeps its own).
    bc_llama takes the depth as its n_layers: the JAX CLI's
    ``max_layer=`` call raises TypeError there."""
    dtypes = BF16 if args.precision == "bf16" else FP32
    factory = MODELS[args.model]
    if args.model == "tiny":
        return factory(dtypes=dtypes)
    depth = args.max_layer if args.max_layer > 0 else 12
    if factory is bc_llama:
        return bc_llama(n_layers=depth, dtypes=dtypes)
    return factory(max_layer=depth, dtypes=dtypes)


def load_model(args, dev: torch.device):
    """(cfg, params) on ``dev``: seeded random weights, or a checkpoint.

    A delta checkpoint stores only the trained leaves and overlays a seeded
    random backbone, which must be the one it was trained over.  The port's
    trainer records how it drew that backbone (package, seed, generator
    device: a seed draws other numbers on the CPU, on the card and in the
    JAX package); it is rebuilt that way.  A delta checkpoint without that
    record (one the JAX package wrote) raises instead of overlaying onto
    other weights; a full checkpoint loads anywhere."""
    from deer_vla_tpu_torch.core.config import DeerConfig
    from deer_vla_tpu_torch.models.flamingo import init_deer
    from deer_vla_tpu_torch.ops.layers import tree_leaves_with_path
    from deer_vla_tpu_torch.train.checkpoint import (load_checkpoint,
                                                     rebuild_backbone)

    if not args.evaluate_from_checkpoint:
        cfg = model_config(args)
        if args.head_type:
            # the family at cli/train's defaults of the head flags
            from deer_vla_tpu_torch.cli.train import head_family_updates
            cfg = dataclasses.replace(cfg, **head_family_updates(
                args.head_type, cfg.window_size))
        return cfg, init_deer(cfg, seed=args.seed, device=dev)
    path = args.evaluate_from_checkpoint
    stem = path[:-5] if path.endswith(".ckpt") else path
    with open(stem + ".json") as f:
        side = json.load(f)
    cfg = dataclasses.replace(DeerConfig.from_json(json.dumps(side["config"])),
                              dtypes=BF16 if args.precision == "bf16"
                              else FP32)
    if args.max_layer > 0:
        cfg = dataclasses.replace(cfg, mpt=dataclasses.replace(
            cfg.mpt, n_layers=args.max_layer))
    if args.head_type and args.head_type != cfg.head_type:
        raise SystemExit(f"--head_type {args.head_type}: {path} holds a "
                         f"{cfg.head_type!r} head")
    try:
        params = rebuild_backbone(side.get("meta", {}).get("init"), cfg, dev)
    except RuntimeError as err:
        raise SystemExit(f"{path}: {err}") from err
    rebuilt = params is not None
    if not rebuilt:
        params = init_deer(cfg, seed=args.seed, device=dev)
    params, _, loaded = load_checkpoint(path, params)
    n_loaded = loaded["meta"]["loaded_keys"]
    if not rebuilt and n_loaded < len(tree_leaves_with_path(params)):
        raise SystemExit(
            f"{path} is a delta checkpoint ({n_loaded} leaves) whose "
            "frozen backbone the port cannot rebuild (its sidecar does not "
            "say how the port drew it); refusing to overlay it on other "
            "weights")
    print(f"loaded {n_loaded} param groups from ckpt")
    return cfg, params


def exit_contract(report, probs, real_ids) -> dict:
    """Realized against target exit distribution (value_net.py:206-272)."""
    hist = report["exit_hist"]
    realized = [float(hist[e]) for e in real_ids]
    return {"exit_ids": [int(e) for e in real_ids],
            "target_probs": [float(p) for p in probs],
            "realized": realized,
            "avg_exit_target": float(sum(p * (e + 1)
                                         for p, e in zip(probs, real_ids))),
            "avg_exit_realized": float(report["avg_exit_layer"]),
            "max_abs_gap": float(max(abs(r - p)
                                     for r, p in zip(realized, probs)))}


def _clean(v):
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def calibrated_thresholds(args, cfg, params, tok, controller, max_layer,
                          dev) -> None:
    """Sets ``controller``'s thresholds: ``--thresholds`` as given, else
    calibrated (values from ``--value_cache`` when it holds them for this
    regime), the values written back to ``--value_cache``."""
    from deer_vla_tpu_torch.eval.calibrate import calibrate
    from deer_vla_tpu_torch.train.checkpoint import (load_calibration_info,
                                                     load_calibration_values,
                                                     save_calibration_values)
    if args.thresholds:
        n = len([e for e in controller.exit_id_list
                 if e <= controller.effective_max])
        controller.set_threshold_values(args.thresholds[:n])
        return
    cache = args.value_cache
    folded = cfg.fusion_mode == "vit_concat" or cfg.window_size == 1
    if args.calib_warm > 0 and not folded:
        print(f"WARNING: --calib_warm={args.calib_warm} only applies to "
              "window-folded (w=1) calibration; this model calibrates with "
              "full training windows and the flag is a no-op "
              "(models/value_net.py warm_prefix)")
    if args.calib_streamed and folded:
        raise SystemExit("--calib_streamed needs a real time window; this "
                         "model is window-folded: use --calib_warm instead")
    if not args.calib_streamed and not folded and not cfg.use_hist:
        # streaming serving with a real time window: --calib_streamed;
        # window-folded: --calib_warm; use_hist: the default folded regime
        print("RECOMMENDED: this model serves streaming (one LSTM carry "
              "threaded across the episode) but calibrates in the folded "
              "random-prefix regime; pass --calib_streamed for carry-matched "
              "calibration")
    warm = args.calib_warm if folded else 0
    values = None
    if cache and not args.recompute_values:
        values = load_calibration_values(cache)
        info = load_calibration_info(cache)
        cached = (int(info.get("calib_warm", 0)),
                  bool(info.get("calib_streamed", False)))
        if values is not None and cached != (warm, args.calib_streamed):
            print(f"values sidecar was calibrated with calib_warm="
                  f"{cached[0]} streamed={cached[1]}; recomputing with "
                  f"calib_warm={warm} streamed={args.calib_streamed}")
            values = None
        elif values is not None:
            print(f"reusing calibration values from {cache}")
    batches = None
    if values is None:
        batches = calibration_batches(args, cfg, tok)
    t0 = time.perf_counter()
    thresholds, values = calibrate(
        params, cfg, batches or [], args.exit_ratio, max_layer=max_layer,
        exit_dist=args.exit_dist, model_name=args.model,
        threshold_type=args.threshold_type, values=values,
        max_batches=args.calib_batches, warm_prefix=args.calib_warm,
        streamed=args.calib_streamed,
        gen=torch.Generator(device=dev).manual_seed(args.seed))
    if batches is not None:
        print(f"calibrated {values.shape[1]} samples in "
              f"{time.perf_counter() - t0:.3f} s")
    if cache:
        save_calibration_values(
            cache, values, {"exit_ratio": args.exit_ratio, "calib_warm": warm,
                            "calib_streamed": args.calib_streamed})
    controller.set_thresholds(thresholds)


def check_head_flags(args, cfg) -> None:
    """The JAX CLI's refusals for the fc, gpt and diffusion heads
    (cli/eval.py:361-376)."""
    if cfg.head_type == "deterministic":
        return
    if cfg.head_type == "diffusion" and args.action_cache_tau > 0:
        raise SystemExit("--action_cache_tau does not compose with the "
                         "diffusion head's plan sampling")
    if cfg.head_type == "diffusion" and args.multi_execution > 1:
        raise SystemExit("--multi_execution has no effect with the diffusion "
                         "head (it emits its own action plan); use "
                         "--future_act_len to bound the executed plan length")
    if args.vision_cache_tau > 0:
        raise SystemExit("--vision_cache_tau currently serves the "
                         "deterministic LSTM head only")


def build_policy(args, cfg, params, controller, max_layer, dev):
    """The sequential policy, routed as the JAX CLI routes it
    (cli/eval.py:348-434): ``ScanDeerPolicy`` for dynamic exit unless the
    bucketed engine is asked for or needed (the ensemble, --multi_execution,
    --layerwise_exit_eval, a fixed --exit_id), each wrapped in its vision
    cache with --vision_cache_tau; a diffusion model's policy in the DDPM /
    DDIM sampler (``DiffusionSamplerPolicy``); then the action cache with
    --action_cache_tau."""
    from deer_vla_tpu_torch.eval.caching import (ActionCachePolicy,
                                                 FrameCachePolicy,
                                                 VisionCacheDeerPolicy,
                                                 VisionCacheScanPolicy)
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        DiffusionSamplerPolicy
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    check_head_flags(args, cfg)
    quantize = None if args.quantize == "none" else args.quantize
    use_fused = (args.engine == "fused"
                 or (args.engine == "auto" and controller is not None
                     and not args.use_action_ensemble))
    if cfg.layerwise_exit_eval or args.multi_execution > 1:
        use_fused = False
    if use_fused and controller is not None:
        policy = ScanDeerPolicy(
            params, cfg, threshold_type=args.threshold_type,
            max_layer=max_layer, steps_per_stage=args.steps_per_stage,
            indexed_mm=cfg.mpt.arch == "mpt", quantize=quantize, device=dev)
        policy.set_thresholds(controller.thresholds)
        if args.frame_cache:
            if not (cfg.fusion_mode == "vit_concat" or cfg.use_hist):
                raise SystemExit("--frame_cache only applies to "
                                 "window-folded models (vit_concat / "
                                 "use_hist); other modes encode one frame "
                                 "a step already")
            if args.vision_cache_tau > 0:
                raise SystemExit("--frame_cache and --vision_cache_tau are "
                                 "mutually exclusive caching modes")
            policy = FrameCachePolicy(policy)
        if args.vision_cache_tau > 0:
            if cfg.use_state or cfg.head.use_state:
                raise SystemExit(
                    "--vision_cache_tau cannot serve state models: the "
                    "proprio token is part of the cached media latents and "
                    "changes every step")
            policy = VisionCacheScanPolicy(policy, tau=args.vision_cache_tau)
    else:
        if args.frame_cache:
            raise SystemExit("--frame_cache needs the scan engine (no "
                             "--multi_execution, no fixed --exit_id, "
                             "thresholds set)")
        policy = DeerPolicy(params, cfg, controller=controller,
                            exit_id=args.exit_id,
                            threshold_type=args.threshold_type,
                            use_action_ensemble=args.use_action_ensemble,
                            multi_execution=args.multi_execution,
                            quantize=quantize, device=dev)
        if args.vision_cache_tau > 0:
            policy = VisionCacheDeerPolicy(policy, tau=args.vision_cache_tau)
    if cfg.head_type == "diffusion":
        policy = DiffusionSamplerPolicy(
            policy, params, future_act_len=args.future_act_len,
            seed=args.seed, sample_steps=args.diff_steps,
            ddim_eta=args.ddim_eta)
    if args.action_cache_tau > 0:
        policy = ActionCachePolicy(policy, tau=args.action_cache_tau,
                                   refresh_every=args.action_cache_refresh)
    return policy


def batched_policy(args, cfg, params, policy, thresholds, max_layer, dev):
    """The ``--lanes`` engine: the sequential path's ``ScanDeerPolicy``
    (also from inside a diffusion model's sampler) or a new one, and for a
    diffusion model the lanes' sampler around it
    (``BatchedDiffusionSampler``)."""
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        BatchedDiffusionSampler
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inner = (policy.policy if cfg.head_type == "diffusion"
             and isinstance(getattr(policy, "policy", None), ScanDeerPolicy)
             else policy)
    bpolicy = inner
    if not isinstance(inner, ScanDeerPolicy):
        bpolicy = ScanDeerPolicy(
            params, cfg, threshold_type=args.threshold_type,
            max_layer=max_layer, steps_per_stage=args.steps_per_stage,
            indexed_mm=cfg.mpt.arch == "mpt",
            quantize=None if args.quantize == "none" else args.quantize,
            device=dev)
        bpolicy.set_thresholds(thresholds)
    if cfg.head_type == "diffusion":
        bpolicy = BatchedDiffusionSampler(
            bpolicy, params, future_act_len=args.future_act_len,
            seed=args.seed, sample_steps=args.diff_steps,
            ddim_eta=args.ddim_eta)
    return bpolicy


def main(argv=None, device: Optional[str] = None) -> dict:
    args = build_parser().parse_args(argv)
    check_served(args)
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.batched_rollout import \
        evaluate_policy_batched
    from deer_vla_tpu_torch.eval.flops import (avg_llm_gflops,
                                               llm_flops_per_exit,
                                               paper_convention_gflops)
    from deer_vla_tpu_torch.eval.metrics import format_report
    from deer_vla_tpu_torch.eval.rollout import (CalvinPolicyAdapter,
                                                 DebugEnv, DebugTaskOracle,
                                                 evaluate_policy,
                                                 make_debug_sequences,
                                                 process_count)
    from deer_vla_tpu_torch.models.value_net import (ExitController,
                                                     exit_probs)

    dev = resolve_device(device)
    cfg, params = load_model(args, dev)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    if args.vit_tome_r > 0:
        # weight-free: flipped before calibration, so that the thresholds
        # match the deltas served
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, tome_r=args.vit_tome_r))
    if args.gripper_res >= 0:  # -1 keeps the (sidecar) config's
        if args.gripper_res % cfg.vit.patch_size:
            raise SystemExit(f"--gripper_res must be a multiple of the "
                             f"ViT patch size {cfg.vit.patch_size}")
        cfg = dataclasses.replace(cfg, gripper_res=args.gripper_res)
    if args.layerwise_exit_eval:
        cfg = check_layerwise(args, cfg)
    max_layer = args.max_layer if args.max_layer > 0 else cfg.n_layers
    exits = list(cfg.all_exit_ids())
    size = cfg.vit.image_size

    controller = None
    thresholds = {}
    if args.exit_id is None:
        controller = ExitController(
            exit_id_list=exits, steps_per_stage=args.steps_per_stage,
            max_layer=max_layer, threshold_type=args.threshold_type)
        calibrated_thresholds(args, cfg, params, tok, controller, max_layer,
                              dev)
        thresholds = controller.thresholds
    if args.calvin_dataset and not args.debug:
        print(",".join(f"{thresholds[e]:.6f}" for e in sorted(thresholds)))
        raise SystemExit(CALVIN_ENV_DROPPED)
    policy = build_policy(args, cfg, params, controller, max_layer, dev)

    oracle = DebugTaskOracle(threshold=0.05)
    sequences = make_debug_sequences(args.num_sequences_override or 8)
    ep_len = min(args.ep_len, 40)
    n_seq = min(args.num_seq, len(sequences))
    per_layer = llm_flops_per_exit(cfg)
    envs = [DebugEnv(img_hw=size, grip_hw=size)
            for _ in range(max(args.lanes, 1))]
    t0 = time.perf_counter()
    if args.lanes > 1:
        bpolicy = batched_policy(args, cfg, params, policy, thresholds,
                                 max_layer, dev)
        report = evaluate_policy_batched(
            bpolicy, envs, sequences[:n_seq], {}, oracle, tok,
            text_len=cfg.text_len, ep_len=ep_len, n_layers=cfg.n_layers,
            pipeline=args.pipeline, reset=args.reset,
            env_workers=args.env_workers)
    else:
        procs = process_count()
        report = evaluate_policy(
            CalvinPolicyAdapter(policy, tok, text_len=cfg.text_len), envs[0],
            sequences[:n_seq], {}, oracle,
            rank=torch.distributed.get_rank() if procs > 1 else 0,
            world_size=procs, num_sequences=n_seq, ep_len=ep_len,
            replan=args.replan, reset=args.reset,
            flops_per_layer=per_layer[0] * 1e9, n_layers=cfg.n_layers)
    report["rollout_seconds"] = time.perf_counter() - t0
    report["env_steps"] = sum(e.steps for e in envs)
    print(f"rollout: {report['env_steps']} env steps in "
          f"{report['rollout_seconds']:.3f} s on {dev}")

    hist = (np.add(report["success_exit_hist"], report["fail_exit_hist"])
            / max(1e-9, sum(report["success_exit_hist"])
                  + sum(report["fail_exit_hist"])))
    report["exit_hist"] = hist.tolist()
    report["avg_llm_gflops"] = avg_llm_gflops(cfg, hist)
    if controller is not None and not args.thresholds:
        real_ids = [e for e in exits if e <= controller.effective_max]
        probs = exit_probs(len(real_ids), args.exit_ratio, args.exit_dist,
                           args.model)
        report["exit_contract"] = exit_contract(report, probs, real_ids)
        contract = report["exit_contract"]
        print(f"exit contract: target={[round(float(p), 3) for p in probs]} "
              f"realized={[round(r, 3) for r in contract['realized']]} "
              f"max gap {contract['max_abs_gap']:.3f}")
    report["avg_llm_gflops_paper_conv"] = float(sum(
        paper_convention_gflops(cfg, i) * p for i, p in enumerate(hist)
        if p > 0))
    if args.action_cache_tau > 0:
        report["action_cache_hit_rate"] = policy.hits / max(1, policy.steps)
        print(f"action cache: {policy.hits}/{policy.steps} hits")
    if args.vision_cache_tau > 0:
        vc = policy.policy if args.action_cache_tau > 0 else policy
        report["vision_cache_hit_rate"] = vc.encode_hits / max(1, vc.steps)
        print(f"vision-token cache: {vc.encode_hits}/{vc.steps} encode hits")
    print(format_report(report))
    if args.report_json:
        payload = {"report": _clean(report),
                   "thresholds": {int(k): float(v)
                                  for k, v in thresholds.items()},
                   "exit_ratio": args.exit_ratio, "model": args.model,
                   "max_layer": max_layer, "num_seq": n_seq,
                   "device": str(dev)}
        os.makedirs(os.path.dirname(os.path.abspath(args.report_json)),
                    exist_ok=True)
        with open(args.report_json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"report written to {args.report_json}")
    # -- the parse contract: last three lines --------------------------------
    print(",".join(f"{thresholds[e]:.6f}" for e in sorted(thresholds)))
    print(f"{report['avg_seq_len']:.6f}")
    print(f"{report['avg_exit_layer'] - 1:.6f}")
    return report


if __name__ == "__main__":
    main()
