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
serving (``build_policy``).

    python -m deer_vla_tpu_torch.cli.eval --debug --model deer_3b \
        --calib_batches 2 --num_sequences_override 2 --exit_ratio 0.5
    python -m deer_vla_tpu_torch.cli.eval --calvin_dataset DIR \
        --evaluate_from_checkpoint runs/deer/deer_8.ckpt --value_cache v

``main(argv, device=None)`` runs on the card; ``device="cpu"`` runs the
plain versions on the CPU.  The weights are ``init_deer`` draws from
``--seed``, or a checkpoint (``--evaluate_from_checkpoint``, its config
from the ``.json`` sidecar) overlaid on the backbone it was trained over.
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

from deer_vla_tpu_torch.core.config import BF16, FP32, deer_3b, deer_tiny
from deer_vla_tpu_torch.core.device import resolve_device

MODELS = {"tiny": deer_tiny, "deer_3b": deer_3b, "mpt_dolly_3b": deer_3b}
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
    ("--diverse_inst", False, _FLAG, "M9 (the CALVIN env and data)"),
    ("--annotation_cache", "lang_annotation_cache.json", {},
     "M9 (the CALVIN env and data)"),
    ("--tokenizer_path", "", {}, "M9 (a transformers tokenizer)"),
    ("--tcp_rel", False, _FLAG, "M9 (tcp-frame actions)"),
    ("--visualize", "", {}, "M9 (rollout GIFs)"),
    ("--head_type", "deterministic", {}, "M10 (other head families)"),
    ("--diff_steps", 0, {"type": int}, "M10 (the diffusion head)"),
    ("--ddim_eta", 0.0, {"type": float}, "M10 (the diffusion head)"),
    ("--future_act_len", -1, {"type": int}, "M10 (the diffusion head)"),
    ("--gripper_res", -1, {"type": int}, "M10 (gripper_res)"),
    ("--calib_warm", 0, {"type": int}, "M10 (window-folded models)"),
    ("--frame_cache", False, _FLAG,
     "M10 (window-folded models: the rolling frame cache)"),
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
    if args.lanes > 1:
        raise SystemExit("--layerwise_exit_eval does not compose with "
                         "--lanes")
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
    dtypes = BF16 if args.precision == "bf16" else FP32
    if args.model == "tiny":
        return deer_tiny(dtypes=dtypes)
    return MODELS[args.model](
        max_layer=args.max_layer if args.max_layer > 0 else 12, dtypes=dtypes)


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
    values = None
    if cache and not args.recompute_values:
        values = load_calibration_values(cache)
        cached = bool(load_calibration_info(cache).get("calib_streamed",
                                                       False))
        if values is not None and cached != args.calib_streamed:
            print(f"values sidecar was calibrated with streamed={cached}; "
                  f"recomputing with streamed={args.calib_streamed}")
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
        max_batches=args.calib_batches, streamed=args.calib_streamed,
        gen=torch.Generator(device=dev).manual_seed(args.seed))
    if batches is not None:
        print(f"calibrated {values.shape[1]} samples in "
              f"{time.perf_counter() - t0:.3f} s")
    if cache:
        save_calibration_values(
            cache, values, {"exit_ratio": args.exit_ratio, "calib_warm": 0,
                            "calib_streamed": args.calib_streamed})
    controller.set_thresholds(thresholds)


def build_policy(args, cfg, params, controller, max_layer, dev):
    """The sequential policy, routed as the JAX CLI routes it
    (cli/eval.py:348-434): ``ScanDeerPolicy`` for dynamic exit unless the
    bucketed engine is asked for or needed (the ensemble, --multi_execution,
    --layerwise_exit_eval, a fixed --exit_id), each wrapped in its vision
    cache with --vision_cache_tau, then in the action cache with
    --action_cache_tau."""
    from deer_vla_tpu_torch.eval.caching import (ActionCachePolicy,
                                                 VisionCacheDeerPolicy,
                                                 VisionCacheScanPolicy)
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
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
            indexed_mm=True, quantize=quantize, device=dev)
        policy.set_thresholds(controller.thresholds)
        if args.vision_cache_tau > 0:
            policy = VisionCacheScanPolicy(policy, tau=args.vision_cache_tau)
    else:
        policy = DeerPolicy(params, cfg, controller=controller,
                            exit_id=args.exit_id,
                            threshold_type=args.threshold_type,
                            use_action_ensemble=args.use_action_ensemble,
                            multi_execution=args.multi_execution,
                            quantize=quantize, device=dev)
        if args.vision_cache_tau > 0:
            policy = VisionCacheDeerPolicy(policy, tau=args.vision_cache_tau)
    if args.action_cache_tau > 0:
        policy = ActionCachePolicy(policy, tau=args.action_cache_tau,
                                   refresh_every=args.action_cache_refresh)
    return policy


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
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
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
        bpolicy = policy
        if not isinstance(policy, ScanDeerPolicy):
            bpolicy = ScanDeerPolicy(
                params, cfg, threshold_type=args.threshold_type,
                max_layer=max_layer, steps_per_stage=args.steps_per_stage,
                indexed_mm=True,
                quantize=None if args.quantize == "none" else args.quantize,
                device=dev)
            bpolicy.set_thresholds(thresholds)
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
