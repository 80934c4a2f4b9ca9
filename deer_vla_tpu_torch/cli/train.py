"""Training CLI of the port (the JAX package's ``cli/train.py``, the
reference's train_calvin_post_strategy.py), on a CALVIN-format directory
(``DIR/training``, ``data/calvin.py``) or on ``--debug`` random batches:

    python -m deer_vla_tpu_torch.cli.train --model mpt_dolly_3b \
        --calvin_dataset DIR --run_name runs/deer
    python -m deer_vla_tpu_torch.cli.train --debug --model mpt_dolly_3b \
        --num_joint_epochs 1 --num_exit_epochs 1 --joint_warmup_steps 1 \
        --exit_warmup_steps 1 --run_name runs/deer

``main(argv, device=None)`` trains on the card; ``device="cpu"`` runs the
plain versions on the CPU.  The weights are ``init_deer`` draws from
``--seed``; checkpoints go to ``--run_name`` as ``deer_{epoch}.ckpt`` with
their ``.json`` sidecars, and ``cli/eval --evaluate_from_checkpoint``
serves them.  The vision, state and window variants are flags
(``--fusion_mode``, ``--sep_resampler``, ``--use_state`` [``--clip_state``],
``--use_hist``, ``--gripper_res``, ``--multi_step_action``), and so are
the head families (``--head_type fc|gpt|diffusion`` with ``--hidden_size``,
``--n_timesteps``, ``--n_obs_steps``, ``--diff_horizon``); all ride the
sidecar config into evaluation.  A diffusion model's normalizer is fitted
on the training batches and saved in its checkpoints.

``--cotrain`` adds the vision-language LM loss of a caption / VQA batch to
every step (``--cotrain_laion_shards`` webdataset caption shards, else
``--coco_image_dir`` / ``--coco_ann``, else ``--vqa_image_dir`` /
``--vqa_questions`` / ``--vqa_ann``; ``--vl_weight``, ``--vl_batch_size``).
``--coordinator HOST:PORT`` (or a ``file://`` URL) ``--num_processes N
--process_id I`` joins a process group and trains data parallel:
``--batch_size_calvin`` trajectories a process, the gradients averaged
across processes, checkpoints written by process 0:

    python -m deer_vla_tpu_torch.cli.train --debug --coordinator \
        localhost:29500 --num_processes 2 --process_id 0 ...   (and 1)

The flags keep the JAX names; a JAX flag this CLI does not serve raises
SystemExit naming the ROADMAP.md item that will serve it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

from deer_vla_tpu_torch.core.config import (BF16, FP32, MODEL_REGISTRY,
                                            bc_llama)
from deer_vla_tpu_torch.utils.errors import record

MODELS = MODEL_REGISTRY

# JAX flags not served yet: (flag, JAX default, argparse keywords, the
# ROADMAP.md item that serves it).  A value other than the default raises.
UNSERVED = (
    ("--tokenizer_path", "", {}, "M9 (a transformers tokenizer)"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeeR-VLA training on the PyTorch port")
    p.add_argument("--model", default="mpt_dolly_3b",
                   choices=["mpt_dolly_3b", "mpt_9b", "llama_9b", "tiny"])
    p.add_argument("--max_layer", type=int, default=12,
                   help="truncated decoder depth (early_exit_layer + 1)")
    p.add_argument("--exit_interval", type=int, default=2)
    p.add_argument("--window_size", type=int, default=12)
    p.add_argument("--dif_ws", action="store_true",
                   help="variable-window training (data.py:250-255): "
                        "training windows uniform in [min, max], samples "
                        "padded to max (needs --window_size = "
                        "--max_window_size)")
    p.add_argument("--min_window_size", type=int, default=12)
    p.add_argument("--max_window_size", type=int, default=24)
    p.add_argument("--multi_step_action", type=int, default=1)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--use_state", action="store_true")
    p.add_argument("--clip_state", action="store_true",
                   help="keep only arm pose + gripper of the proprio state "
                        "(train_utils.py:253-255)")
    p.add_argument("--sep_resampler", action="store_true")
    p.add_argument("--share_exit", action="store_true")
    p.add_argument("--freeze_embed", action="store_true",
                   help="keep token embeddings frozen in the joint phase")
    p.add_argument("--freeze_sampler", action="store_true",
                   help="keep the perceiver resampler frozen")
    p.add_argument("--unfreeze_vit", action="store_true",
                   help="train the ViT too (on the card through K1 and "
                        "its backward)")
    p.add_argument("--train_params", type=int, default=-1,
                   help=">=0: train only the last round(n/140) gated "
                        "x-attn layers (factory.py:214-222)")
    p.add_argument("--fusion_mode", default="post",
                   choices=["post", "pre", "two_way", "vit_concat"],
                   help="camera fusion (flamingo_mpt.py:585-777); "
                        "vit_concat folds the window into the media tokens "
                        "(per-window text, last-step action labels)")
    p.add_argument("--use_hist", action="store_true",
                   help="history variant: learned frame embeddings on ViT "
                        "tokens, last-step-only loss (flamingo_mpt.py:700)")
    p.add_argument("--gripper_res", type=int, default=0,
                   help="run the gripper camera through the shared ViT at "
                        "this input size (84 = CALVIN's native; position "
                        "embeddings interpolated); saved in the checkpoint "
                        "config, so evaluation inherits it; 0 = off")
    p.add_argument("--exit_dropout", type=float, default=None)
    p.add_argument("--lstm_dropout", type=float, default=None)
    p.add_argument("--dropout_mode", default=None,
                   choices=["layerwise", "last", "wo_last"])
    p.add_argument("--mlp_num_hidden_layers", type=int, default=None)
    p.add_argument("--lstm_num_layers", type=int, default=None)
    p.add_argument("--mlp_layernorm", action="store_true")
    p.add_argument("--lstm_layernorm", action="store_true")
    p.add_argument("--pooling", default=None, choices=["max", "mean"])
    p.add_argument("--single_exit", action="store_true",
                   help="train only the final head")
    p.add_argument("--bin_coef", type=float, default=None,
                   help="gripper-BCE weight; default 0.05 with --real_data, "
                        "else 0.01 (train_utils.py:314-316)")
    p.add_argument("--exit_strategy", default="post", choices=["post"])
    p.add_argument("--head_type", default="deterministic",
                   choices=["deterministic", "fc", "gpt", "diffusion"],
                   help="action-head family (models/heads.py); fc needs "
                        "--use_hist or --fusion_mode vit_concat")
    p.add_argument("--hidden_size", type=int, default=None,
                   help="GPTDecoder backbone width (head_type gpt); default "
                        "the decoder's width")
    p.add_argument("--n_timesteps", type=int, default=150,
                   help="diffusion timesteps (head_type diffusion)")
    p.add_argument("--n_obs_steps", type=int, default=6,
                   help="action-history length + 1 for the diffusion head "
                        "(clamped to the window)")
    p.add_argument("--diff_horizon", type=int, default=32,
                   help="the diffusion plan's horizon (at least the window)")
    p.add_argument("--loss_multiplier_calvin", type=float, default=1.0)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--calvin_dataset", default="",
                   help="a CALVIN-format directory; training reads its "
                        "training/ split")
    p.add_argument("--text_aug", action="store_true")
    p.add_argument("--data_percent", type=float, default=1.0)
    p.add_argument("--workers", type=int, default=4,
                   help="loader threads assembling a batch's windows")
    p.add_argument("--vit_tome_r", type=int, default=0,
                   help="ToMe token merging in the frozen ViT (ops/tome.py):"
                        " merge N patch-token pairs a layer; 0 = the exact "
                        "tower")
    p.add_argument("--remat", action="store_true",
                   help="recompute each decoder layer in the backward pass "
                        "(activation memory)")
    p.add_argument("--remat_policy", default="full", choices=["full", "dots"],
                   help="full: recompute all of a layer; dots: keep its "
                        "weight products")
    p.add_argument("--rgb_pad", type=int, default=10)
    p.add_argument("--gripper_pad", type=int, default=4)
    p.add_argument("--traj_cons", action="store_true", default=True)
    p.add_argument("--batch_size_calvin", type=int, default=6)
    p.add_argument("--num_joint_epochs", type=int, default=4)
    p.add_argument("--num_exit_epochs", type=int, default=5)
    p.add_argument("--joint_learning_rate", type=float, default=1e-4)
    p.add_argument("--exit_learning_rate", type=float, default=2.5e-4)
    p.add_argument("--joint_lr_scheduler", default="constant")
    p.add_argument("--exit_lr_scheduler", default="constant")
    p.add_argument("--joint_warmup_steps", type=int, default=2500)
    p.add_argument("--exit_warmup_steps", type=int, default=2500)
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--exit_lr_scale", type=float, default=1.0)
    p.add_argument("--exit_decay", action="store_true")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--real_data", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--run_name", default="runs/deer")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--from_scratch", action="store_true",
                   help="ignore existing checkpoints in run_name")
    p.add_argument("--no_gripper", action="store_true",
                   help="single-camera ablation: drop the gripper camera")
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--save_every_iter", type=int, default=-1)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--tcp_rel", action="store_true",
                   help="train on tool-center-point-frame relative actions "
                        "(labels converted with robot_obs)")
    p.add_argument("--debug", action="store_true",
                   help="DebugBatcher random batches, no dataset")
    # vision-language co-training (train_calvin_post_strategy.py:296-302)
    p.add_argument("--cotrain", action="store_true")
    p.add_argument("--cotrain_laion_shards", default="",
                   help="glob of LAION-style webdataset tars as the VL "
                        "source (instead of --coco_ann)")
    p.add_argument("--coco_image_dir", default="")
    p.add_argument("--coco_ann", default="")
    p.add_argument("--vqa_image_dir", default="")
    p.add_argument("--vqa_questions", default="")
    p.add_argument("--vqa_ann", default="")
    p.add_argument("--vl_weight", type=float, default=1.0)
    p.add_argument("--vl_batch_size", type=int, default=None)
    # data parallel over a torch.distributed process group
    p.add_argument("--coordinator", default="",
                   help="HOST:PORT (or a tcp:// / file:// URL) of the "
                        "process group")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    for flag, default, kw, _ in UNSERVED:
        p.add_argument(flag, default=default, **kw)
    return p


def check_served(args) -> None:
    for flag, default, _, item in UNSERVED:
        if getattr(args, flag[2:]) != default:
            raise SystemExit(f"{flag} is not served by the PyTorch port yet "
                             f"(ROADMAP.md {item})")
    if not args.debug and not args.calvin_dataset:
        raise SystemExit("training needs --calvin_dataset DIR (a "
                         "CALVIN-format directory) or --debug")
    check_processes(args)
    k = args.gradient_accumulation_steps
    if args.batch_size_calvin % k:
        raise SystemExit(f"--batch_size_calvin {args.batch_size_calvin} is "
                         f"not divisible by --gradient_accumulation_steps "
                         f"{k}")
    vbs = args.vl_batch_size or args.batch_size_calvin
    if args.cotrain and vbs % k:
        raise SystemExit(f"the VL batch {vbs} is not divisible by "
                         f"--gradient_accumulation_steps {k}")


def check_processes(args) -> None:
    """``--num_processes`` / ``--process_id`` name a rank of the group that
    ``--coordinator`` starts."""
    if not args.coordinator:
        if (args.num_processes, args.process_id) != (1, 0):
            raise SystemExit("--num_processes / --process_id need "
                             "--coordinator")
        return
    if args.num_processes < 1 or not \
            0 <= args.process_id < args.num_processes:
        raise SystemExit(f"--process_id {args.process_id} is not a rank of "
                         f"--num_processes {args.num_processes}")


def head_family_updates(head_type: str, window: int,
                        hidden_size: Optional[int] = None,
                        n_timesteps: int = 150, n_obs_steps: int = 6,
                        diff_horizon: int = 32) -> dict:
    """The config fields of the head flags (JAX cli/train.py:216-230): the
    family, the gpt width and, for diffusion, the timesteps, the history
    clamped to the window and the horizon at least the window (the
    reference couples them through eval_hist_size = n_obs_steps,
    train_calvin_post_strategy.py:348)."""
    updates = {}
    if head_type != "deterministic":
        updates["head_type"] = head_type
    if hidden_size:
        updates["gpt_hidden_size"] = hidden_size
    if head_type == "diffusion":
        updates["diff_timesteps"] = n_timesteps
        updates["n_obs_steps"] = min(n_obs_steps, window)
        updates["diff_horizon"] = max(diff_horizon, window)
    return updates


def make_model_config(args):
    """The model config the flags ask for (JAX ``make_model_config``)."""
    dtypes = BF16 if args.precision == "bf16" else FP32
    if args.model == "tiny":
        cfg = MODELS["tiny"](window_size=min(args.window_size, 4),
                             dtypes=dtypes)
    elif MODELS[args.model] is bc_llama:
        # bc_llama's depth is its n_layers (it takes no max_layer or
        # exit_interval; the JAX CLI's call with them raises TypeError)
        cfg = bc_llama(n_layers=args.max_layer,
                       window_size=args.window_size, dtypes=dtypes)
    else:
        cfg = MODELS[args.model](max_layer=args.max_layer,
                                 exit_interval=args.exit_interval,
                                 window_size=args.window_size, dtypes=dtypes)
    updates = {"use_state": args.use_state,
               "sep_resampler": args.sep_resampler,
               "fusion_mode": args.fusion_mode, "use_hist": args.use_hist,
               "share_exit": args.share_exit,
               "freeze_embed": args.freeze_embed,
               "freeze_sampler": args.freeze_sampler,
               "unfreeze_vit": args.unfreeze_vit,
               "remat_layers": args.remat,
               "remat_policy": args.remat_policy,
               "train_params": args.train_params,
               "use_gripper": not args.no_gripper}
    updates.update(head_family_updates(
        args.head_type, cfg.window_size, hidden_size=args.hidden_size,
        n_timesteps=args.n_timesteps, n_obs_steps=args.n_obs_steps,
        diff_horizon=args.diff_horizon))
    if args.single_exit:
        updates["multi_exit"] = False
    head_updates = {}
    for flag, field in (("exit_dropout", "dropout"),
                        ("lstm_dropout", "lstm_dropout"),
                        ("dropout_mode", "dropout_mode"),
                        ("mlp_num_hidden_layers", "mlp_num_hidden_layers"),
                        ("lstm_num_layers", "lstm_num_layers"),
                        ("pooling", "pooling")):
        v = getattr(args, flag)
        if v is not None:
            head_updates[field] = v
    if args.mlp_layernorm:
        head_updates["mlp_layernorm"] = True
    if args.lstm_layernorm:
        head_updates["lstm_layernorm"] = True
    if args.multi_step_action != 1:
        head_updates["multi_step_action"] = args.multi_step_action
    if args.use_state:
        # one flag for both state paths, as in the reference: the vision
        # token (DeerConfig.use_state) and the head's embedding
        # (HeadConfig.use_state)
        head_updates["use_state"] = True
        if args.clip_state:
            updates["clip_state"] = True
            updates["state_dim"] = 7
    if head_updates:
        updates["head"] = dataclasses.replace(cfg.head, **head_updates)
    if args.vit_tome_r > 0:
        # the merged tower in training too; weight-free, so a checkpoint
        # serves with any tome_r
        updates["vit"] = dataclasses.replace(cfg.vit, tome_r=args.vit_tome_r)
    if args.gripper_res > 0:
        if args.gripper_res % cfg.vit.patch_size:
            raise SystemExit(f"--gripper_res must be a multiple of the "
                             f"ViT patch size {cfg.vit.patch_size}")
        updates["gripper_res"] = args.gripper_res
    return dataclasses.replace(cfg, **updates)


def make_loader(args, cfg, tok, rank: int = 0, world: int = 1):
    """The training batches: DebugBatcher's with ``--debug``, else the
    CALVIN loader over ``--calvin_dataset``/training as the JAX CLI builds
    it (cli/train.py:303-324); each as rank ``rank`` of ``world``
    processes."""
    if args.debug:
        from deer_vla_tpu_torch.data.debug_data import DebugBatcher
        return DebugBatcher(cfg, tok, batch_size=args.batch_size_calvin,
                            num_batches=4, img_hw=cfg.vit.image_size,
                            grip_hw=cfg.vit.image_size, rank=rank,
                            world_size=world)
    from deer_vla_tpu_torch.data.calvin import (CalvinDataConfig,
                                                CalvinLoader,
                                                DiskCalvinDataset)
    if args.dif_ws and cfg.window_size != args.max_window_size:
        raise SystemExit(
            f"--dif_ws pads every sample to --max_window_size "
            f"({args.max_window_size}); the model window "
            f"({cfg.window_size}) must equal it (the reference trains "
            "the LSTM over the padded max window, data.py:212)")
    dcfg = CalvinDataConfig(
        dataset_dir=os.path.join(args.calvin_dataset, "training"),
        window_size=cfg.window_size, act_step=args.multi_step_action,
        text_aug=args.text_aug, data_percent=args.data_percent,
        seed=args.seed, dif_ws=args.dif_ws,
        var_min_window=args.min_window_size,
        var_max_window=args.max_window_size)
    ds = DiskCalvinDataset(dcfg, validation=False)
    return CalvinLoader(ds, tok, args.batch_size_calvin, rank=rank,
                        world_size=world, seed=args.seed,
                        workers=args.workers)


def make_vl_loader(args, cfg, tok, rank: int = 0, world: int = 1):
    """The co-training VL batches (JAX cli/train.py:351-377): LAION-style
    shards, else COCO captions, else VQA questions, split by rank (JAX
    gives every process the whole COCO / VQA batch; see ROADMAP.md,
    "Found in the reference")."""
    from deer_vla_tpu_torch.data.vl_dataset import (CaptionDataset,
                                                    VLLoader, VQADataset)
    vbs = args.vl_batch_size or args.batch_size_calvin
    if args.cotrain_laion_shards:
        import glob

        from deer_vla_tpu_torch.data.webdataset import WebLoader, WebVLLoader
        shards = sorted(glob.glob(args.cotrain_laion_shards))
        if not shards:
            raise SystemExit("--cotrain_laion_shards matched no files")
        return WebVLLoader(WebLoader(
            shards, tok, kind="laion", batch_size=vbs,
            image_size=cfg.vit.image_size, rank=rank, world_size=world,
            seed=args.seed))
    if args.coco_ann:
        ds = CaptionDataset(args.coco_image_dir, args.coco_ann,
                            image_size=cfg.vit.image_size)
    elif args.vqa_questions:
        ds = VQADataset(args.vqa_image_dir, args.vqa_questions,
                        args.vqa_ann, image_size=cfg.vit.image_size)
    else:
        raise SystemExit("--cotrain needs --coco_ann, --vqa_questions or "
                         "--cotrain_laion_shards")
    return VLLoader(ds, tok, vbs, seed=args.seed, rank=rank,
                    world_size=world)


def build_trainer(argv=None, device: Optional[str] = None):
    """(the ``Trainer`` the flags ask for, the parsed flags), untrained."""
    args = build_parser().parse_args(argv)
    check_served(args)
    from deer_vla_tpu_torch.core.device import resolve_device
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.parallel import multihost
    from deer_vla_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(device)
    if args.coordinator:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device=str(dev))
        if dev.type == "cuda":  # the card initialize gave this rank
            import torch
            dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = multihost.process_index(), multihost.process_count()
    cfg = make_model_config(args)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size,
                        max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id,
                              eoc_token_id=tok.eoc_token_id)
    loader = make_loader(args, cfg, tok, rank, world)
    vl_loader = (make_vl_loader(args, cfg, tok, rank, world) if args.cotrain
                 else None)
    tcfg = TrainConfig(
        run_dir=args.run_name,
        num_joint_epochs=args.num_joint_epochs,
        num_exit_epochs=args.num_exit_epochs,
        joint_lr=args.joint_learning_rate, exit_lr=args.exit_learning_rate,
        joint_warmup_steps=args.joint_warmup_steps,
        exit_warmup_steps=args.exit_warmup_steps,
        joint_scheduler=args.joint_lr_scheduler,
        exit_scheduler=args.exit_lr_scheduler,
        weight_decay=args.weight_decay, exit_lr_scale=args.exit_lr_scale,
        exit_decay=args.exit_decay,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        batch_size=args.batch_size_calvin, world_size=world,
        rgb_pad=args.rgb_pad, gripper_pad=args.gripper_pad,
        traj_cons=args.traj_cons, real_data=args.real_data,
        bin_coef=args.bin_coef,
        loss_multiplier_calvin=args.loss_multiplier_calvin,
        save_freq=args.save_freq, logging_steps=args.logging_steps,
        seed=args.seed, save_every_iter=args.save_every_iter,
        ema_decay=args.ema_decay, tcp_rel=args.tcp_rel)

    def log_fn(d):
        if rank == 0:
            print(json.dumps(d, default=float), flush=True)

    return Trainer(cfg, tcfg, loader, log_fn=log_fn, device=dev,
                   vl_loader=vl_loader, vl_weight=args.vl_weight), args


@record
def main(argv=None, device: Optional[str] = None):
    """Train as the flags say; returns the ``Trainer``.  A process group
    this call started is left at the end."""
    from deer_vla_tpu_torch.parallel import multihost
    had_group = multihost.is_initialized()
    try:
        trainer, args = build_trainer(argv, device)
        if args.resume and not args.from_scratch:
            start = trainer.maybe_resume()
            if start:
                print(f"resumed from epoch {start}")
        metrics = trainer.train()
        if trainer.rank == 0:
            print(json.dumps({"final": metrics}, default=float))
    finally:
        if not had_group:
            multihost.shutdown()
    return trainer


if __name__ == "__main__":
    main()
