"""Interleaved vision-language pretraining CLI of the port (the JAX
package's ``cli/pretrain.py``; upstream open_flamingo/train/train.py:
51-483): LAION / MMC4 webdataset tar shards -> next-token LM training of
the gated cross-attention, perceiver and embedding leaves.

    python -m deer_vla_tpu_torch.cli.pretrain --debug --model tiny --steps 2

``main(argv, device=None)`` trains on the card; ``device="cpu"`` runs the
plain versions on the CPU.  ``--debug`` writes one synthetic LAION and one
MMC4 shard a process into ``--run_name`` and trains on them.  The sources
take turns step by step; a checkpoint ``pretrain_{epoch}.ckpt`` is written
at each epoch's end.  ``--coordinator HOST:PORT --num_processes N
--process_id I`` trains data parallel: each process reads its own shards
and the gradients are averaged across processes; process 0 writes the
checkpoints.  The filters drop different numbers of samples on each
process, so every process takes a source's step only while every process
has a batch of it: a source ends for all when it ends for one.

The JAX CLI parses ``--laion_weight`` / ``--mmc4_weight`` and never uses
them (ROADMAP.md, "Found in the reference"); this CLI computes what the JAX
one computes and raises on a value other than their defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time
from typing import Optional

from deer_vla_tpu_torch.utils.errors import record

LAION_WEIGHT, MMC4_WEIGHT = 0.2, 1.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeeR-VLA VL pretraining on the PyTorch port")
    p.add_argument("--model", default="mpt_dolly_3b",
                   choices=["mpt_dolly_3b", "mpt_9b", "llama_9b", "tiny"])
    p.add_argument("--max_layer", type=int, default=12)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--tokenizer_path", default="")
    # data (upstream --laion-shards / --mmc4-shards)
    p.add_argument("--laion_shards", default="", help="glob of LAION tars")
    p.add_argument("--mmc4_shards", default="", help="glob of MMC4 tars")
    p.add_argument("--batch_size_laion", type=int, default=8)
    p.add_argument("--batch_size_mmc4", type=int, default=4)
    p.add_argument("--laion_weight", type=float, default=LAION_WEIGHT,
                   help="parsed for the JAX CLI's sake; it weighs nothing "
                        "there, and another value raises here")
    p.add_argument("--mmc4_weight", type=float, default=MMC4_WEIGHT,
                   help="as --laion_weight")
    p.add_argument("--mmc4_max_images", type=int, default=6)
    p.add_argument("--mmc4_min_images", type=int, default=1)
    p.add_argument("--mmc4_sim_threshold", type=float, default=0.24)
    p.add_argument("--max_tokens", type=int, default=256)
    # optimization (upstream defaults, train.py:96-135)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1875)
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--lr_scheduler", default="constant")
    p.add_argument("--steps", type=int, default=0,
                   help="optimizer steps in all (0 = one pass over the "
                        "shards an epoch)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--run_name", default="runs/pretrain")
    p.add_argument("--logging_steps", type=int, default=20)
    p.add_argument("--debug", action="store_true",
                   help="synthetic shards, no dataset")
    p.add_argument("--coordinator", default="")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    return p


def check_args(args) -> None:
    from deer_vla_tpu_torch.cli.train import check_processes
    if args.tokenizer_path:
        raise SystemExit("--tokenizer_path is not served by the PyTorch "
                         "port yet (ROADMAP.md M9 (a transformers "
                         "tokenizer))")
    for flag, value, default in (("--laion_weight", args.laion_weight,
                                  LAION_WEIGHT),
                                 ("--mmc4_weight", args.mmc4_weight,
                                  MMC4_WEIGHT)):
        if value != default:
            raise SystemExit(
                f"{flag} {value}: the JAX CLI parses it and weighs no loss "
                "with it (ROADMAP.md, found in the reference); the port "
                "computes what JAX computes and takes the default only")
    check_processes(args)


def model_config(args):
    """The flags' model config (the JAX CLI fills the policy flags it does
    not have: exit interval 2, window 12, one-step actions)."""
    from deer_vla_tpu_torch.cli.train import build_parser as train_parser
    from deer_vla_tpu_torch.cli.train import make_model_config
    ns = train_parser().parse_args([
        "--model", args.model, "--max_layer", str(args.max_layer),
        "--precision", args.precision])
    return make_model_config(ns)


def debug_shards(args, cfg, world: int = 1):
    """One synthetic LAION and one MMC4 shard a process in ``--run_name``,
    two batches each, shard i drawn from seed i; process 0 writes them
    all, the others wait for it."""
    from deer_vla_tpu_torch.data.webdataset import (
        write_synthetic_laion_shard, write_synthetic_mmc4_shard)
    from deer_vla_tpu_torch.parallel import multihost
    names = [(os.path.join(args.run_name, f"debug-laion-{i:03d}.tar"),
              os.path.join(args.run_name, f"debug-mmc4-{i:03d}.tar"))
             for i in range(world)]
    if multihost.process_index() == 0:
        os.makedirs(args.run_name, exist_ok=True)
        for i, (lp, mp) in enumerate(names):
            write_synthetic_laion_shard(lp, n=2 * args.batch_size_laion,
                                        hw=cfg.vit.image_size, seed=i)
            write_synthetic_mmc4_shard(mp, n=2 * args.batch_size_mmc4,
                                       hw=cfg.vit.image_size, seed=i)
    if world > 1:
        import torch
        torch.distributed.barrier()
    return [lp for lp, _ in names], [mp for _, mp in names]


@record
def main(argv=None, device: Optional[str] = None):
    """Pretrain as the flags say; returns (params, the last metrics)."""
    args = build_parser().parse_args(argv)
    check_args(args)
    import torch

    from deer_vla_tpu_torch.core.device import resolve_device
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.data.webdataset import (WebLoader,
                                                    prepare_interleaved_batch)
    from deer_vla_tpu_torch.models.flamingo import init_deer, trainable_mask
    from deer_vla_tpu_torch.parallel import multihost
    from deer_vla_tpu_torch.train.checkpoint import (init_record,
                                                     save_checkpoint)
    from deer_vla_tpu_torch.train.optimizer import make_optimizer
    from deer_vla_tpu_torch.train.pretrain import make_pretrain_step

    dev = resolve_device(device)
    had_group = multihost.is_initialized()
    if args.coordinator:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device=str(dev))
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        rank, world = multihost.process_index(), multihost.process_count()
        cfg = model_config(args)
        tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size,
                            max_length=cfg.text_len)
        cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id,
                                  eoc_token_id=tok.eoc_token_id)
        sim_threshold = args.mmc4_sim_threshold
        if args.debug:
            laion_shards, mmc4_shards = debug_shards(args, cfg, world)
            sim_threshold = 0.0
        else:
            laion_shards = (sorted(glob.glob(args.laion_shards))
                            if args.laion_shards else [])
            mmc4_shards = (sorted(glob.glob(args.mmc4_shards))
                           if args.mmc4_shards else [])
        if not laion_shards and not mmc4_shards:
            raise SystemExit("need --laion_shards and/or --mmc4_shards "
                             "(or --debug)")
        common = dict(image_size=cfg.vit.image_size, rank=rank,
                      world_size=world, seed=args.seed)
        loaders = []
        if laion_shards:
            loaders.append(("laion", WebLoader(
                laion_shards, tok, kind="laion",
                batch_size=args.batch_size_laion, **common)))
        if mmc4_shards:
            loaders.append(("mmc4", WebLoader(
                mmc4_shards, tok, kind="mmc4",
                batch_size=args.batch_size_mmc4, max_tokens=args.max_tokens,
                sim_threshold=sim_threshold,
                min_num_images=args.mmc4_min_images,
                max_num_images=args.mmc4_max_images, **common)))

        params = init_deer(cfg, seed=args.seed, device=dev)
        mask = trainable_mask(params, cfg, "joint")
        opt = make_optimizer(params, cfg, phase="joint",
                             learning_rate=args.learning_rate,
                             warmup_steps=args.warmup_steps,
                             total_steps=max(args.steps, 1),
                             scheduler=args.lr_scheduler,
                             weight_decay=args.weight_decay, trainable=mask)
        step_fn = make_pretrain_step(cfg, opt)
        opt_state = opt.init(params)
        metrics = {}
        done = 0
        t0 = time.time()
        # the sources take turns, one step each (JAX cli/pretrain.py:
        # 220-249)
        for epoch in range(args.epochs):
            for _, ld in loaders:
                ld.set_epoch(epoch)
            iters = [(kind, iter(ld)) for kind, ld in loaders]
            while iters and (args.steps == 0 or done < args.steps):
                for kind, it in list(iters):
                    raw = next(it, None)
                    if not multihost.all_ranks(raw is not None):
                        iters.remove((kind, it))
                        continue
                    batch = {"image": prepare_interleaved_batch(
                                 raw, cfg.vit.image_size, device=dev),
                             "input_ids": torch.as_tensor(
                                 raw["input_ids"].astype("int64"),
                                 device=dev),
                             "attention_mask": torch.as_tensor(
                                 raw["attention_mask"].astype("int64"),
                                 device=dev)}
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                    done += 1
                    if rank == 0 and (done % args.logging_steps == 0
                                      or done == 1):
                        print(json.dumps(
                            {"step": done, "source": kind,
                             "lm_loss": float(metrics["lm_loss"]),
                             "lm_acc": float(metrics["lm_acc"]),
                             "steps_per_sec": done / (time.time() - t0)}),
                            flush=True)
                    if args.steps and done >= args.steps:
                        break
            path = os.path.join(args.run_name, f"pretrain_{epoch}")
            if rank == 0:
                path = save_checkpoint(
                    path, params, cfg,
                    meta={"epoch": epoch, "phase": "pretrain",
                          "seed": args.seed,
                          "init": init_record(args.seed, dev, cfg)},
                    trainable_mask=mask)
                print(json.dumps({"saved": path, "epoch": epoch,
                                  "steps": done}), flush=True)
            if world > 1:
                torch.distributed.barrier()
        if rank == 0:
            print(json.dumps({"final_steps": done}), flush=True)
    finally:
        if not had_group:
            multihost.shutdown()
    return params, {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
