"""Serve a DeeR model as an HTTP action service on the card (the JAX
package's ``cli/serve.py``; ``serving/server.py`` has the protocol):

    python -m deer_vla_tpu_torch.cli.serve \
        --evaluate_from_checkpoint runs/deer/deer_8.ckpt --exit_ratio 0.8 \
        --port 8000
    python -m deer_vla_tpu_torch.cli.serve --model deer_3b \
        --thresholds 1e-4 1e-4 1e-4 1e-4 1e-4 1e8 --batch_lanes 8

The weights are a checkpoint (its config from the ``.json`` sidecar), or
``init_deer`` draws of ``--model`` from ``--seed``.  Thresholds come from,
in this order: ``--thresholds`` (the BO output contract), the checkpoint's
calibration values sidecar (``cli/eval --value_cache`` on the checkpoint's
stem) solved at ``--exit_ratio``, or full depth with a warning.
``--batch_lanes N`` serves through the micro-batching core
(``serving/batcher.py``); ``--quantize`` runs the decoder through K3 / K4.

``main(argv, device=None)`` serves on the card; ``device="cpu"`` runs the
plain versions on the CPU.  The AOT artifact (``--artifact``, ``--bundle``)
waits for ROADMAP.md M14b and a transformers tokenizer for M9: those flags
raise SystemExit naming the item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from deer_vla_tpu_torch.utils.errors import record

# JAX flags not served yet: (flag, ROADMAP.md item); a non-empty value
# raises
UNSERVED = (
    ("--artifact", "M14b (the serving artifact: serving/export, "
                   "cli/export)"),
    ("--bundle", "M14b (the serving artifact: serving/export, cli/export)"),
    ("--tokenizer_path", "M9 (a transformers tokenizer)"),
)


def build_parser() -> argparse.ArgumentParser:
    from deer_vla_tpu_torch.cli.eval import MODELS
    p = argparse.ArgumentParser(
        description="DeeR-VLA HTTP action server on the PyTorch port")
    p.add_argument("--evaluate_from_checkpoint", default="")
    p.add_argument("--model", default="tiny", choices=sorted(MODELS),
                   help="config name when no checkpoint is given")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_streams", type=int, default=64)
    p.add_argument("--batch_lanes", type=int, default=0,
                   help=">0: the micro-batching core (serving/batcher.py): "
                        "concurrent streams share one batched step a "
                        "dispatch; capacity = this many streams.  The "
                        "deterministic and diffusion heads")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="micro-batch collection window after the first "
                        "pending request")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--exit_ratio", type=float, default=0.8)
    p.add_argument("--exit_dist", default="exp",
                   choices=["exp", "gauss", "gamma"])
    p.add_argument("--threshold_type", default="L2",
                   choices=["mean", "L2", "max", "cosine"])
    p.add_argument("--thresholds", type=float, nargs="+", default=None,
                   help="per-exit thresholds (BO output); override the "
                        "sidecar solve")
    p.add_argument("--steps_per_stage", type=int, default=1)
    p.add_argument("--vit_tome_r", type=int, default=0,
                   help="ToMe: merge N ViT patch-token pairs a layer "
                        "(ops/tome.py); 0 = the exact tower")
    p.add_argument("--gripper_res", type=int, default=-1,
                   help="the gripper camera's input size (84 = CALVIN's "
                        "native); -1 = the checkpoint config's, 0 = the "
                        "tower's")
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8_w8a8", "int4",
                            "int4_w8a8"])
    p.add_argument("--tcp_rel", action="store_true",
                   help="the model was trained on tcp-frame actions; "
                        "actions go back to the world frame at each "
                        "request's robot_obs (per-stream core)")
    p.add_argument("--diff_steps", type=int, default=0,
                   help="diffusion head: >0 samples plans with a DDIM "
                        "subsequence of this many U-Net evaluations "
                        "instead of the full DDPM chain")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--oneshot_healthz", action="store_true",
                   help="bind, print the healthz JSON and exit (smoke "
                        "testing)")
    for flag, _ in UNSERVED:
        p.add_argument(flag, default="")
    return p


def check_served(args) -> None:
    for flag, item in UNSERVED:
        if getattr(args, flag[2:]):
            raise SystemExit(f"{flag} is not served by the PyTorch port yet "
                             f"(ROADMAP.md {item})")


def build_core(args, device=None):
    """(serving core, cfg): the engine, the tokenizer and the core on
    ``device`` (the card unless given)."""
    from deer_vla_tpu_torch.cli.eval import load_model
    from deer_vla_tpu_torch.core.device import resolve_device
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.diffusion_policy import (
        BatchedDiffusionSampler, DiffusionSamplerPolicy)
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.serving.batcher import BatchedActionServer
    from deer_vla_tpu_torch.serving.server import DeerActionServer

    check_served(args)
    if args.batch_lanes > 0 and args.tcp_rel:  # before drawing weights
        raise SystemExit("--batch_lanes does not apply the tcp->world "
                         "action-frame conversion; serve tcp_rel models "
                         "with the per-stream core")
    dev = resolve_device(device)
    cfg, params = load_model(args, dev)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    if args.vit_tome_r > 0:  # weight-free, so safe after loading
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, tome_r=args.vit_tome_r))
    if args.gripper_res >= 0:  # -1 keeps the (sidecar) config's
        if args.gripper_res % cfg.vit.patch_size:
            raise SystemExit(f"--gripper_res must be a multiple of the ViT "
                             f"patch size {cfg.vit.patch_size}")
        cfg = dataclasses.replace(cfg, gripper_res=args.gripper_res)
    quantize = None if args.quantize == "none" else args.quantize
    policy = ScanDeerPolicy(
        params, cfg, threshold_type=args.threshold_type,
        max_layer=args.max_layer if args.max_layer > 0 else None,
        steps_per_stage=args.steps_per_stage,
        indexed_mm=cfg.mpt.arch == "mpt", quantize=quantize, device=dev)
    policy.set_thresholds(resolve_thresholds(args, policy))
    diffusion = dict(seed=args.seed, sample_steps=args.diff_steps,
                     ddim_eta=args.ddim_eta)
    if args.batch_lanes > 0:
        if cfg.head_type == "diffusion":
            policy = BatchedDiffusionSampler(policy, params, **diffusion)
        return BatchedActionServer(policy, tok, lanes=args.batch_lanes,
                                   window_ms=args.batch_window_ms), cfg
    if cfg.head_type == "diffusion":
        # exit features -> (k, 7) plans (eval_utils.py:388-419)
        policy = DiffusionSamplerPolicy(policy, params, **diffusion)
    return DeerActionServer(policy, tok, max_streams=args.max_streams,
                            tcp_rel=args.tcp_rel), cfg


def resolve_thresholds(args, policy) -> list:
    """``--thresholds``, else the checkpoint's values sidecar solved at
    ``--exit_ratio``, else full depth (with a warning)."""
    exits = list(policy.exits)
    if args.thresholds:
        if len(args.thresholds) != len(exits):
            raise SystemExit(f"--thresholds needs {len(exits)} values "
                             f"(exits {exits})")
        return list(args.thresholds)
    if args.evaluate_from_checkpoint:
        from deer_vla_tpu_torch.models.value_net import solve_thresholds
        from deer_vla_tpu_torch.train.checkpoint import \
            load_calibration_values
        values = load_calibration_values(args.evaluate_from_checkpoint)
        if values is not None:
            th, probs = solve_thresholds(
                values, args.exit_ratio, exits, max_layer=exits[-1] + 1,
                exit_dist=args.exit_dist, model_name=args.model)
            print(json.dumps({"thresholds": {str(k): float(v)
                                             for k, v in th.items()},
                              "exit_probs": [float(p) for p in probs]}))
            return [th[e] for e in exits]
    print("WARNING: no calibration values sidecar and no --thresholds: "
          "serving at FULL DEPTH (no early exit).  Run cli/eval with "
          "--value_cache on the checkpoint's stem to write the sidecar, or "
          "pass --thresholds.")
    return [-1e30] * (len(exits) - 1) + [1e30]


@record
def main(argv=None, device: Optional[str] = None) -> int:
    args = build_parser().parse_args(argv)
    from deer_vla_tpu_torch.serving.server import make_server

    core, cfg = build_core(args, device)
    httpd = make_server(core, host=args.host, port=args.port)
    host, port = httpd.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}",
                      "exits": core.healthz()["exits"],
                      "head_type": cfg.head_type,
                      "device": str(core.device)}), flush=True)
    try:
        if args.oneshot_healthz:
            print(json.dumps(core.healthz()), flush=True)
            return 0
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if hasattr(core, "shutdown"):
            core.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
