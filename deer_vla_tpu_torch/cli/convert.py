"""Reference checkpoints -> the port's checkpoint (the JAX package's
``cli/convert.py``): a ``.ckpt`` in the JAX package's format, its ``.json``
config sidecar, and the cached calibration values as ``.values.npz``.

The reference composes two torch artifacts at eval time, the OpenFlamingo
base (strict=False, eval_calvin.py:543) and the DeeR trainable delta
(:577), and reads the model config from the delta's file name (:356-421)
and the hyperparameters stored in it (readout_args, :455-476).  This CLI
composes them once, offline, beside the raw open_clip ViT and HF MPT
backbones, so ``cli/eval``, ``cli/serve`` and ``cli/bayes_opt`` load
converted weights as they load trained ones:

    python -m deer_vla_tpu_torch.cli.convert --model mpt_dolly_3b \
        --clip_checkpoint open_clip_vit_l14.pt --mpt_checkpoint mpt_snapshot/ \
        --deer_checkpoint deer_delta.pth --out runs/conv/deer

The hyperparameters stored in the DeeR dict (head_type, early_exit_layer,
exit_interval, the head's depths and norms, pooling, multi_exit,
share_exit) are read out; what the reference keeps only in the file name
(window_size, fusion_mode, use_state, ...) is a flag.  Leaves no source
covers are the port's ``init_deer`` draws from ``--seed`` on the CPU, and
the sidecar's ``meta.init`` says so (``train/checkpoint.init_record``).
The checkpoint holds every leaf.  Conversion runs on the host; it needs no
card.
"""

from __future__ import annotations

import argparse
import dataclasses

from deer_vla_tpu_torch.utils.errors import record


def build_parser():
    p = argparse.ArgumentParser("deer-convert")
    p.add_argument("--openflamingo_checkpoint", default="",
                   help="OpenFlamingo base .pt (eval_calvin.py:543): the "
                        "perceiver/x-attn/embedding trainables")
    p.add_argument("--deer_checkpoint", default="",
                   help="DeeR trainable-delta .pth (eval_calvin.py:577)")
    p.add_argument("--clip_checkpoint", default="",
                   help="raw open_clip ViT-L-14 checkpoint (.pt or HF "
                        "snapshot dir) - the frozen vision tower the "
                        "reference downloads via open_clip "
                        "(factory.py:109-113)")
    p.add_argument("--mpt_checkpoint", default="",
                   help="raw HF MPT backbone (.bin/.safetensors file or "
                        "snapshot dir) - the frozen decoder the reference "
                        "downloads from HF (factory.py:124-139)")
    p.add_argument("--out", required=True,
                   help="output path prefix (writes <out>.ckpt + <out>.json)")
    p.add_argument("--model", default="mpt_dolly_3b",
                   help="architecture registry key")
    p.add_argument("--max_layer", type=int, default=-1,
                   help="decoder truncation depth; default: the ckpt's "
                        "early_exit_layer+1 readout, else the registry "
                        "default")
    p.add_argument("--exit_interval", type=int, default=0,
                   help="0 = readout from the ckpt dict")
    p.add_argument("--window_size", type=int, default=12)
    p.add_argument("--fusion_mode", default="post",
                   choices=["pre", "post", "two_way", "vit_concat"])
    p.add_argument("--use_state", action="store_true")
    p.add_argument("--use_hist", action="store_true")
    p.add_argument("--sep_resampler", action="store_true")
    p.add_argument("--no_gripper", action="store_true")
    p.add_argument("--seed", type=int, default=42,
                   help="the init_deer draw of the leaves no source covers; "
                        "recorded in the sidecar meta")
    p.add_argument("--allow_unconsumed", action="store_true",
                   help="do not fail when source keys are left unconsumed "
                        "(naming drift is otherwise a hard error)")
    return p


def _readout(ckpt_obj: dict, name: str, default):
    """readout_args equivalent (eval_calvin.py:455-476)."""
    v = ckpt_obj.get(name, default) if isinstance(ckpt_obj, dict) else default
    return default if v is None else v


def converted_config(args, deer_obj: dict):
    """The model config: ``--model``'s preset at the depth and exit
    interval the flags or the DeeR dict give, with the DeeR dict's head
    readouts and the variant flags."""
    from deer_vla_tpu_torch.cli.eval import MODELS
    from deer_vla_tpu_torch.core.config import bc_llama
    factory = MODELS[args.model]
    if factory is bc_llama:
        raise SystemExit("--model llama_9b: the converter maps the "
                         "reference's MPT decoder names only")
    defaults = factory()  # registry defaults for this architecture
    max_layer = args.max_layer
    if max_layer <= 0:
        eel = int(_readout(deer_obj, "early_exit_layer", -1))
        max_layer = eel + 1 if eel > 0 else defaults.n_layers
    exit_interval = args.exit_interval or int(
        _readout(deer_obj, "exit_interval", defaults.exit_interval))
    if args.model == "tiny":
        cfg = factory(n_layers=max_layer if args.max_layer > 0 else 4,
                      exit_interval=exit_interval,
                      window_size=min(args.window_size, 4))
    else:
        cfg = factory(max_layer=max_layer, exit_interval=exit_interval,
                      window_size=args.window_size)
    head = dataclasses.replace(
        cfg.head,
        mlp_layernorm=bool(_readout(deer_obj, "mlp_layernorm", False)),
        lstm_layernorm=bool(_readout(deer_obj, "lstm_layernorm", False)),
        mlp_num_hidden_layers=int(_readout(deer_obj, "mlp_num_hidden_layers",
                                           cfg.head.mlp_num_hidden_layers)),
        lstm_num_layers=int(_readout(deer_obj, "lstm_num_layers",
                                     cfg.head.lstm_num_layers)),
        pooling=str(_readout(deer_obj, "pooling", cfg.head.pooling)),
        use_state=args.use_state or cfg.head.use_state)
    return dataclasses.replace(
        cfg, head=head,
        head_type=str(_readout(deer_obj, "head_type", "deterministic")),
        multi_exit=bool(_readout(deer_obj, "multi_exit", True)),
        share_exit=bool(_readout(deer_obj, "share_exit", False)),
        fusion_mode=args.fusion_mode, use_hist=args.use_hist,
        use_state=args.use_state, sep_resampler=args.sep_resampler,
        use_gripper=not args.no_gripper)


@record
def main(argv=None):
    """Convert as the flags say; returns the written ``.ckpt`` path."""
    args = build_parser().parse_args(argv)
    if not (args.openflamingo_checkpoint or args.deer_checkpoint
            or args.clip_checkpoint or args.mpt_checkpoint):
        raise SystemExit("need at least one source checkpoint "
                         "(--openflamingo_checkpoint / --deer_checkpoint / "
                         "--clip_checkpoint / --mpt_checkpoint)")
    if not (args.openflamingo_checkpoint
            or (args.clip_checkpoint and args.mpt_checkpoint)):
        print("WARNING: missing backbone sources - the frozen tower(s) in "
              "the output are RANDOM init from --seed; the result only "
              "serves if the published delta was trained against that same "
              "random backbone (it was not). Compose "
              "--clip_checkpoint/--mpt_checkpoint/--openflamingo_checkpoint "
              "for real artifacts.")
    import numpy as np
    import torch

    from deer_vla_tpu_torch.models.flamingo import init_deer
    from deer_vla_tpu_torch.ops.layers import tree_map
    from deer_vla_tpu_torch.train.checkpoint import (init_record,
                                                     save_calibration_values,
                                                     save_checkpoint)
    from deer_vla_tpu_torch.utils.convert import (convert_with_audit,
                                                  load_torch_checkpoint,
                                                  torch_state_dict_to_numpy)

    # -- the DeeR dict: hyperparameter readouts + cached calibration values
    deer_obj = {}
    if args.deer_checkpoint:
        deer_obj = torch.load(args.deer_checkpoint, map_location="cpu",
                              weights_only=False)
        if not isinstance(deer_obj, dict):
            deer_obj = {}
    cfg = converted_config(args, deer_obj)

    # the tree of numpy fp32 leaves the converter writes into
    params = tree_map(lambda t: t.numpy(),
                      init_deer(cfg, seed=args.seed, device="cpu"))
    sources = []
    for label, path in (("clip_vit", args.clip_checkpoint),
                        ("mpt_backbone", args.mpt_checkpoint),
                        ("openflamingo_base", args.openflamingo_checkpoint),
                        ("deer_delta", args.deer_checkpoint)):
        if not path:
            continue
        if label == "deer_delta" and deer_obj:
            sd = torch_state_dict_to_numpy(deer_obj)  # already loaded above
        else:
            sd = load_torch_checkpoint(path)
        counts, report = convert_with_audit(sd, params, cfg)
        del sd
        consumed = sum(counts.values())
        print(f"{label}: {consumed} tensors consumed "
              f"({len(report['ignored'])} ignored, "
              f"{len(report['truncated'])} beyond-truncation, "
              f"{len(report['unconsumed'])} unconsumed) from {path}")
        if report["unconsumed"]:
            sample = sorted(report["unconsumed"])[:12]
            msg = (f"{label}: {len(report['unconsumed'])} source keys were "
                   f"NOT consumed (naming drift?): {sample}")
            if args.allow_unconsumed:
                print("WARNING:", msg)
            else:
                raise SystemExit(msg + "  (--allow_unconsumed to override)")
        sources.append({"role": label, "path": path, "tensors": consumed,
                        "unconsumed": len(report["unconsumed"])})

    out = args.out[:-5] if args.out.endswith(".ckpt") else args.out
    meta = {"seed": args.seed, "converted_from": sources,
            "epoch": int(_readout(deer_obj, "epoch", -1)),
            "init": init_record(args.seed, "cpu", cfg)}
    # views of the arrays (transposed ones too): the writer makes each leaf
    # contiguous as it writes it, so no second copy of the tree is held
    path = save_checkpoint(out, tree_map(torch.from_numpy, params), cfg,
                           meta=meta)
    print(f"wrote {path} (+ config sidecar)")

    values = deer_obj.get("values")
    if values is not None:
        def _np32(v):
            if isinstance(v, torch.Tensor):  # possibly bf16 / fp16
                v = v.to(torch.float32).numpy()
            return np.asarray(v, np.float32)
        if isinstance(values, dict):
            values = np.stack([_np32(values[k]) for k in sorted(values)])
        else:
            values = _np32(values)
        save_calibration_values(out, values, {"source": "torch_ckpt"})
        print(f"wrote {out}.values.npz (cached calibration distribution, "
              f"shape {values.shape})")
    return path


if __name__ == "__main__":
    main()
