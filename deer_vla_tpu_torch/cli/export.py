"""Export a checkpoint's dynamic-exit serving step to a weight-free
``torch.export`` artifact (the JAX package's ``cli/export.py``;
``serving/export.py`` has the layout).

    python -m deer_vla_tpu_torch.cli.export \\
        --evaluate_from_checkpoint runs/d/deer_3.ckpt \\
        --out runs/d/deer_3.step --platforms gpu --check
    python -m deer_vla_tpu_torch.cli.export --model deer_3b --quantize int4 \\
        --out runs/d/deer_3b_q4.step --platforms gpu --bundle

The flags and their defaults are JAX's.  ``--platforms`` takes cpu and gpu
(or cuda); the default, tpu, raises SystemExit: the port serves on the GPU.
The config's media token becomes the tokenizer's, as ``cli/serve`` sets it
(the programs compare the token ids with it).
``--check`` reloads the artifact and holds one step against the live
engine on the same device, bit for bit.  ``main(argv, device=None)``
exports on the card; ``device="cpu"`` traces and checks on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

from deer_vla_tpu_torch.utils.errors import record


def build_parser() -> argparse.ArgumentParser:
    from deer_vla_tpu_torch.cli.eval import MODELS
    p = argparse.ArgumentParser(
        description="Export the DeeR-VLA serving step on the PyTorch port")
    p.add_argument("--evaluate_from_checkpoint", default="")
    p.add_argument("--model", default="tiny", choices=sorted(MODELS),
                   help="config name when no checkpoint is given")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1,
                   help="stream count baked into the artifact's shapes")
    p.add_argument("--platforms", nargs="+", default=["tpu"],
                   help="where the artifact may be loaded: cpu, gpu (or "
                        "cuda); a program traced on one moves to the other "
                        "at load.  tpu raises: the port serves on the GPU")
    p.add_argument("--threshold_type", default="L2")
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--gripper_res", type=int, default=-1,
                   help="native-resolution gripper tower baked into the "
                        "exported program's input shapes (see cli/eval "
                        "--gripper_res). -1 = inherit the checkpoint config")
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8_w8a8", "int4", "int4_w8a8"],
                   help="bake the quantized stacked layout (ops/quant.py) "
                        "into the artifact; the serving host quantizes "
                        "checkpoint weights to match")
    p.add_argument("--bundle", action="store_true",
                   help="also write <out>.weights: the packed serving "
                        "weight trees, making the artifact self-contained "
                        "(serving/export.BundledScanPolicy serves it with "
                        "no checkpoint and no model-building Python)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--check", action="store_true",
                   help="reload + run one step vs the live engine")
    return p


def check_inputs(cfg, batch: int, seed: int = 0):
    """The ``--check`` step's inputs (JAX's): random frames, token ids 7
    behind the media token, a full mask, random proprio rows."""
    import numpy as np

    from deer_vla_tpu_torch.eval.scan_policy import folded_window
    r = np.random.RandomState(seed)
    rows = batch * folded_window(cfg)
    hw, s = cfg.vit.image_size, cfg.text_len
    ghw = cfg.gripper_res or hw
    img = r.randn(rows, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(rows, 1, 1, 3, ghw, ghw).astype(np.float32)
    trows = rows if cfg.use_hist else batch
    ids = np.full((trows, s), 7, np.int32)
    ids[:, 0] = cfg.media_token_id
    mask = np.ones((trows, s), np.int32)
    state = None
    if cfg.use_state or cfg.head.use_state:
        state = r.randn(rows, 1, 1, cfg.state_dim).astype(np.float32)
    return img, grip, ids, mask, state


@record
def main(argv=None, device: Optional[str] = None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from deer_vla_tpu_torch.cli.eval import load_model
    from deer_vla_tpu_torch.core.device import resolve_device
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.serving.export import (ExportedScanPolicy,
                                                   artifact_bytes,
                                                   check_platforms,
                                                   export_policy,
                                                   save_bundle, save_exported)

    platforms = check_platforms(args.platforms)
    dev = resolve_device(device)
    cfg, params = load_model(args, dev)
    # the media token cli/serve's tokenizer sends: the programs compare the
    # ids with it, so a served artifact must bake the same one
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    if args.gripper_res >= 0:  # -1 = inherit the (sidecar) config
        if args.gripper_res and args.gripper_res % cfg.vit.patch_size:
            raise SystemExit(f"--gripper_res must be a multiple of the "
                             f"ViT patch size {cfg.vit.patch_size}")
        cfg = dataclasses.replace(cfg, gripper_res=args.gripper_res)
    quantize = None if args.quantize == "none" else args.quantize
    max_layer = args.max_layer if args.max_layer > 0 else None
    out = export_policy(
        params, cfg, batch_size=args.batch, platforms=tuple(platforms),
        threshold_type=args.threshold_type, max_layer=max_layer,
        quantize=quantize, return_policy=args.bundle, device=dev)
    if args.bundle:
        programs, meta, policy = out
        save_bundle(args.out, programs, meta, policy)
        del policy
        wbytes = os.path.getsize(args.out + ".weights")
    else:
        programs, meta = out
        save_exported(args.out, programs, meta)
        wbytes = 0
    print(json.dumps({"out": args.out, "bytes": artifact_bytes(args.out),
                      "weight_bytes": wbytes, "exits": meta["exits"],
                      "platforms": meta["platforms"]}))

    if args.check:
        here = "gpu" if dev.type == "cuda" else dev.type
        if here not in platforms:
            print(f"--check skipped: this device ({here}) is not among the "
                  f"export platforms {platforms}")
            return 0
        from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
        kw = dict(threshold_type=args.threshold_type, max_layer=max_layer,
                  quantize=quantize, device=dev)
        live = ScanDeerPolicy(params, cfg, indexed_mm=meta["indexed_mm"],
                              **kw)
        aot = ExportedScanPolicy(args.out, params, cfg, **kw)
        inputs = check_inputs(cfg, args.batch)
        a_live = live.step(*inputs)
        a_aot = aot.step(*inputs)
        ok = (bool(np.array_equal(a_live, a_aot))
              and live.last_exit_layer == aot.last_exit_layer)
        print(json.dumps({"check": "bit-exact" if ok else "MISMATCH",
                          "live": a_live.reshape(-1)[:3].tolist(),
                          "aot": a_aot.reshape(-1)[:3].tolist()}))
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
