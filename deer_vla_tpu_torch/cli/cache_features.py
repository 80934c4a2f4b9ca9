"""Cache RICES retrieval features on the port (the JAX package's
``cli/cache_features.py``; upstream open_flamingo/scripts/
cache_rices_features.py): the eval model's vision tower over a dataset's
images once, the L2-normalized (N, D) index written as npz, so that
``cli/vl_eval --rices --cached_features FILE`` skips the sweep.

    python -m deer_vla_tpu_torch.cli.cache_features --task caption \
        --debug --eval_model blip --model base --output feats.npz

``main(argv, device=None)`` runs on the card; ``device="cpu"`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from deer_vla_tpu_torch.utils.errors import record


def build_parser():
    p = argparse.ArgumentParser(description="Cache RICES features on the "
                                            "PyTorch port")
    p.add_argument("--task",
                   choices=["caption", "flickr", "vqa", "textvqa", "vizwiz",
                            "okvqa"],
                   default="caption")
    p.add_argument("--model", default="tiny")
    p.add_argument("--eval_model", default="flamingo",
                   choices=["flamingo", "blip"],
                   help="the family that embeds the index (that of the "
                        "vl_eval run reading it: the feature spaces "
                        "differ)")
    p.add_argument("--evaluate_from_checkpoint", default="")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--annotations", default="")
    p.add_argument("--questions", default="")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--output", required=True, help="npz feature index path")
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    return p


@record
def main(argv=None, device: Optional[str] = None) -> dict:
    args = build_parser().parse_args(argv)
    from deer_vla_tpu_torch.cli.vl_eval import (build_dataset, fixture_dir,
                                                resolve_paths)
    from deer_vla_tpu_torch.eval.eval_models import make_eval_model
    model = make_eval_model(args, device)
    size = model.image_size
    with fixture_dir(args) as tmp:
        ds = build_dataset(args, size, *resolve_paths(args, tmp))
        n = min(args.num_samples, len(ds))
        raw = np.stack([ds[i]["image"] for i in range(n)])
    bs = args.batch_size
    feats = np.concatenate([model.embed_images(raw[i:i + bs])
                            for i in range(0, n, bs)], 0)
    out = args.output if args.output.endswith(".npz") else args.output + \
        ".npz"
    # the exact path (an open handle stops np.savez appending '.npz')
    with open(out, "wb") as f:
        np.savez(f, features=feats)
    result = {"task": args.task, "eval_model": model.name,
              "n": int(feats.shape[0]), "dim": int(feats.shape[1]),
              "output": out}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
