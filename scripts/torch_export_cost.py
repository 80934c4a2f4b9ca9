"""The host costs the serving artifact brings, on the CPU (no card needed).

    python3 scripts/torch_export_cost.py [--depth-only] [--out FILE]

(1) Operator dispatch: the time of one call of an operator registered the
way ``ops/kernels`` registers K1-K4 (``torch.library.Library`` define /
impl with a fake implementation), of the same function registered with the
``torch.library.custom_op`` decorator, and of the function called directly,
on tiny CPU tensors, under ``inference_mode`` and in grad mode (median of 5
rounds of 20,000 calls).  The CPU implementation allocates the output and
nothing else, so the difference is the dispatcher's.

(2) The artifact's host work by graph node: ``serving/export.export_policy``,
``save_exported`` and ``load_exported`` timed on a model with deer_3b's
depths (24 ViT, 6 perceiver and 12 decoder layers, exits every 2) at
deer_tiny's widths, unquantized and int4, with each artifact's node count.
Its time does not depend on the widths: a program holds one node an
operation.

Each measurement is one JSON line, also written to ``--out`` (default
``chiprun_out/torch_export_cost.jsonl``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def emit(out, row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    out.write(line + "\n")


def dispatch_cost(torch) -> dict:
    lib = torch.library.Library("cost", "DEF")
    lib.define("op(Tensor x) -> Tensor")

    def impl(x):
        return torch.empty_like(x)

    lib.impl("op", impl, "CPU")
    torch.library.register_fake("cost::op", impl)

    @torch.library.custom_op("cost_deco::op", mutates_args=(),
                             schema="(Tensor x) -> Tensor")
    def deco(x):
        return torch.empty_like(x)

    deco.register_fake(impl)
    x = torch.zeros(2, 8)

    def us_a_call(fn, calls=20_000, rounds=5) -> float:
        for _ in range(1_000):
            fn(x)
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(x)
            times.append((time.perf_counter() - t0) / calls * 1e6)
        return statistics.median(times)

    row = {}
    for mode, ctx in (("inference", torch.inference_mode),
                      ("grad", torch.enable_grad)):
        with ctx():
            row[mode] = {"direct_us": us_a_call(impl),
                         "library_us": us_a_call(torch.ops.cost.op),
                         "custom_op_us": us_a_call(torch.ops.cost_deco.op)}
    return {"measure": "dispatch", **row}


def artifact_cost(torch, quantize) -> dict:
    from deer_vla_tpu_torch.core.config import deer_tiny
    from deer_vla_tpu_torch.models.flamingo import init_deer
    from deer_vla_tpu_torch.serving.export import (export_policy,
                                                   load_exported,
                                                   save_exported)
    cfg = deer_tiny(n_layers=12, exit_interval=2)
    cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, layers=24),
        perceiver=dataclasses.replace(cfg.perceiver, depth=6))
    params = init_deer(cfg, seed=0, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "a.step")
        t0 = time.perf_counter()
        programs, meta = export_policy(params, cfg, platforms=("cpu",),
                                       quantize=quantize, device="cpu")
        t1 = time.perf_counter()
        save_exported(path, programs, meta)
        t2 = time.perf_counter()
        load_exported(path, "cpu")
        t3 = time.perf_counter()
    nodes = {name: len(ep.graph.nodes) for name, ep in programs.items()}
    total = sum(nodes.values())
    return {"measure": "artifact", "quantize": quantize,
            "config": "deer_3b depths (24 / 6 / 12) at deer_tiny widths",
            "nodes": nodes, "export_s": t1 - t0, "save_s": t2 - t1,
            "load_s": t3 - t2, "ms_a_node": (t3 - t0) / total * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth-only", action="store_true",
                    help="only the artifact's host work (2)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" /
                                         "torch_export_cost.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as out:
        if not args.depth_only:
            emit(out, dispatch_cost(torch))
        artifact_cost(torch, None)  # the first export pays the imports
        for quantize in (None, "int4"):
            emit(out, artifact_cost(torch, quantize))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
