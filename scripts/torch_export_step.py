"""The serving artifact's step against the live engine's on one GPU, at a
model's full depth.

    python3 scripts/torch_export_step.py [--quantize none,int4] [--batch 1]

For each serving mode given (``none`` is bf16; default ``none``),
``--model`` (default mpt_dolly_3b: deer_3b with all 24 ViT and 12 decoder
layers, on ``chip_smoke.py``'s seeded weights with the cross-attention
gates drawn) is traced by ``serving/export.export_policy`` at ``--batch``
streams on the card, saved (``save_exported``) under a temporary directory
and loaded (``ExportedScanPolicy``, which also packs the checkpoint's
trees); then ``--rounds`` rounds of ``chip_smoke.py``'s ``served_pair``:
8 steps over its threshold sweep from a reset, the artifact's step and the
live ``ScanDeerPolicy(indexed_mm=True)``'s in turn on the same inputs,
exits identical and actions, carries and last hidden states bit-equal,
each side's host-clock ms and K1-K4 launches.  One JSON line a mode: the
trace, save and load seconds, the programs' nodes and bytes, both sides'
step medians (the first step of the first round, which runs the programs'
input check and the first calls, left out and given apart) and their
ratio, the exits taken.  The last line names the card and its power limit.
The lines are also written to ``--out`` (default
``chiprun_out/torch_export_step.jsonl``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "chiprun_out" / "torch_export_step.jsonl"


def load_chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path for its seeded
    weights, inputs and ``served_pair``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def measure(torch, np, smoke, cfg, params, quantize, batch: int,
            rounds: int) -> dict:
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.serving.export import (ExportedScanPolicy,
                                                   artifact_bytes,
                                                   export_policy,
                                                   save_exported)
    tmp = tempfile.mkdtemp(prefix="torch_export_step_", dir=OUT.parent)
    try:
        path = str(Path(tmp) / "step")
        t0 = time.perf_counter()
        programs, meta = export_policy(params, cfg, batch_size=batch,
                                       platforms=("gpu",), quantize=quantize)
        t1 = time.perf_counter()
        save_exported(path, programs, meta)
        t2 = time.perf_counter()
        nodes = {name: len(ep.graph.nodes) for name, ep in programs.items()}
        del programs
        aot = ExportedScanPolicy(path, params, cfg, quantize=quantize)
        t3 = time.perf_counter()
        nbytes = artifact_bytes(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    live = ScanDeerPolicy(params, cfg, indexed_mm=True, quantize=quantize)
    runs = [smoke.served_pair(torch, np, cfg, live, aot, batch, 800 + 10 * r)
            for r in range(rounds)]
    aot_ms = [ms for run in runs for ms in run["step_ms"]]
    live_ms = [ms for run in runs for ms in run["live_step_ms"]]
    out = {"quantize": quantize, "batch": batch,
           "vit_layers": cfg.vit.layers, "decoder_layers": cfg.mpt.n_layers,
           "exits": meta["exits"], "trace_seconds": t1 - t0,
           "save_seconds": t2 - t1, "load_seconds": t3 - t2,
           "program_nodes": nodes, "artifact_bytes": nbytes,
           "first_step_ms": aot_ms[0], "live_first_step_ms": live_ms[0],
           "step_ms": aot_ms[1:], "live_step_ms": live_ms[1:],
           "median_ms": statistics.median(aot_ms[1:]),
           "live_median_ms": statistics.median(live_ms[1:]),
           "exits_taken": sorted({e for run in runs
                                  for row in run["exit_layers"]
                                  for e in row}),
           "launches": runs[-1]["launches"],
           "live_launches": runs[-1]["live_launches"]}
    out["ratio"] = out["median_ms"] / out["live_median_ms"]
    del aot, live
    torch.cuda.empty_cache()
    return out


def main() -> int:
    global OUT
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize", default="none",
                    help="comma-separated serving modes: none (bf16), "
                         "int8, int4")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of 8 steps from a reset")
    ap.add_argument("--model", default="mpt_dolly_3b",
                    choices=["mpt_dolly_3b", "mpt_9b"])
    ap.add_argument("--out", default=str(OUT), help="JSON lines file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_export_step: no CUDA device", file=sys.stderr)
        return 1
    OUT = Path(args.out)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    sys.path.insert(0, str(REPO))
    smoke = load_chip_smoke()
    from deer_vla_tpu_torch.core.config import MODEL_REGISTRY
    cfg = MODEL_REGISTRY[args.model]()
    params = smoke.build_weights(torch, cfg)
    for mode in args.quantize.split(","):
        row = measure(torch, np, smoke, cfg, params,
                      None if mode == "none" else mode, args.batch,
                      args.rounds)
        emit(dict(row, model=args.model))
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
