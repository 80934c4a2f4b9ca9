"""Where the PyTorch port's serving step spends its time on one GPU.

    python3 scripts/torch_step_profile.py [--quantize none,int8,...]

Serves deer_3b (the same seeded random weights as chip_smoke.py) in three
settings: B=1 exiting at the first exit, B=1 at full depth, and B=8 at full
depth, once for each serving mode given (``none`` is bf16; the others are
``ScanDeerPolicy``'s ``quantize`` modes; default ``none``).  For each it
prints one JSON line with the host-clock step time (median and spread of 10
steps after 2 warm-up steps) and, from torch.profiler over 3 more steps,
the device time that kernels took, the device's idle share of the wall
time, the kernel launches per step, and the kernels that took the most
device time.  The last line names the card and its power limit.  The JSON
lines are also written to ``chiprun_out/torch_step_profile.jsonl``.  Needs
a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "chiprun_out" / "torch_step_profile.jsonl"
sys.path.insert(0, str(REPO))

SETTINGS = (("b1_first_exit", 1, 1e8), ("b1_full_depth", 1, -1.0),
            ("b8_full_depth", 8, -1.0))


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def profile(torch, run, steps: int) -> dict:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=device_us, reverse=True)[:10]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels) / steps,
            "top_kernels": [{"name": e.key[:80],
                             "ms_per_step": device_us(e) / 1e3 / steps,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def main() -> int:
    import argparse
    import subprocess

    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize", default="none",
                    help="comma-separated serving modes: none (bf16), "
                         "int8, int4, int8_w8a8, int4_w8a8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import build_weights
    from deer_vla_tpu_torch.core.config import deer_3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deer_3b()
    params = build_weights(torch, cfg)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    for mode in args.quantize.split(","):
        profile_mode(torch, np, cfg, params,
                     None if mode == "none" else mode)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


def profile_mode(torch, np, cfg, params, quantize):
    from chip_smoke import make_policy_inputs
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    pol = ScanDeerPolicy(params, cfg, indexed_mm=True, quantize=quantize)
    for name, b, th in SETTINGS:
        pol.set_thresholds_batch([[th] * len(pol.exits)] * b)
        pol.reset()
        inputs = [make_policy_inputs(np, cfg, b, seed=s) for s in range(15)]
        it = iter(inputs)
        exits = []

        def run():
            _, ex = pol.step_batch(*next(it))
            exits.append(int(ex.max()))

        times = []
        for s in range(12):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        times = times[2:]
        q = statistics.quantiles(times, n=4)
        out = {"setting": name, "quantize": quantize, "streams": b,
               "exit_layer": exits[-1],
               "step_ms_median": statistics.median(times),
               "step_ms_q1": q[0], "step_ms_q3": q[2], "steps": len(times)}
        out.update(profile(torch, run, steps=3))
        emit(out)


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
