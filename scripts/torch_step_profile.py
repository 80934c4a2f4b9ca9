"""Where the PyTorch port's serving step spends its time on one GPU.

    python3 scripts/torch_step_profile.py

Serves deer_3b (the same seeded random weights as chip_smoke.py) in three
settings: B=1 exiting at the first exit, B=1 at full depth, and B=8 at full
depth.  For each it prints one JSON line with the host-clock step time
(median and spread of 10 steps after 2 warm-up steps) and, from
torch.profiler over 3 more steps, the device time that kernels took, the
device's idle share of the wall time, the kernel launches per step, and the
kernels that took the most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
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
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import build_weights, make_policy_inputs
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deer_3b()
    pol = ScanDeerPolicy(build_weights(torch, cfg), cfg, indexed_mm=True)
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
        out = {"setting": name, "streams": b, "exit_layer": exits[-1],
               "step_ms_median": statistics.median(times),
               "step_ms_q1": q[0], "step_ms_q3": q[2], "steps": len(times)}
        out.update(profile(torch, run, steps=3))
        print(json.dumps(out), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
