"""Where the PyTorch port's serving step spends its time on one GPU.

    python3 scripts/torch_step_profile.py [--quantize none,int8,...]

Serves deer_3b (the same seeded random weights as chip_smoke.py) in three
settings: B=1 exiting at the first exit, B=1 at full depth, and B=8 at full
depth, once for each serving mode given (``none`` is bf16; the others are
``ScanDeerPolicy``'s ``quantize`` modes; default ``none``) and each ToMe
setting given (``--tome_r 0,8``: 0 is the exact tower; default 0).  For each it
prints one JSON line with the host-clock step time (median and spread of 10
steps after 2 warm-up steps) and, from torch.profiler over 3 more steps,
the device time that kernels took, the device's idle share of the wall
time, the kernel launches per step, and the kernels that took the most
device time.  The last line names the card and its power limit.  The JSON
lines are also written to ``--out`` (default
``chiprun_out/torch_step_profile.jsonl``).  Needs a CUDA device.

``--kernels`` first times K1 (``flash_attention`` on the ViT's
(2B, 16, 257, 64) bf16 layer), K2 (``indexed_matmul``), K3
(``indexed_matmul_q8``) and K4 (``indexed_matmul_q4``) over one decoder
layer's four products, x (32B, K) bf16, at B=1 and B=8, beside their plain
versions and the library call (SDPA; ``x @ W[i]``, for K3 / K4 over the
stack dequantized to bf16 beforehand), with ``chip_smoke.py``'s timing
routines (``k1_times``, ``k2_times``) and inputs, and counts the
tensor-core instructions and type conversions in the SASS of K3 / K4.
``--calibrate`` also profiles the calibration path: one deer_3b
DebugBatcher batch (B=2, W=12, bf16) through ``generate_calibration_values``
in the folded and the streamed regime, the host-clock seconds a batch (5
batches after one warm-up) and the same profile over 2 more.
``--train`` also profiles the training step: deer_3b as ``chip_smoke.py``'s
phase train builds it (``cli/train``'s defaults, batch 6, W=12, bf16 with
fp32 masters), one DebugBatcher batch prepared and one update a step, in
the joint and the exit-only phase: the host-clock seconds a step (4 steps
after one warm-up), the peak device memory, and the same profile over 2
more.
``--root DIR`` profiles the port found under DIR (for example another
commit unpacked with ``git archive`` into an ignored directory) while the
inputs, weights and timing stay this checkout's, so two commits are
compared in one run on one card:

    python3 scripts/torch_step_profile.py --kernels --root build/parent \
        --out runs/profile_parent.jsonl
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "chiprun_out" / "torch_step_profile.jsonl"

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
    global OUT
    import argparse
    import subprocess

    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize", default="none",
                    help="comma-separated serving modes: none (bf16), "
                         "int8, int4, int8_w8a8, int4_w8a8")
    ap.add_argument("--tome_r", default="0",
                    help="comma-separated ToMe merges a ViT layer (0: the "
                         "exact tower)")
    ap.add_argument("--kernels", action="store_true",
                    help="time K1-K4 alone at the serving shapes first")
    ap.add_argument("--calibrate", action="store_true",
                    help="also profile a calibration batch, both regimes")
    ap.add_argument("--train", action="store_true",
                    help="also profile the deer_3b train step, both phases")
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose port to profile; default this one")
    ap.add_argument("--out", default=str(OUT), help="JSON lines file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    OUT = Path(args.out)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = load_chip_smoke()
    from deer_vla_tpu_torch.core.config import deer_3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deer_3b()
    params = smoke.build_weights(torch, cfg)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    emit({"root": str(root)})
    if args.kernels:
        kernel_times(torch, smoke)
    if args.calibrate:
        profile_calibration(torch, smoke, cfg, params)
    for mode in args.quantize.split(","):
        for r in args.tome_r.split(","):
            profile_mode(torch, np, smoke, cfg, params,
                         None if mode == "none" else mode, int(r))
            torch.cuda.empty_cache()
    if args.train:
        del params
        torch.cuda.empty_cache()
        profile_training(torch, smoke)
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


def load_chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path: its helpers import
    the port lazily, so they run whichever port ``--root`` put first on the
    path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(torch, smoke) -> None:
    """K1-K4 alone at the serving shapes, B=1 and B=8, beside their plain
    versions and the library call for the same function."""
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_reference)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in (1, 8):
        q, k, v = (torch.randn(2 * b, 16, 257, 64, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        emit({"kernel": "flash_attention", "streams": b,
              "shape": list(q.shape), **smoke.k1_times(torch, q, k, v, 0.125)})
        del q, k, v
    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    for b in (1, 8):
        out = {"kernel": "indexed_matmul", "streams": b, "m": 32 * b,
               "products": {}}
        for name, x, w in smoke.k2_cases(torch, b, torch.bfloat16):
            out["products"][name] = smoke.k2_times(
                torch, lambda i: indexed_matmul(x, w, i),
                lambda i: indexed_matmul_reference(x, w, i),
                lambda i: x @ w[i], idxs)
        for key in ("kernel_ms", "reference_ms", "library_ms"):
            out[key] = sum(p[key] for p in out["products"].values())
        emit(out)
    torch.cuda.empty_cache()
    quantized_kernel_times(torch, smoke, idxs)


def quantized_kernel_times(torch, smoke, idxs) -> None:
    """K3 and K4 over one decoder layer's four products at B=1 and B=8;
    the library call is ``x @ Wd[i]`` on the stack dequantized to bf16."""
    from deer_vla_tpu_torch.ops.kernels import build
    from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm
    from deer_vla_tpu_torch.ops.quant import (dequantize_weight,
                                              dequantize_weight4)
    for kernel, deq in (("indexed_matmul_q8", dequantize_weight),
                        ("indexed_matmul_q4", dequantize_weight4)):
        fn, plain = getattr(imm, kernel), getattr(imm, kernel + "_reference")
        gen = torch.Generator(device="cuda").manual_seed(100)
        stacks = []
        for prod, k, n in smoke.DECODER_PRODUCTS:
            w = smoke.stacked_weights(torch, gen, kernel, k, n)
            stacks.append((prod, k, w, deq(*w, torch.bfloat16)))
        for b in (1, 8):
            out = {"kernel": kernel, "streams": b, "m": 32 * b,
                   "products": {}}
            for prod, k, w, wd in stacks:
                x = torch.randn(32 * b, k, generator=gen,
                                device="cuda").to(torch.bfloat16)
                out["products"][prod] = smoke.k2_times(
                    torch, lambda i: fn(x, *w, i),
                    lambda i: plain(x, *w, i), lambda i: x @ wd[i], idxs)
            for key in ("kernel_ms", "reference_ms", "library_ms"):
                out[key] = sum(p[key] for p in out["products"].values())
            emit(out)
        del stacks
        torch.cuda.empty_cache()
    counts = smoke.sass_counts(build.build_library())
    emit({"sass": {name: c for name, c in counts.items()
                   if "indexed_matmul_quant" in name}})


def profile_calibration(torch, smoke, cfg, params) -> None:
    """Seconds a calibration batch and where its device time goes."""
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    cfg, batches = smoke.calib_debug_batches(cfg, 2, 1)
    for regime in ("folded", "streamed"):
        streamed = regime == "streamed"
        esp = (streamed_sample_probs(cfg, 1.0, None, "exp", "deer_3b")
               if streamed else None)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def run():  # ends with the values on the host
            generate_calibration_values(params, cfg, batches, gen=gen,
                                        streamed=streamed,
                                        exit_sample_probs=esp)

        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        times = times[1:]
        q = statistics.quantiles(times, n=4)
        out = {"setting": f"calibrate_{regime}", "batch_size": 2,
               "window": cfg.window_size, "batch_ms_median":
               statistics.median(times), "batch_ms_q1": q[0],
               "batch_ms_q3": q[2], "batches": len(times)}
        out.update(profile(torch, run, steps=2))
        emit(out)


def profile_training(torch, smoke) -> None:
    """Seconds a train step and where its device time goes, by phase."""
    from deer_vla_tpu_torch.cli.train import build_trainer
    from deer_vla_tpu_torch.train.trainer import prepare_batch
    from deer_vla_tpu_torch.train.train_step import init_train_state
    trainer, _ = build_trainer(smoke.TRAIN_ARGV)
    raws = list(trainer.loader)
    for phase in ("joint", "exit_only"):
        opt, step = trainer._phases[phase]
        state = init_train_state(trainer.params, opt)
        torch.cuda.reset_peak_memory_stats()
        count = itertools.count()

        def run():  # ends with the loss on the host
            nonlocal state
            raw = raws[next(count) % len(raws)]
            batch = prepare_batch(raw, trainer.cfg, trainer.gen,
                                  trainer.tcfg, trainer.device)
            state, metrics = step(state, batch, trainer.gen)
            float(metrics["loss"])

        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        times = times[1:]
        q = statistics.quantiles(times, n=4)
        out = {"setting": f"train_{phase}", "batch_size":
               trainer.tcfg.batch_size, "window": trainer.cfg.window_size,
               "step_ms_median": statistics.median(times),
               "step_ms_q1": q[0], "step_ms_q3": q[2], "steps": len(times),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        out.update(profile(torch, run, steps=2))
        emit(out)
        del state
    del trainer
    torch.cuda.empty_cache()


def profile_mode(torch, np, smoke, cfg, params, quantize, tome_r=0):
    import dataclasses

    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit,
                                                           tome_r=tome_r))
    pol = ScanDeerPolicy(params, cfg, indexed_mm=True, quantize=quantize)
    for name, b, th in SETTINGS:
        pol.set_thresholds_batch([[th] * len(pol.exits)] * b)
        pol.reset()
        inputs = [smoke.make_policy_inputs(np, cfg, b, seed=s)
                  for s in range(15)]
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
        out = {"setting": name, "quantize": quantize, "tome_r": tome_r,
               "streams": b,
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
