"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deer_vla_tpu_torch/csrc/`` and counts
the tensor-core instructions (HMMA / HGMMA) in the SASS of the bf16 K1-K4
kernels, and K3 / K4's type conversions, holds each kernel against its
plain PyTorch version at the shapes the serving step gives it (K1 flash
attention, also on the ViT's strided views of a fused qkv and at ragged and
other head-dim shapes; K2 / K3 / K4 the bf16 / int8 / int4 layer-indexed
matmuls, each also for bit-identical repeat launches, under CUDA-graph
replay with a changing device-side layer index, and in each of its three
block configs at 32-256 rows, timed side by side), then serves ``deer_3b``
at full width (24-layer ViT-L/14, 6-layer
perceiver, 12-layer d_model-2048 MPT) from seeded random weights: 8
single-stream steps and 4 eight-stream batched steps with per-stream
dynamic exits, in bf16 and quantized to int8 and int4 (the decoder through
K3 / K4), and 4 eight-stream steps in each w8a8 mode.  Last, one full-depth
step is compared with the same weights run in fp32 on the CPU through the
plain versions, unquantized and (after checking that the card and the CPU
quantize to the same bits) in int8 and int4.  Then the evaluation path:
deer_3b calibration (2 debug batches of 2 trajectories, W=12: 48 ViT
images through K1 a batch) in both regimes, its fp32 forward and deltas on
the card against the CPU at W=2, and ``cli/eval`` run in-process
(calibrate, then DebugEnv rollouts of 2 sequences: bf16 sequential and over
2 lanes, int8 and int4 sequential) with K1-K4 counted.  Then training:
one fp32 deer_3b train step (B=1, W=2) on the card against the CPU, the
guard that refuses a ViT gradient on the card (``--unfreeze_vit``: K1 has
no backward), ``cli/train --debug`` in-process (deer_3b, batch 6, W=12: 1
joint and 1 exit-only epoch of 4 steps, 144 ViT images a step through K1,
K2-K4 not launched; frozen leaves bit-unchanged, trained leaves moved) and
``cli/eval --evaluate_from_checkpoint`` on its checkpoint.  Then the CALVIN
phases on a CALVIN-format tree written at CALVIN's frame sizes (200 px
static, 84 px gripper; half the episodes DEFLATE-compressed): the native
npz reader against ``np.load`` bit for bit and both timed, with the
loader's batches a second (``calvin_data``); ``cli/train --calvin_dataset``
at JAX's defaults (B=6, W=12, rgb_pad 10, gripper_pad 4), 1 joint and 1
exit-only epoch of 4 batches, one checkpoint (``train_calvin``); ``--dif_ws``
at W=24 (288 ViT images a step) without remat, with ``--remat`` and with
``--remat_policy dots``, losses against each other and peak memory
(``train_calvin_difws``); ``cli/eval --calvin_dataset`` on that checkpoint,
which calibrates on the validation split, writes the values sidecar and
ends with the dropped-env SystemExit, then ``cli/eval --debug`` serving
those values (``calib_calvin``).  The serving variants run between the
serve cross-checks and calibration: the host-bucketed ``DeerPolicy`` (8 B=1
steps, each held against ``ScanDeerPolicy`` with the same products from the
same carry: equal exits), the vision caches on both engines and the action
cache (hits counted, every step equal to the uncached step),
``BatchedDeerPolicy`` at B=8 against ``ScanDeerPolicy.step_batch``, and
ToMe (r = 8) at B=1 / B=8 plus a full-depth step against fp32 on the CPU
with the merges compared layer by layer; the rollouts add one ``cli/eval``
run per serving option (``ROLLOUT_RUNS``; the pipelined lanes' report must
equal ``--lanes 4``'s) and ``--layerwise_exit_eval`` on the trained
checkpoint.  K1 is checked at the ViT batch of every driven path
(``vit_batches``), at the ToMe lengths with their bias too, and every shape
the models hand K1 while the paths run is recorded and must be one of those
checked.  The vision, state and window variants run on the same deer_3b draw
with their own leaves (``variant_weights``): ``serve_variants`` (use_state,
pre, two_way, sep_resampler, gripper_res 84 and multi_step_action 3 at B=1 /
B=8 beside the post medians; use_state also in int8 through K3 and through
``DeerPolicy`` against the scan engine), ``cross_check_variants``
(vit_concat + use_state and gripper_res 84, a full-depth bf16 step against
fp32 on the CPU), ``serve_folded`` (vit_concat and use_hist at W=12: the
frame cache against the uncached step, equal exits and arm actions within
2e-4, then B=8), ``calibrate_variants`` (state in both regimes, vit_concat
with ``--calib_warm 2``) and ``train_variants`` (``cli/train --use_state
--fusion_mode vit_concat``, one joint epoch of 4 batches, then ``cli/eval
--frame_cache`` on its checkpoint, in ``build/chip_smoke_variants/``,
deleted after).  The head families (ROADMAP M10b) run on the same draw with
heads of their own (``head_weights``): ``serve_heads`` (gpt, fc under
vit_concat and diffusion at B=1 / B=8 over a six-decade threshold sweep;
gpt also through ``DeerPolicy`` against the scan engine; the diffusion
model's feature step, its DDIM and DDPM plans timed with their CUDA launches
profiled, and ``DiffusionSamplerPolicy`` plans), ``cross_check_heads`` (gpt
and fc a full-depth bf16 step against fp32 on the CPU; the U-Net and a DDIM
plan on the card against the CPU with the same noise), ``calibrate_heads``
(gpt and diffusion in both regimes, the realized mix on the samples against
its target), three ``cli/eval`` rollouts (``--head_type gpt``, ``diffusion
--diff_steps 10``, the same over 2 lanes) and ``train_heads`` (``cli/train
--head_type diffusion`` and ``gpt``, one joint epoch of 4 batches, then
``cli/eval`` on each checkpoint, in ``build/chip_smoke_heads/``, deleted
after).  Then deer_9b (MPT-7B, d_model 4096, x-attn every 4 layers) at its
preset depth of 12 layers: K2 / K3 / K4 at its four products (K = 4096 /
16384, N up to 16384) first, each layer against the plain version, timed
against the bound and cuBLAS, bit-identical across launches and graph
replays, every block config (``kernels_9b``); then served in every mode
(8 B=1 and 4 B=8 steps), ``DeerPolicy`` against the scan engine, a
full-depth step against fp32 on the CPU, K3 / K4 against their plain
products in fp32, calibration and ``cli/eval --debug --model mpt_9b``.
Then bc_llama (the llama decoder, d_model 4096, 32 layers) in bf16 and
int8 (K2-K4 never launch: they compute the MPT block's products), a
bf16 step against fp32 on the card, and ``cli/eval --debug --model
llama_9b``.  Every K2-K4 shape the driven paths launch must be one a
phase checked (``k2_shapes``).  A line before the kernels line gives the
script's total seconds.

Every phase prints one JSON line; any failed check raises and the script
exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the port's package beside this file, it
exits non-zero and prints no result.  Compiler logs go to
``chiprun_out/chip_smoke/``; the training run's checkpoints go to
``build/chip_smoke_train/`` and the CALVIN tree and its run to
``build/chip_smoke_calvin/``; both are deleted at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out" / "chip_smoke"
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# K1 tolerances: fp32 sums in another order than the plain version; in bf16
# P is rounded against the running (not the final) row max and the output
# is rounded to bf16, about 2^-8 relative, on outputs of unit scale.
K1_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K2 tolerances, relative to max|y|: both sides round an fp32 sum to the
# output dtype, in different summation orders (bf16: two ulps).
K2_REL_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}

# the bf16 kernels redesigned for the tensor cores, by SASS function name:
# a function belongs to a kernel if its mangled name holds every word of
# one of the kernel's entries
TENSOR_CORE_KERNELS = {
    "flash_attention": (("flash_attention_bf16",),),
    "indexed_matmul": (("indexed_matmul_bf16",), ("indexed_matmul_wgmma",)),
    "indexed_matmul_q8": (("indexed_matmul_quant_mma", "Int8Codes"),
                          ("indexed_matmul_quant_wgmma", "Int8Codes")),
    "indexed_matmul_q4": (("indexed_matmul_quant_mma", "Int4Codes"),
                          ("indexed_matmul_quant_wgmma", "Int4Codes"))}
# SASS type conversions (integer <-> float, float <-> float)
CONVERSION = re.compile(r"\b(?:I2F|I2FP|F2F|F2FP|F2I|I2I)\b")

# The step at deer_3b: full depth on the card in bf16 against fp32 on the
# CPU.  bf16 keeps 8 bits of mantissa through 24 + 12 residual layers.
CROSS_TOL_BF16 = {"arm_max_abs": 5e-2, "hidden_rel_l2": 5e-2}
# The same step with fp32 compute on the card (both kernels' fp32 paths):
# only the summation order differs.
CROSS_TOL_FP32 = {"arm_max_abs": 1e-3, "hidden_rel_l2": 1e-3}

# ToMe: patch tokens merged a ViT layer in the ToMe phases (--vit_tome_r)
TOME_R = 8
# the cli/eval rollout phases: (phase, flags after ROLLOUT_ARGV)
ROLLOUT_RUNS = (
    ("rollout", []), ("rollout_lanes2", ["--lanes", "2"]),
    ("rollout_int8", ["--quantize", "int8"]),
    ("rollout_int4", ["--quantize", "int4"]),
    ("rollout_bucketed", ["--engine", "bucketed"]),
    ("rollout_exit_id5", ["--exit_id", "5"]),
    ("rollout_bucketed_ensemble", ["--engine", "bucketed",
                                   "--use_action_ensemble"]),
    ("rollout_bucketed_multi_execution2", ["--engine", "bucketed",
                                           "--multi_execution", "2"]),
    ("rollout_tome8", ["--vit_tome_r", str(TOME_R)]),
    ("rollout_vision_cache_scan", ["--vision_cache_tau", "0.05"]),
    ("rollout_vision_cache_bucketed", ["--engine", "bucketed",
                                       "--vision_cache_tau", "0.05"]),
    ("rollout_action_cache", ["--action_cache_tau", "0.03"]),
    ("rollout_bucketed_int8", ["--engine", "bucketed", "--quantize",
                               "int8"]),
    ("rollout_lanes4", ["--lanes", "4"]),
    ("rollout_lanes4_pipeline2", ["--lanes", "4", "--pipeline", "2",
                                  "--env_workers", "2"]))
# the rollout report entries that --pipeline / --env_workers must not move
PIPELINE_SAME = ("avg_seq_len", "chain_sr", "success_exit_hist",
                 "fail_exit_hist", "avg_exit_layer", "task_info")
# the thresholds the serve phases sweep, one a step (a stream at B=8), over
# three decades: with these random heads the exit deltas lie around 1e-5
# (the first full run), so the dynamic exit has room to pick different
# layers
SWEEP = [10.0 ** (-6 + 3 * s / 7) for s in range(8)]
# DeerPolicy against ScanDeerPolicy with the same bf16 products (cuBLAS, no
# K2) on the same weights, inputs, thresholds and carry: the same layers in
# the same order, so the exits must be equal; the actions (tanh outputs in
# [-1, 1]) are held to 1e-2, a few bf16 ulps of a unit value
BUCKETED_TOL = {"arm_max_abs": 1e-2}
# the ToMe step at full depth against fp32 on the CPU: on the card in fp32
# only the summation order differs (CROSS_TOL_FP32, and every merge must
# agree).  In bf16 pairs whose similarities lie within bf16 rounding of each
# other merge otherwise than in fp32 (from the second merging layer on, in
# the first run on an H100), which moves whole tokens of the perceiver's
# input, and after the first such layer the token order differs too; the
# actions are held to the exact step's tolerance, the hidden state and the
# merges are reported
TOME_TOL_BF16 = {"arm_max_abs": 5e-2}
# the window of the fp32 calibration cross-check (one trajectory)
CALIB_CROSS_WINDOW = 2
# the training phases: cli/train's default batch (trajectories of W=12),
# 1 joint and 1 exit-only epoch of the DebugBatcher's 4 batches; a warmup
# of 1 step (2500 would keep every update below fp32 resolution)
TRAIN_BATCH = 6
TRAIN_DIR = REPO / "build" / "chip_smoke_train"
TRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--batch_size_calvin",
              str(TRAIN_BATCH), "--num_joint_epochs", "1",
              "--num_exit_epochs", "1", "--joint_warmup_steps", "1",
              "--exit_warmup_steps", "1", "--logging_steps", "1",
              "--from_scratch", "--run_name", str(TRAIN_DIR)]
TRAIN_STEPS = 8
VIT_LAYERS = 24
# the fp32 train step, card against CPU (B=1, W=2, the window of
# CALIB_CROSS_WINDOW): the loss and the gradients differ only by summation
# order; Adam divides a gradient by its own size, so an updated param is
# held to 1e-5 of its norm plus the gradient's tolerance times the norm of
# its update (a zero-initialized bias is all update after one step)
TRAIN_TOL_FP32 = {"loss_rel": 1e-5, "grad_rel_l2": 1e-3,
                  "param_rel_l2": 1e-5}
# the CALVIN phases: a CALVIN-format tree at CALVIN's frame sizes (200 px
# static, 84 px gripper, CALVIN's keys), every other episode written with
# savez_compressed; training/ 6 x 64 frames (about 55 MB), validation/
# 2 x 40
CALVIN_DIR = REPO / "build" / "chip_smoke_calvin"
CALVIN_RUN = CALVIN_DIR / "run"
CALVIN_SPLITS = {"training": (6, 64), "validation": (2, 40)}
CALVIN_KEYS = ("rgb_static", "rgb_gripper", "rel_actions", "robot_obs",
               "scene_obs")
# cli/train on it at JAX's defaults (B=6, W=12, rgb_pad 10, gripper_pad 4);
# --data_percent 0.08 keeps 24 of the 312 windows: 4 batches an epoch
CALVIN_TRAIN_ARGV = ["--model", "mpt_dolly_3b", "--calvin_dataset",
                     str(CALVIN_DIR), "--batch_size_calvin", str(TRAIN_BATCH),
                     "--num_joint_epochs", "1", "--num_exit_epochs", "1",
                     "--joint_warmup_steps", "1", "--exit_warmup_steps", "1",
                     "--logging_steps", "1", "--data_percent", "0.08",
                     "--from_scratch", "--run_name", str(CALVIN_RUN)]
# --dif_ws at W=24: 1 joint epoch of 5 batches (31 of 312 windows), one
# loader thread so the window draws come in the same order in every run
DIFWS_ARGV = ["--model", "mpt_dolly_3b", "--calvin_dataset", str(CALVIN_DIR),
              "--batch_size_calvin", str(TRAIN_BATCH), "--dif_ws",
              "--window_size", "24", "--max_window_size", "24",
              "--num_joint_epochs", "1", "--num_exit_epochs", "0",
              "--joint_warmup_steps", "1", "--logging_steps", "1",
              "--data_percent", "0.1", "--workers", "1", "--from_scratch",
              "--run_name", str(CALVIN_DIR / "run_difws")]
DIFWS_STEPS = 5
DIFWS_RUNS = (("none", []), ("full", ["--remat"]),
              ("dots", ["--remat", "--remat_policy", "dots"]))
# the same seeds, batches and draws with and without remat: the forward is
# the same computation, the gradients differ by the order of atomic sums,
# so a loss after an update moves by bf16 noise; held to 1e-2 relative
# (2.56 bf16 ulps)
DIFWS_LOSS_REL = 1e-2


def released_gb(torch) -> float:
    """Frees what earlier phases left to the garbage collector (an
    exception's traceback cycle can hold a step's tensors) and returns the
    device memory still allocated, in GB."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Time of one call from CUDA events around ``iters`` eager calls: the
    device time, or the host's time to issue a call where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured once in a CUDA
    graph (after two warm-up calls on a side stream) and replayed
    ``replays`` times between CUDA events, so the host's cost of issuing
    each call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: int, flops: int, dtype: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})
    return smi


def sass_counts(lib_path, out_dir=None) -> dict:
    """Per kernel function in the library's SASS (``cuobjdump -sass``, next
    to nvcc): its HMMA / HGMMA instructions and its type conversions."""
    from deer_vla_tpu_torch.ops.kernels import build
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    if out_dir is not None:
        (out_dir / "kernels.sass").write_text(sass)
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts.setdefault(current, {"tensor_core": 0, "conversions": 0})
        elif current is not None:
            if "HMMA" in line or "HGMMA" in line:
                counts[current]["tensor_core"] += 1
            if CONVERSION.search(line):
                counts[current]["conversions"] += 1
    return counts


def kernel_sass(counts: dict, entries) -> dict:
    """The functions of one kernel (``TENSOR_CORE_KERNELS`` entries) and
    their summed counts."""
    per_fn = {name: c for name, c in counts.items()
              if any(all(word in name for word in e) for e in entries)}
    return {"instances": len(per_fn),
            "hmma_hgmma": sum(c["tensor_core"] for c in per_fn.values()),
            "conversions": sum(c["conversions"] for c in per_fn.values()),
            "per_instance": per_fn}


def phase_build() -> dict:
    from deer_vla_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(info["log"])
    usage = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln]
    counts = sass_counts(build.build_library(), OUT_DIR)
    tc = {}
    for kernel, entries in TENSOR_CORE_KERNELS.items():
        tc[kernel] = kernel_sass(counts, entries)
        per_fn = tc[kernel]["per_instance"]
        check(bool(per_fn) and all(c["tensor_core"] for c in per_fn.values()),
              f"{kernel}: no tensor-core instructions in {per_fn}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "ptxas": usage,
          "tensor_core_sass": tc})
    return tc


def k1_times(torch, q, k, v, scale) -> dict:
    """K1 without bias, its plain version and SDPA on the same q, k, v:
    device time of one call from CUDA-graph replays, and K1's eager time."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    F = torch.nn.functional
    return {"kernel_ms": graph_ms(
                torch, lambda: flash_attention(q, k, v, None, scale), 48),
            "kernel_eager_ms": time_ms(
                torch, lambda: flash_attention(q, k, v, None, scale), 48),
            "reference_ms": graph_ms(
                torch, lambda: flash_attention_reference(q, k, v, None,
                                                         scale), 12),
            "library_ms": graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 48)}


def k1_cases(torch):
    """(name, q, k, v, bias, scale) at the shapes the port gives K1."""
    from deer_vla_tpu_torch.ops.alibi import full_attn_bias
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for streams in (1, 8):
        for dt in (torch.bfloat16, torch.float32):
            shape = (2 * streams, 16, 257, 64)  # both cameras, one batch
            cases.append((f"vit_b{streams}_{str(dt)[6:]}", rand(*shape, dtype=dt),
                          rand(*shape, dtype=dt), rand(*shape, dtype=dt), None,
                          0.125))
    mask = torch.ones(2, 32, dtype=torch.int64, device="cuda")
    mask[1, 24:] = 0
    alibi = full_attn_bias(mask, 16, 32, 8.0, torch.bfloat16)
    bf = torch.bfloat16
    cases.append(("alibi_causal_b2h16_s32", rand(2, 16, 32, 128, dtype=bf),
                  rand(2, 16, 32, 128, dtype=bf),
                  rand(2, 16, 32, 128, dtype=bf), alibi, 128 ** -0.5))
    # cross-attention layout: (B, 1, 32, 128) bias broadcast over heads;
    # text rows before the media token are -1e9 everywhere
    xbias = torch.zeros(2, 1, 32, 128, device="cuda")
    xbias[:, :, :, 64:] = -1e9
    xbias[:, :, :3, :] = -1e9
    for dt in (torch.bfloat16, torch.float32):
        cases.append((f"xattn_bcast_masked_rows_{str(dt)[6:]}",
                      rand(2, 8, 32, 64, dtype=dt),
                      rand(2, 8, 128, 64, dtype=dt),
                      rand(2, 8, 128, 64, dtype=dt), xbias, 0.125))
    # ragged q and k tiles with a bias broadcast over heads; head dims the
    # bf16 kernel zero-pads (16: deer_tiny, and 48 to 64; 96 to 128)
    rbias = rand(3, 1, 100, 79, dtype=torch.float32) * 2
    cases.append(("ragged_sq100_sk79_bcast_bias_bfloat16",
                  rand(3, 4, 100, 64, dtype=bf), rand(3, 4, 79, 64, dtype=bf),
                  rand(3, 4, 79, 64, dtype=bf), rbias, 0.125))
    for d, sq in ((16, 130), (48, 70), (96, 129)):
        cases.append((f"d{d}_s{sq}_bfloat16", rand(2, 2, sq, d, dtype=bf),
                      rand(2, 2, sq, d, dtype=bf), rand(2, 2, sq, d, dtype=bf),
                      None, d ** -0.5))
    return cases


def rollout_streams() -> set:
    """The streams a dispatch of each cli/eval rollout phase hands the ViT:
    1 sequentially, the lanes over the pipeline's groups with --lanes."""
    from deer_vla_tpu_torch.cli import eval as cli
    out = set()
    for _, flags in ROLLOUT_RUNS + HEAD_ROLLOUTS:
        args = cli.build_parser().parse_args(ROLLOUT_ARGV + flags)
        groups = max(1, min(args.pipeline, args.lanes))
        while args.lanes % groups:
            groups -= 1
        out.add(max(args.lanes, 1) // groups)
    return out


def vit_batches(cfg) -> dict:
    """The ViT batches, in streams (a stream is both cameras' frames), that
    the paths this script drives hand K1, by compute dtype: the serve
    phases' B=1 and B=8, each rollout's dispatch, a calibration batch's B*W
    frames (phase calibrate and ``cli/eval``), a training batch's B*W
    frames, the window-folded variants' W frames at B=1 and B=8; in fp32
    the serve cross-checks' B=1, the calibration and training
    cross-checks' W frames and the folded cross-check's W frames.
    ``images`` holds the one-camera passes, in images.  ``tome`` holds the batches the ToMe
    tower runs at: phase serve_tome's B=1 and B=8 and its fp32 cross-check,
    and the ToMe rollout's calibration and serving."""
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE
    calib = CALIB_BATCH_SIZE * cfg.window_size
    train = TRAIN_BATCH * cfg.window_size  # also a CALVIN calibration batch
    difws = TRAIN_BATCH * int(DIFWS_ARGV[DIFWS_ARGV.index("--window_size")
                                         + 1])
    # the window-folded variants' uncached steps: W frames a stream
    folded = cfg.window_size
    return {"bfloat16": sorted({1, 8, calib, train, difws, folded,
                                8 * folded, *rollout_streams()}),
            "float32": sorted({1, CALIB_CROSS_WINDOW, folded}),
            "calib": calib, "train": train, "difws": difws,
            "folded": folded,
            # one-camera passes (two_way, sep_resampler, the static camera
            # beside a native-size gripper) at B=1 and B=8, in images
            "images": {"bfloat16": [1, 8], "float32": [1]},
            "tome": {"bfloat16": [1, 8, calib], "float32": [1]}}


def k1_key(q, k, bias) -> tuple:
    """What tells two K1 calls apart for its checks: q's shape, the key
    length, the dtype, whether q is a strided view, the bias shape."""
    return (tuple(q.shape), k.shape[2], str(q.dtype)[6:], q.is_contiguous(),
            None if bias is None else tuple(bias.shape))


@contextlib.contextmanager
def k1_calls(seen: set):
    """While open, adds the ``k1_key`` of every K1 call the models make on
    the card (they reach K1 through ``ops.attention``) to ``seen``."""
    from deer_vla_tpu_torch.ops import attention
    kernel = attention.flash_attention

    def logged(q, k, v, bias=None, scale=None):
        if q.is_cuda:
            seen.add(k1_key(q, k, bias))
        return kernel(q, k, v, bias=bias, scale=scale)

    attention.flash_attention = logged
    try:
        yield seen
    finally:
        attention.flash_attention = kernel


@contextlib.contextmanager
def k2_calls(seen: set):
    """While open, adds (kernel, m, k, n, x dtype) of every K2 / K3 / K4
    call the models make on the card (the stacked MPT block reaches them
    through ``models.mpt``) to ``seen``."""
    from deer_vla_tpu_torch.models import mpt
    names = ("indexed_matmul", "indexed_matmul_q8", "indexed_matmul_q4")
    kernels = {name: getattr(mpt, name) for name in names}

    def logged(name):
        def call(x, *stack, **kw):
            if x.is_cuda:
                seen.add((name, x.numel() // x.shape[-1], x.shape[-1],
                          stack[0].shape[-1], str(x.dtype)[6:]))
            return kernels[name](x, *stack, **kw)
        return call

    for name in names:
        setattr(mpt, name, logged(name))
    try:
        yield seen
    finally:
        for name, fn in kernels.items():
            setattr(mpt, name, fn)


def vit_strided_qkv(torch, streams: int, dt, images: int = None):
    """q, k, v as the ViT hands them to K1: ``split_heads`` views of one
    fused (2B, 257, 3 * 1024) qkv projection, no copy; ``images`` instead
    of 2B for a one-camera pass."""
    from deer_vla_tpu_torch.ops.attention import split_heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * streams)
    qkv = torch.randn(images or 2 * streams, 257, 3 * 1024, generator=gen,
                      device="cuda").to(dt)
    q, k, v = (split_heads(t, 16) for t in qkv.chunk(3, dim=-1))
    check(not q.is_contiguous() and q.data_ptr() == qkv.data_ptr(),
          "split_heads did not give a view")
    return q, k, v


def tome_k1_cases(torch, streams: int, dt) -> list:
    """(name, q, k, v, bias, scale) as the ToMe tower at r = TOME_R hands
    them to K1: at layer i >= 1 Sq = Sk = 257 - TOME_R * i, for every i
    whose Sq reaches ``ops.attention.KERNEL_MIN_SQ`` (layer 0 runs before
    any merge, at the exact tower's shape and without a bias);
    ``split_heads`` views of one fused qkv and the (2B, 1, Sq, Sq)
    log-size bias, an expand of one row per image (random merged sizes)."""
    from deer_vla_tpu_torch.ops.attention import KERNEL_MIN_SQ, split_heads
    from deer_vla_tpu_torch.ops.tome import (proportional_attn_bias,
                                             tome_schedule)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11 * streams)
    cases, n = [], 256
    for i, r in enumerate(tome_schedule(n, VIT_LAYERS, TOME_R)):
        sq = n + 1
        if sq < KERNEL_MIN_SQ:
            break
        if i > 0:
            qkv = torch.randn(2 * streams, sq, 3 * 1024, generator=gen,
                              device="cuda").to(dt)
            q, k, v = (split_heads(t, 16) for t in qkv.chunk(3, dim=-1))
            sizes = torch.randint(1, 9, (2 * streams, sq), generator=gen,
                                  device="cuda").float()
            sizes[:, 0] = 1.0  # CLS
            cases.append((f"tome_l{i}_sq{sq}_b{streams}_{str(dt)[6:]}", q,
                          k, v, proportional_attn_bias(sizes, sq), 0.125))
        n -= r
    return cases


def k1_bias_times(torch, q, k, v, bias, scale) -> dict:
    """``k1_times`` with a bias: K1 and its plain version on the expanded
    bias as the ViT gives it, SDPA on the bias cast to q's dtype (its float
    masks take that dtype only)."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    F = torch.nn.functional
    mask = bias.to(q.dtype)
    return {"kernel_ms": graph_ms(
                torch, lambda: flash_attention(q, k, v, bias, scale), 48),
            "kernel_eager_ms": time_ms(
                torch, lambda: flash_attention(q, k, v, bias, scale), 48),
            "reference_ms": graph_ms(
                torch, lambda: flash_attention_reference(q, k, v, bias,
                                                         scale), 12),
            "library_ms": graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), 48)}


# a decoder layer's four stacked products (name, K, N), by model: the MPT
# block's fused wqkv, out_proj, mlp_up and mlp_down (12 layers each)
DECODER_PRODUCTS = {
    "deer_3b": (("wqkv", 2048, 6144), ("out_proj", 2048, 2048),
                ("mlp_up", 2048, 8192), ("mlp_down", 8192, 2048)),
    "deer_9b": (("wqkv", 4096, 12288), ("out_proj", 4096, 4096),
                ("mlp_up", 4096, 16384), ("mlp_down", 16384, 4096))}
# (streams, x dtype) of the indexed-matmul cases, by model: M = 32 text rows
# a stream (a text row a frame under use_hist).  deer_9b: the serve phase's B=1 and B=8, and B=1 in fp32 (the
# cross-checks' fp32 steps)
INDEXED_CASES = {
    "deer_3b": ((1, "bfloat16"), (2, "bfloat16"), (4, "bfloat16"),
                (8, "bfloat16"), (32, "bfloat16"), (1, "float32"),
                # use_hist's W=12 text rows a stream at B=1 and B=8
                (12, "bfloat16"), (96, "bfloat16")),
    "deer_9b": ((1, "bfloat16"), (8, "bfloat16"), (1, "float32"))}

# row counts at which each of K2's block configs is checked and timed: 1-4
# and 8 streams (96 rows fill a 128-row block partly)
K2_CONFIG_ROWS = (32, 64, 96, 128, 256)


def k2_cases(torch, streams: int, dt, model: str = "deer_3b"):
    """(name, x, w) for the decoder's four stacked products."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + streams)
    out = []
    for name, k, n in DECODER_PRODUCTS[model]:
        x = torch.randn(32 * streams, k, generator=gen, device="cuda").to(dt)
        w = (torch.randn(12, k, n, generator=gen, device="cuda")
             * k ** -0.5).to(dt)
        out.append((f"{name}_b{streams}_{str(dt)[6:]}", x, w))
    return out


def k2_times(torch, run, plain, library, idxs) -> dict:
    """A layer-indexed product timed cycling through the 12 layers, so each
    call reads a slice the previous call did not, as the decoder loop does
    (a stack of 12 exceeds the 50 MB L2): the kernel, its plain version and
    the library call, device time of one call from CUDA-graph replays, and
    the kernel's eager time.  ``run`` takes the 0-dim int32 layer tensor,
    ``plain`` and ``library`` the layer as an int (a tensor index would sync
    the host each call)."""
    it = iter(range(10 ** 9))
    return {"kernel_ms": graph_ms(torch, lambda: run(idxs[next(it) % 12]), 48),
            "kernel_eager_ms": time_ms(
                torch, lambda: run(idxs[next(it) % 12]), 48),
            "reference_ms": graph_ms(torch, lambda: plain(next(it) % 12), 24),
            "library_ms": graph_ms(torch, lambda: library(next(it) % 12),
                                   48)}


def indexed_case(torch, kernel: str, name: str, x, n: int, nbytes: int,
                 run, plain, library, idxs, checked: set) -> dict:
    """One layer-indexed product: every one of the 12 layers checked
    against the plain version (tolerance relative to max|y|), then timed
    by ``k2_times``; its (kernel, m, k, n, x dtype) joins ``checked``."""
    dts = str(x.dtype)[6:]
    err = 0.0
    scale = 0.0
    for i in range(12):
        got = run(idxs[i])
        ref = plain(idxs[i])
        err = max(err, (got.float() - ref.float()).abs().max().item())
        scale = max(scale, ref.float().abs().max().item())
    tol = K2_REL_TOL[dts] * scale
    check(err <= tol, f"{kernel} {name}: max abs err {err} > {tol}")
    m, kk = x.shape
    checked.add((kernel, m, kk, n, dts))
    row = {"kernel": kernel, "case": name, "m": m, "k": kk, "n": n,
           "layers": 12, "max_abs_err": err, "tolerance": tol}
    row.update(bound(nbytes, 2 * m * kk * n, dts))
    row.update(k2_times(torch, run, plain, library, idxs))
    return row


def layer_summary(rows: list, m: int = 32) -> dict:
    """One decoder layer of the model ``rows`` hold (``DECODER_PRODUCTS``)
    in bf16 at ``m`` rows (32 a stream): the four products' times, bytes
    and operations summed, and their bound."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0, "flops": 0, "max_abs_err": 0.0}
    for row in rows:
        if row["m"] == m and row["case"].endswith("bfloat16"):
            for key, src in (("ms", "kernel_ms"),
                             ("plain_ms", "reference_ms"),
                             ("library_ms", "library_ms"),
                             ("bytes", "bytes"), ("flops", "flops")):
                out[key] += row[src]
            out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    out.update(bound(out["bytes"], out["flops"], "bfloat16"))
    return out


def phase_kernels(torch, vit: dict) -> dict:
    """K1-K4 against their plain versions and timed; ``vit`` is
    ``vit_batches``.  The summary's ``k1_checked`` holds the ``k1_key`` of
    every K1 case checked, its ``k2_checked`` the (kernel, m, k, n, x
    dtype) of every K2-K4 case."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = []
    summary = {}

    from deer_vla_tpu_torch.ops.attention import merge_heads
    from deer_vla_tpu_torch.ops.kernels.flash_attention import TC_HEAD_DIMS
    cases = k1_cases(torch)
    for dts in ("bfloat16", "float32"):
        for streams in vit[dts]:
            q, k, v = vit_strided_qkv(torch, streams, getattr(torch, dts))
            cases.append((f"vit_strided_b{streams}_{dts}", q, k, v, None,
                          0.125))
        for images in vit["images"][dts]:
            q, k, v = vit_strided_qkv(torch, 0, getattr(torch, dts), images)
            cases.append((f"vit_strided_i{images}_{dts}", q, k, v, None,
                          0.125))
    for dts, batches in vit["tome"].items():
        for streams in batches:
            cases += tome_k1_cases(torch, streams, getattr(torch, dts))
    summary["k1_checked"] = set()
    summary["flash_attention_tome"] = []
    summary["flash_attention_tome_calib"] = []
    for name, q, k, v, bias, scale in cases:
        summary["k1_checked"].add(k1_key(q, k, bias))
        dt = str(q.dtype)[6:]
        got = flash_attention(q, k, v, bias, scale)
        if dt == "bfloat16" and q.shape[-1] in TC_HEAD_DIMS:
            # the (B, H, Sq, D) view of a (B, Sq, H, D) buffer: merge_heads
            # is a view of it, no copy
            check(merge_heads(got).data_ptr() == got.data_ptr()
                  and got.transpose(1, 2).is_contiguous(),
                  f"K1 {name}: output is not merge_heads-ready")
        ref = flash_attention_reference(q, k, v, bias, scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        check(err <= K1_TOL[dt], f"K1 {name}: max abs err {err}")
        row = {"kernel": "flash_attention", "case": name,
               "shape": list(q.shape), "sk": k.shape[2],
               "bias": None if bias is None else list(bias.shape),
               "max_abs_err": err, "tolerance": K1_TOL[dt]}
        if name.startswith("vit"):
            b, h, sq, dd = q.shape
            nbytes = 4 * q.numel() * q.element_size()
            row.update(bound(nbytes, 4 * b * h * sq * k.shape[2] * dd, dt))
            row.update(k1_times(torch, q, k, v, scale))
            if name == "vit_b1_bfloat16":
                summary["flash_attention"] = row
            elif name == "vit_b8_bfloat16":
                summary["flash_attention_b8"] = row
            elif name == f"vit_strided_b{vit['calib']}_bfloat16":
                summary["flash_attention_calib"] = row
            elif name == f"vit_strided_b{vit['train']}_bfloat16":
                summary["flash_attention_train"] = row
            elif name == f"vit_strided_b{vit['difws']}_bfloat16":
                summary["flash_attention_difws"] = row
            elif name == f"vit_strided_b{vit['folded']}_bfloat16":
                summary["flash_attention_folded"] = row
            elif name == f"vit_strided_b{8 * vit['folded']}_bfloat16":
                summary["flash_attention_folded_b8"] = row
        elif name.startswith("tome") and name.endswith("bfloat16"):
            b, h, sq, dd = q.shape
            streams = b // 2
            if streams in (1, vit["calib"]):
                # q, k, v and the output once, the bias's one row an image
                nbytes = (4 * q.numel() * q.element_size()
                          + b * sq * bias.element_size())
                row.update(bound(nbytes, 4 * b * h * sq * sq * dd, dt))
                row.update(k1_bias_times(torch, q, k, v, bias, scale))
                summary["flash_attention_tome" if streams == 1
                        else "flash_attention_tome_calib"].append(row)
        rows.append(row)
    big = torch.zeros(1, 1, 8, 144, dtype=torch.bfloat16, device="cuda")
    try:
        flash_attention(big, big, big)
    except ValueError:
        pass
    else:
        check(False, "K1 took a bf16 head dim of 144")

    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    checked = summary["k2_checked"] = set()
    k2_rows = k2_layer_cases(torch, idxs, "deer_3b", checked)
    summary["indexed_matmul"] = layer_summary(k2_rows)
    summary["indexed_matmul_b8"] = layer_summary(k2_rows, m=256)
    # use_hist: a text row a frame, W x 32 rows a stream
    summary["indexed_matmul_hist"] = layer_summary(k2_rows, m=384)
    summary["indexed_matmul_hist_b8"] = layer_summary(k2_rows, m=3072)
    emit({"phase": "kernels", "cases": rows + k2_rows})
    summary.update(phase_kernels_quantized(torch, idxs, checked))
    for kernel in DECODER_KERNEL.values():
        phase_determinism_and_graph(torch, idxs, kernel, checked)
        phase_configs(torch, idxs, kernel, checked)
    return summary


def k2_layer_cases(torch, idxs, model: str, checked: set) -> list:
    """K2 at ``model``'s four products in each of its ``INDEXED_CASES``,
    every layer held against the plain version, then timed."""
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_reference)
    rows = []
    for streams, dts in INDEXED_CASES[model]:
        for name, x, w in k2_cases(torch, streams, getattr(torch, dts),
                                   model):
            m, kk = x.shape
            n = w.shape[2]
            rows.append(indexed_case(
                torch, "indexed_matmul", name, x, n,
                (kk * n + m * kk + m * n) * x.element_size(),
                lambda i: indexed_matmul(x, w, i),
                lambda i: indexed_matmul_reference(x, w, i),
                lambda i: x @ w[i], idxs, checked))
    return rows


def phase_kernels_9b(torch, checked: set) -> dict:
    """K2, K3 and K4 at deer_9b's four products (K = 4096 / 16384, N up to
    16384): each ``INDEXED_CASES["deer_9b"]`` case in all 12 layers against
    its plain version, timed against its bound and cuBLAS on ``W[i]``; two
    launches and CUDA-graph replays bit-identical at B=1 and B=8; each
    block config at ``K2_CONFIG_ROWS``; the cases join ``checked``.
    Returns the layer summaries, keys suffixed ``_9b``."""
    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    k2_rows = k2_layer_cases(torch, idxs, "deer_9b", checked)
    out = {"indexed_matmul_9b": layer_summary(k2_rows),
           "indexed_matmul_9b_b8": layer_summary(k2_rows, m=256)}
    emit({"phase": "kernels_9b", "model": "deer_9b", "cases": k2_rows})
    del k2_rows
    torch.cuda.empty_cache()
    out.update({k.replace("_b8", "_9b_b8") if k.endswith("_b8")
                else k + "_9b": v
                for k, v in phase_kernels_quantized(torch, idxs, checked,
                                                    "deer_9b").items()})
    for kernel in DECODER_KERNEL.values():
        phase_determinism_and_graph(torch, idxs, kernel, checked, "deer_9b",
                                    (1, 8))
        out[kernel + "_9b_configs"] = phase_configs(torch, idxs, kernel,
                                                    checked, "deer_9b")
        torch.cuda.empty_cache()
    return out


def indexed_kernel(kernel: str):
    """(wrapper, plain version, plan function, block configs) of the
    layer-indexed matmul ``kernel``; the wrappers take the stacked weights
    as ``stacked_weights`` gives them, after x."""
    from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm
    if kernel == "indexed_matmul":
        return (imm.indexed_matmul, imm.indexed_matmul_reference,
                imm.indexed_matmul_plan, imm.K2_CONFIGS)
    q4 = kernel == "indexed_matmul_q4"
    return (getattr(imm, kernel), getattr(imm, kernel + "_reference"),
            lambda m, k, n, config=None: imm.indexed_matmul_quant_plan(
                m, k, n, q4, config=config),
            imm.QUANT_CONFIGS)


def stacked_weights(torch, gen, kernel: str, k: int, n: int) -> tuple:
    """The 12-layer stack of one decoder product as ``kernel`` takes it:
    (W,) in bf16 for K2, (int8 codes, scales) for K3, (packed int4 codes,
    scales) for K4, quantized from the same kind of random weights."""
    from deer_vla_tpu_torch.ops.quant import quantize_weight, quantize_weight4
    w = torch.randn(12, k, n, generator=gen, device="cuda") * k ** -0.5
    if kernel == "indexed_matmul":
        return (w.to(torch.bfloat16),)
    return (quantize_weight4 if kernel == "indexed_matmul_q4"
            else quantize_weight)(w)


def phase_determinism_and_graph(torch, idxs, kernel: str, checked: set,
                                model: str = "deer_3b",
                                streams_list=(1, 2, 3, 4, 8)) -> None:
    """The split-K sums are combined in a fixed order: two launches give
    bit-identical outputs.  The four products of a layer captured once in a
    CUDA graph, replayed after ``idx.fill_(j)`` for each of the 12 layers,
    equal the eager launches bit for bit and the plain version within
    K2_REL_TOL: the layer index is read on the device at every replay."""
    fn, plain, plan_of, _ = indexed_kernel(kernel)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    stacks = [(prod, stacked_weights(torch, gen, kernel, k, n))
              for prod, k, n in DECODER_PRODUCTS[model]]
    phase = ("k2" if kernel == "indexed_matmul" else "k3_k4") \
        + "_determinism_and_graph" + ("_9b" if model == "deer_9b" else "")
    out = {"phase": phase, "kernel": kernel, "model": model, "cases": []}
    for streams in streams_list:
        prods = [(f"{prod}_b{streams}",
                  torch.randn(32 * streams, w[0].shape[1] * (
                      2 if kernel == "indexed_matmul_q4" else 1),
                      generator=gen, device="cuda").to(torch.bfloat16), w)
                 for prod, w in stacks]
        splits = [plan_of(x.shape[0], x.shape[1], w[0].shape[2]).splits
                  for _, x, w in prods]
        for (name, x, w), sp in zip(prods, splits):
            a = fn(x, *w, idxs[5])
            b = fn(x, *w, idxs[5])
            check(torch.equal(a, b), f"{kernel} {name}: two launches differ "
                                     f"(splits {sp})")
        idx = torch.zeros((), dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            for _ in range(2):
                [fn(x, *w, idx) for _, x, w in prods]
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ys = [fn(x, *w, idx) for _, x, w in prods]
        worst = 0.0
        for j in range(12):
            idx.fill_(j)
            graph.replay()
            torch.cuda.synchronize()
            for (name, x, w), y in zip(prods, ys):
                check(torch.equal(y, fn(x, *w, idxs[j])),
                      f"{kernel} {name}: graph replay at layer {j} differs "
                      f"from the eager launch")
                ref = plain(x, *w, idxs[j]).float()
                err = (y.float() - ref).abs().max().item()
                tol = K2_REL_TOL["bfloat16"] * ref.abs().max().item()
                check(err <= tol, f"{kernel} {name}: graph replay at layer "
                                  f"{j}: {err} > {tol}")
                worst = max(worst, err / tol)
                checked.add((kernel, x.shape[0], x.shape[1], y.shape[1],
                             "bfloat16"))
        out["cases"].append({"streams": streams,
                             "products": [p[0] for p in prods],
                             "splits": splits, "repeat_bit_identical": True,
                             "graph_layers_replayed": 12,
                             "graph_equals_eager": True,
                             "graph_worst_err_over_tol": worst})
        del graph, ys, prods
    emit(out)


def phase_configs(torch, idxs, kernel: str, checked: set,
                  model: str = "deer_3b") -> dict:
    """Each block config of ``kernel`` (its plan function's ``config=c``) on
    the decoder's four products at ``K2_CONFIG_ROWS`` rows: checked against
    the plain version at the first and last layer, then timed cycling
    through the layers, so the config the plan picks for a row count is
    seen beside the others.  Returns the layer times by row count."""
    fn, plain, plan_of, configs = indexed_kernel(kernel)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    rows = []
    layer = {m: [0.0] * len(configs) for m in K2_CONFIG_ROWS}
    planned = {}
    for prod, k, n in DECODER_PRODUCTS[model]:
        w = stacked_weights(torch, gen, kernel, k, n)
        xs = torch.randn(max(K2_CONFIG_ROWS), k, generator=gen,
                         device="cuda").to(torch.bfloat16)
        for m in K2_CONFIG_ROWS:
            x = xs[:m]
            planned[m] = plan_of(m, k, n).config
            for c in range(len(configs)):
                plan = plan_of(m, k, n, config=c)
                err = tol = 0.0
                for j in (0, 11):
                    got = fn(x, *w, idxs[j], plan=plan).float()
                    ref = plain(x, *w, idxs[j]).float()
                    err = max(err, (got - ref).abs().max().item())
                    tol = max(tol, K2_REL_TOL["bfloat16"]
                              * ref.abs().max().item())
                check(err <= tol, f"{kernel} {prod} m={m} config {c}: max "
                                  f"abs err {err} > {tol}")
                checked.add((kernel, m, k, n, "bfloat16"))
                it = iter(range(10 ** 9))
                ms = graph_ms(torch, lambda: fn(
                    x, *w, idxs[next(it) % 12], plan=plan), 48)
                layer[m][c] += ms
                rows.append({"product": prod, "m": m, "config": c,
                             "instruction": plan.instruction,
                             "splits": plan.splits, "blocks": plan.blocks,
                             "planned": c == planned[m], "ms": ms,
                             "max_abs_err": err, "tolerance": tol})
        del w, xs
    by_rows = {m: {"planned": planned[m], "by_config": ms,
                   "fastest": min(range(len(ms)), key=ms.__getitem__)}
               for m, ms in layer.items()}
    emit({"phase": ("k2_configs" if kernel == "indexed_matmul"
                    else "k3_k4_configs")
          + ("_9b" if model == "deer_9b" else ""), "kernel": kernel,
          "model": model,
          "configs": [c._asdict() for c in configs],
          "layer_ms": by_rows, "rows": rows})
    return by_rows


def phase_kernels_quantized(torch, idxs, checked: set,
                            model: str = "deer_3b") -> dict:
    """K3 and K4 at ``model``'s four decoder products.  The library call is
    cuBLAS's ``x @ Wd[idx]`` over the same stack dequantized to x's dtype
    beforehand: the product that quantized serving exists to beat."""
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul_q4, indexed_matmul_q4_reference, indexed_matmul_q8,
        indexed_matmul_q8_reference)
    from deer_vla_tpu_torch.ops.quant import (dequantize_weight,
                                              dequantize_weight4,
                                              quantize_weight,
                                              quantize_weight4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
    rows = {"indexed_matmul_q8": [], "indexed_matmul_q4": []}
    for prod, k, n in DECODER_PRODUCTS[model]:
        w = torch.randn(12, k, n, generator=gen, device="cuda") * k ** -0.5
        q8, s8 = quantize_weight(w)
        q4, s4 = quantize_weight4(w)
        del w
        xs = {(streams, dts): torch.randn(32 * streams, k, generator=gen,
                                          device="cuda").to(getattr(torch,
                                                                    dts))
              for streams, dts in INDEXED_CASES[model]}
        for kernel, fn, plain, wq, s, deq, wbytes in (
                ("indexed_matmul_q8", indexed_matmul_q8,
                 indexed_matmul_q8_reference, q8, s8,
                 lambda dt: dequantize_weight(q8, s8, dt), k * n),
                ("indexed_matmul_q4", indexed_matmul_q4,
                 indexed_matmul_q4_reference, q4, s4,
                 lambda dt: dequantize_weight4(q4, s4, dt), k * n // 2)):
            wd = {}
            for (streams, dts), x in xs.items():
                if dts not in wd:
                    wd[dts] = deq(getattr(torch, dts))
                m = x.shape[0]
                es = x.element_size()
                rows[kernel].append(indexed_case(
                    torch, kernel, f"{prod}_b{streams}_{dts}", x, n,
                    wbytes + 4 * n + (m * k + m * n) * es,
                    lambda i: fn(x, wq, s, i),
                    lambda i: plain(x, wq, s, i),
                    lambda i: x @ wd[dts][i], idxs, checked))
            del wd
    emit({"phase": "kernels_quantized"
          + ("_9b" if model == "deer_9b" else ""), "model": model,
          "library": "x @ Wd[idx], Wd dequantized to x.dtype beforehand "
                     "(cuBLAS)",
          "cases": rows["indexed_matmul_q8"] + rows["indexed_matmul_q4"]})
    out = {}
    for kernel, r in rows.items():
        out[kernel] = layer_summary(r)
        out[kernel + "_b8"] = layer_summary(r, m=256)
    return out


def make_policy_inputs(np, cfg, b: int, seed: int):
    r = np.random.RandomState(seed)
    hw = cfg.vit.image_size
    img = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    ids = r.randint(0, cfg.media_token_id, size=(b, cfg.text_len))
    ids[:, 0] = cfg.media_token_id
    mask = np.ones((b, cfg.text_len), np.int64)
    mask[:, cfg.text_len - 4:] = 0  # a padded tail
    return img, grip, ids, mask


def build_weights(torch, cfg):
    """Seeded random weights of ``cfg`` on the card.  The init leaves the
    cross-attention gates at zero, as the reference does; they are drawn
    here so that the vision path reaches the actions."""
    from deer_vla_tpu_torch.models.flamingo import init_deer
    params = init_deer(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for x in params["decoder"]["xattn"]:
        if x is None:
            continue
        x["attn_gate"].uniform_(-0.5, 0.5, generator=gen)
        x["ff_gate"].uniform_(-0.5, 0.5, generator=gen)
    return params


def kernel_counters():
    from deer_vla_tpu_torch.ops.kernels.flash_attention import flash_attention
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_q4, indexed_matmul_q8)
    return {f.__name__: f for f in (flash_attention, indexed_matmul,
                                    indexed_matmul_q8, indexed_matmul_q4)}


# the decoder kernel each serving mode must launch (w8a8 modes: none, their
# decoder products are int8 x int8 -> int32 products outside the kernels)
DECODER_KERNEL = {None: "indexed_matmul", "int8": "indexed_matmul_q8",
                  "int4": "indexed_matmul_q4"}


def phase_serve(torch, np, cfg, pol, quantize=None, b1_steps=8,
                b8_steps=4, name=None, config="deer_3b",
                sweep=SWEEP, inputs=None) -> dict:
    """Serve ``b1_steps`` single-stream steps, then ``b8_steps`` eight-stream
    steps, with every kernel's launch count set to 0 just before and read
    just after; the thresholds are ``sweep``'s, one a step (a stream at
    B=8).  ``inputs(b, seed)`` gives a step's (args, keyword args)
    (``make_policy_inputs`` unless given).  The actions are (7,) or a
    (k, 7) plan a stream.  An MPT decoder must launch its mode's decoder
    kernel; a llama decoder none of K2-K4, and K1 once a ViT layer a
    step."""
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    if inputs is None:
        def inputs(b, seed):
            return make_policy_inputs(np, cfg, b, seed), {}
    k = cfg.head.multi_step_action
    plan = (k, 7) if k > 1 else (7,)
    if cfg.head_type == "diffusion":  # the chosen exit's feature
        plan = (cfg.head.hidden_size,)
    n_exits = len(pol.exits)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    b1_ms, b1_exits = [], []
    pol.reset()
    for s in range(b1_steps):
        pol.set_thresholds([sweep[s]] * n_exits)
        args, kw = inputs(1, 100 + s)
        t0 = time.perf_counter()
        act = pol.step(*args, **kw)
        b1_ms.append((time.perf_counter() - t0) * 1e3)
        check(act.shape == plan and bool(np.isfinite(act).all()),
              f"{quantize} B=1 step {s}: action {act}")
        b1_exits.append(pol.last_exit_layer)
    b8_ms, b8_exits = [], []
    pol.set_thresholds_batch([[t] * n_exits for t in sweep])
    pol.reset()
    for s in range(b8_steps):
        args, kw = inputs(8, 200 + s)
        t0 = time.perf_counter()
        acts, exits = pol.step_batch(*args, **kw)
        b8_ms.append((time.perf_counter() - t0) * 1e3)
        check(acts.shape == (8,) + plan and bool(np.isfinite(acts).all()),
              f"{quantize} B=8 step {s}: non-finite actions")
        b8_exits.append(exits.tolist())
    launches = {name: f.launches for name, f in counters.items()}
    every = set(b1_exits) | {e for row in b8_exits for e in row}
    check(every <= set(pol.exits), f"exit layers {every} not in {pol.exits}")
    if b1_steps:
        check(len(set(b1_exits)) > 1, f"{quantize} B=1 exits all at "
                                      f"{b1_exits}")
    steps = b1_steps + b8_steps
    if cfg.mpt.arch == "llama":
        check(launches["flash_attention"] == cfg.vit.layers * steps
              and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
              f"{config} {quantize}: K1 must run {cfg.vit.layers} times a "
              f"step and K2-K4 not: {launches}")
    else:
        decoder = DECODER_KERNEL.get(quantize)
        check(launches["flash_attention"] > 0
              and (decoder is None or launches[decoder] > 0),
              f"{quantize}: kernels not launched on the main path: "
              f"{launches}")
        if quantize:
            check(launches["indexed_matmul"] == 0,
                  f"{quantize}: the bf16 kernel K2 ran: {launches}")
    out = {"phase": name or ("serve" if quantize is None
                             else f"serve_{quantize}"),
           "config": config, "quantize": quantize,
           "tome_r": cfg.vit.tome_r,
           "vit": [cfg.vit.layers, cfg.vit.width], "mpt": [cfg.n_layers,
                                                           cfg.mpt.d_model],
           "compute": str(cfg.dtypes.cdt)[6:],
           "params": str(cfg.dtypes.pdt)[6:],
           "b1_thresholds": sweep[:b1_steps], "b1_exit_layers": b1_exits,
           "b1_step_ms": b1_ms,
           "b1_median_ms": statistics.median(b1_ms) if b1_ms else None,
           "b8_stream_thresholds": sweep, "b8_exit_layers": b8_exits,
           "b8_step_ms": b8_ms, "b8_median_ms": statistics.median(b8_ms),
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "stacked_bytes": tree_bytes(pol.stacked),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


SERVE_MODES = (("int8", 8), ("int4", 8), ("int8_w8a8", 0), ("int4_w8a8", 0))


def phase_serve_quantized(torch, np, cfg, params, bf16_bytes: int,
                          modes=SERVE_MODES, config="deer_3b",
                          sweep=SWEEP, prefix="serve") -> dict:
    """Each (mode, B=1 steps) of ``modes`` at B=1 and B=8: int8 and int4
    through K3 / K4 on an MPT decoder, the w8a8 modes at B=8 only; each
    policy is freed before the next is built."""
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    out = {}
    for mode, b1_steps in modes:
        pol = ScanDeerPolicy(params, cfg, indexed_mm=cfg.mpt.arch == "mpt",
                             quantize=mode)
        torch.cuda.reset_peak_memory_stats()
        res = phase_serve(torch, np, cfg, pol, mode, b1_steps=b1_steps,
                          name=f"{prefix}_{mode}", config=config,
                          sweep=sweep)
        res["stacked_bytes_vs_bf16"] = res["stacked_bytes"] / bf16_bytes
        out[mode] = res
        del pol
        torch.cuda.empty_cache()
    emit({"phase": f"{prefix}_quantized_summary", "config": config,
          "stacked_bytes_bf16": bf16_bytes,
          "modes": {m: {"b1_median_ms": r["b1_median_ms"],
                        "b8_median_ms": r["b8_median_ms"],
                        "stacked_bytes": r["stacked_bytes"],
                        "stacked_bytes_vs_bf16": r["stacked_bytes_vs_bf16"],
                        "launches": r["launches"]}
                    for m, r in out.items()}})
    return out


def full_depth_step(np, pol, cfg, inputs, kw=None):
    pol.set_thresholds([-1.0] * (len(pol.exits) - 1) + [1e8])
    pol.reset()
    act = pol.step(*inputs, **(kw or {}))
    check(pol.last_exit_layer == cfg.n_layers - 1,
          f"full-depth step exited at {pol.last_exit_layer}")
    return act[:6], pol.last_hidden.float().cpu()


def compare(np, torch, act, hid, act_ref, hid_ref) -> dict:
    return {"arm_max_abs": float(np.abs(act - act_ref).max()),
            "hidden_rel_l2": float(torch.linalg.vector_norm(hid - hid_ref)
                                   / torch.linalg.vector_norm(hid_ref))}


def phase_cross_check(torch, np, cfg, params, cpu_params, pol,
                      name="cross_check", inputs=None) -> dict:
    """One full-depth step of ``pol`` (bf16, the kernels) and of the same
    weights in fp32 on the card, each against fp32 on the CPU through the
    plain versions (``CROSS_TOL_BF16`` / ``CROSS_TOL_FP32``); ``inputs``
    (args, keyword args) of the step, ``make_policy_inputs``' unless
    given."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inputs, kw = inputs or (make_policy_inputs(np, cfg, 1, seed=300), {})
    act_bf16, hid_bf16 = full_depth_step(np, pol, cfg, inputs, kw)
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32, indexed_mm=True)
    act_f32, hid_f32 = full_depth_step(np, card32, cfg32, inputs, kw)
    del card32
    t0 = time.perf_counter()
    cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True, device="cpu")
    act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs, kw)
    cpu_s = time.perf_counter() - t0
    bf16 = compare(np, torch, act_bf16, hid_bf16, act_ref, hid_ref)
    f32 = compare(np, torch, act_f32, hid_f32, act_ref, hid_ref)
    del cpu
    out = {"phase": name, "exit_layer": cfg.n_layers - 1,
           "card_bf16_vs_cpu_fp32": bf16, "tol_bf16": CROSS_TOL_BF16,
           "card_fp32_vs_cpu_fp32": f32, "tol_fp32": CROSS_TOL_FP32,
           "arm_card_bf16": act_bf16.tolist(),
           "arm_cpu_fp32": act_ref.tolist(), "cpu_seconds": cpu_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    for got, tol, what in ((bf16, CROSS_TOL_BF16, "bf16"),
                           (f32, CROSS_TOL_FP32, "fp32")):
        for key, limit in tol.items():
            check(got[key] <= limit, f"{name} {what} {key} {got[key]}")
    return out


def phase_cross_check_quantized(torch, np, cfg, params, cpu_params) -> None:
    """int8 and int4: the same fp32 weights quantized on the card and on the
    CPU must give the same codes and scales bit for bit; then one
    full-depth fp32 step on each (K3 / K4's fp32 paths on the card, their
    plain versions on the CPU) must agree within CROSS_TOL_FP32."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    for mode, keys in (("int8", ("q", "s")), ("int4", ("q4", "s4"))):
        card = ScanDeerPolicy(params, cfg32, indexed_mm=True, quantize=mode)
        act_card, hid_card = full_depth_step(np, card, cfg32, inputs)
        t0 = time.perf_counter()
        cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True,
                             quantize=mode, device="cpu")
        cpu_bufs = dict(cpu.named_buffers())
        codes = [(name, buf) for name, buf in card.named_buffers()
                 if name.rsplit("__", 1)[-1] in keys]
        differ = [name for name, buf in codes
                  if not torch.equal(buf.cpu(), cpu_bufs[name])]
        check(len(codes) > 0 and not differ,
              f"{mode}: card and CPU quantization differ in {differ[:5]}")
        act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs)
        cpu_s = time.perf_counter() - t0
        got = compare(np, torch, act_card, hid_card, act_ref, hid_ref)
        emit({"phase": f"cross_check_{mode}", "exit_layer": cfg.n_layers - 1,
              "quantized_leaves_bit_equal": len(codes),
              "quantized_bytes": sum(b.numel() * b.element_size()
                                     for _, b in codes),
              "card_fp32_vs_cpu_fp32": got, "tol_fp32": CROSS_TOL_FP32,
              "cpu_seconds": cpu_s})
        for key, limit in CROSS_TOL_FP32.items():
            check(got[key] <= limit, f"cross_check {mode} {key} {got[key]}")
        del card, cpu
        torch.cuda.empty_cache()


def calib_debug_batches(cfg, batch_size: int, num_batches: int):
    """DebugBatcher batches at the ViT's resolution and the config with the
    debug tokenizer's media token, as the eval CLI builds them."""
    from deer_vla_tpu_torch.data.debug_data import DebugBatcher
    from deer_vla_tpu_torch.data.text import HashTokenizer
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    hw = cfg.vit.image_size
    return cfg, list(DebugBatcher(cfg, tok, batch_size=batch_size,
                                  num_batches=num_batches, img_hw=hw,
                                  grip_hw=hw, seed=SEED))


def phase_calibrate(torch, np, cfg, params, name="calibrate",
                    model="deer_3b") -> dict:
    """Calibration of ``cfg`` (W=12) on 2 DebugBatcher batches of 2
    trajectories, folded and streamed: each batch is one training forward
    (48 ViT images through K1, every decoder layer kept) and the exit
    deltas, with every kernel's count set to 0 before the batch and read
    after it; ``model`` names its target exit schedule (cli/eval's
    ``--model``)."""
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE as bs
    from deer_vla_tpu_torch.models.value_net import solve_thresholds
    cfg, batches = calib_debug_batches(cfg, bs, 2)
    exits = list(cfg.all_exit_ids())
    counters = kernel_counters()
    out = {"phase": name, "config": model,
           "window": cfg.window_size, "batch_size": bs,
           "compute": str(cfg.dtypes.cdt)[6:], "regimes": {}}
    for regime in ("folded", "streamed"):
        streamed = regime == "streamed"
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        esp = (streamed_sample_probs(cfg, 1.0, None, "exp", model)
               if streamed else None)
        vals, secs, launches = [], [], []
        for batch in batches:
            for f in counters.values():
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals.append(generate_calibration_values(  # ends on the host
                params, cfg, [batch], gen=gen, streamed=streamed,
                exit_sample_probs=esp))
            secs.append(time.perf_counter() - t0)
            launches.append({n: f.launches for n, f in counters.items()})
        v = np.concatenate(vals, axis=1)
        per_traj = cfg.window_size // 2 + (1 if streamed else 0)
        check(v.shape == (len(exits), bs * len(batches) * per_traj)
              and bool(np.isfinite(v).all()),
              f"calibrate {regime}: values {v.shape}")
        check(all(n["flash_attention"] > 0 for n in launches),
              f"calibrate {regime}: K1 not launched: {launches}")
        th = {str(r): solve_thresholds(v, r, exits, cfg.n_layers - 1,
                                       model_name=model)[0]
              for r in (1.0, 0.5)}
        out["regimes"][regime] = {
            "values_shape": list(v.shape),
            "min": float(v.min()), "median": float(np.median(v)),
            "max": float(v.max()), "thresholds": th,
            "seconds_per_batch": secs, "launches_per_batch": launches}
    emit(out)
    return out


# The calibration forward on the card in fp32 against fp32 on the CPU: only
# the summation order differs.  The actions (|a| <= 0.06 with these random
# weights) are held to 1e-6, about 270 fp32 ulps; a delta (about 3e-5) is
# the difference of two actions some 2e3 times larger, so its error is
# theirs: 1e-7 absolute (27 ulps of the actions), 1e-2 relative L2.  The
# first run on an H100 measured 1.0e-6 / 1.6e-6 (hidden), 7.5e-9 (actions),
# 1.0e-4 / 4.8e-9 (deltas).
CALIB_TOL_FP32 = {"hidden_rel_l2": 1e-4, "hidden_max_abs_rel": 1e-4,
                  "actions_max_abs": 1e-6, "delta_rel_l2": 1e-2,
                  "delta_max_abs": 1e-7}


def calib_forward(torch, params, cfg, batch, device, gen=None, lay1=None,
                  commits=None):
    """One batch's training forward and both regimes' deltas on ``device``;
    the layer draws come from ``gen`` or ``lay1`` / ``commits``."""
    from deer_vla_tpu_torch.eval.calibrate import batch_inputs
    from deer_vla_tpu_torch.models.flamingo import forward_train
    from deer_vla_tpu_torch.models.value_net import (
        generate_exit_deltas, generate_streamed_exit_deltas)
    exits = list(cfg.all_exit_ids())
    with torch.inference_mode():
        img, gri, ids, mask = batch_inputs(batch, cfg, device)
        out = forward_train(params, img, ids, mask, cfg, gen,
                            vision_gripper=gri, only_extra_exit=True,
                            train=False, rand_layer_ids=lay1)
        folded = generate_exit_deltas(params["extra_exit"], out.hidden_states,
                                      out.rand_layer_feat, cfg, exits)
        streamed = generate_streamed_exit_deltas(
            params["extra_exit"], out.hidden_states, cfg, exits,
            commit_exits=commits)
    return {"hidden": out.hidden_states.float().cpu(),
            "actions": out.final_output.actions.float().cpu(),
            "folded": folded.float().cpu(), "streamed": streamed.float().cpu(),
            "lay1": out.rand_layer_ids}


def phase_calibrate_cross_check(torch, np, cfg, params, cpu_params) -> None:
    """deer_3b at W=2, one trajectory (4 ViT images): the calibration
    forward and both regimes' deltas in fp32 on the card against fp32 on
    the CPU, with the card's layer draws and one commit sequence."""
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    cfg2, batches = calib_debug_batches(
        deer_3b(window_size=CALIB_CROSS_WINDOW, dtypes=FP32), 1, 1)
    commits = [i % len(cfg2.all_exit_ids()) for i in range(4)]
    card = calib_forward(torch, params, cfg2, batches[0],
                         torch.device("cuda"),
                         gen=torch.Generator(device="cuda").manual_seed(SEED),
                         commits=commits)
    t0 = time.perf_counter()
    cpu = calib_forward(torch, cpu_params, cfg2, batches[0],
                        torch.device("cpu"), lay1=card["lay1"].cpu(),
                        commits=commits)
    cpu_s = time.perf_counter() - t0

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    got = {"hidden_rel_l2": rel_l2(card["hidden"], cpu["hidden"]),
           "hidden_max_abs_rel": float((card["hidden"] - cpu["hidden"]).abs()
                                       .max() / cpu["hidden"].abs().max()),
           "actions_max_abs": float((card["actions"] - cpu["actions"]).abs()
                                    .max())}
    for regime in ("folded", "streamed"):
        got[f"{regime}_delta_rel_l2"] = rel_l2(card[regime], cpu[regime])
        got[f"{regime}_delta_max_abs"] = float(
            (card[regime] - cpu[regime]).abs().max())
    emit({"phase": "calibrate_cross_check", "config": "deer_3b W=2 B=1 fp32",
          "card_fp32_vs_cpu_fp32": got, "tol_fp32": CALIB_TOL_FP32,
          "delta_max": {r: float(cpu[r].abs().max())
                        for r in ("folded", "streamed")},
          "actions_max": float(cpu["actions"].abs().max()),
          "cpu_seconds": cpu_s})
    for key, value in got.items():
        limit = CALIB_TOL_FP32[key.replace("folded_", "")
                               .replace("streamed_", "")]
        check(value <= limit, f"calibrate cross-check {key} {value} > "
                              f"{limit}")


ROLLOUT_ARGV = ["--debug", "--model", "deer_3b", "--calib_batches", "2",
                "--num_sequences_override", "2", "--ep_len", "40",
                "--exit_ratio", "0.5"]


def decoder_kernel(args):
    """The decoder kernel a cli/eval run launches: none on the host-bucketed
    engine (DeerPolicy runs ``linear`` on per-layer weights, as the JAX
    package's segment programs do) or for a llama decoder (K2-K4 compute the
    MPT block's products), else K2 or, quantized, K3 / K4."""
    from deer_vla_tpu_torch.cli import eval as cli
    if cli.model_config(args).mpt.arch != "mpt":
        return None
    bucketed = (args.engine == "bucketed" or args.exit_id is not None
                or args.use_action_ensemble or args.multi_execution > 1
                or args.layerwise_exit_eval)
    if bucketed and args.lanes <= 1:
        return None
    return DECODER_KERNEL[None if args.quantize == "none" else args.quantize]


def phase_rollout(torch, np, phase: str, argv: list) -> dict:
    """``cli/eval.main(argv)`` in-process on the card, bf16: calibrate
    deer_3b on 2 debug batches (unless --exit_id), serve in DebugEnv
    rollouts of 2 sequences through the engine and options the flags ask
    for; the kernel counts are set to 0 before the call and read after it.
    K1 must launch, the decoder's kernel (``decoder_kernel``) too, and the
    other decoder kernels not."""
    import io
    from deer_vla_tpu_torch.cli import eval as cli
    args = cli.build_parser().parse_args(argv)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        report = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    text = buf.getvalue()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"cli_eval_{phase}.log").write_text(text)
    last = text.strip().splitlines()[-3:]
    th = [float(t) for t in last[0].split(",") if t]
    exits = set(cli.model_config(args).all_exit_ids())
    taken = {e for e, p in enumerate(report["exit_hist"]) if p > 0}
    check(len(th) == (0 if args.exit_id is not None else len(exits))
          and abs(float(last[1]) - report["avg_seq_len"]) < 1e-5
          and abs(float(last[2]) - (report["avg_exit_layer"] - 1)) < 1e-5,
          f"{phase}: parse contract {last}")
    want = exits if args.exit_id is None else {args.exit_id}
    check(taken and taken <= want, f"{phase}: exits {taken} not in {want}")
    decoder = decoder_kernel(args)
    check(launches["flash_attention"] > 0
          and (decoder is None or launches[decoder] > 0),
          f"{phase}: K1 / {decoder} not launched: {launches}")
    others = set(DECODER_KERNEL.values()) - {decoder}
    check(all(launches[k] == 0 for k in others),
          f"{phase}: a decoder kernel other than {decoder} ran: {launches}")
    out = {"phase": phase, "argv": argv, "seconds": seconds,
           "decoder_kernel": decoder,
           "avg_seq_len": report["avg_seq_len"],
           "avg_exit_layer": report["avg_exit_layer"],
           "exit_hist": report["exit_hist"],
           "avg_llm_gflops": report["avg_llm_gflops"],
           "exit_contract_max_abs_gap":
               report.get("exit_contract", {}).get("max_abs_gap"),
           "thresholds": th, "env_steps": report["env_steps"],
           "rollout_seconds": report["rollout_seconds"],
           "steps_per_s": report["env_steps"] / report["rollout_seconds"],
           "launches": launches,
           "report": {k: report[k] for k in PIPELINE_SAME}}
    for key in ("action_cache_hit_rate", "vision_cache_hit_rate",
                "batched_exit_waste"):
        if key in report:
            out[key] = report[key]
    emit(out)
    torch.cuda.empty_cache()
    return out


def serve_launches(counters, before: dict) -> dict:
    return {n: f.launches - before.get(n, 0) for n, f in counters.items()}


def phase_serve_bucketed(torch, np, cfg, deer, scan_plain, serve,
                         name="serve_bucketed", config="deer_3b",
                         sweep=SWEEP, inputs=None) -> dict:
    """The host-bucketed ``DeerPolicy`` (bf16, a controller with ``sweep``'s
    threshold a step): 8 single-stream steps with the kernel counts set to
    0 before and read after (K1 in the encode prefix; K2-K4 must not run:
    the decoder runs ``linear`` on per-layer weights).  Each step is then
    held against ``scan_plain``, a ``ScanDeerPolicy`` with the same
    products (cuBLAS, indexed_mm off), on the same weights, inputs,
    thresholds and carry: the same exit (BUCKETED_TOL on the actions).
    ``serve`` is phase serve's result, for its B=1 median (K2) beside;
    ``inputs`` as in ``phase_serve``."""
    if inputs is None:
        def inputs(b, seed):
            return make_policy_inputs(np, cfg, b, seed), {}
    k = cfg.head.multi_step_action
    ctrl = deer.controller
    n = len(deer.bucket_exits)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    steps = []
    deer.reset()
    for s in range(8):
        ctrl.set_threshold_values([sweep[s]] * n)
        step_in = inputs(1, 100 + s)
        carry_in = (None if deer.carry is None
                    else tuple(c.clone() for c in deer.carry))
        deer.set_timestep(s)
        t0 = time.perf_counter()
        act = deer.step(*step_in[0], **step_in[1])
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "exit": deer.last_exit_layer, "act": act,
                      "inputs": step_in, "carry_in": carry_in})
        check(act.shape == ((k, 7) if k > 1 else (7,))
              and bool(np.isfinite(act).all()),
              f"{name} step {s}: action {act}")
    launches = {n_: f.launches for n_, f in counters.items()}
    check(launches["flash_attention"] > 0
          and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
          f"{name}: K1 must run and K2-K4 not: {launches}")
    exits = [st["exit"] for st in steps]
    check(len(set(exits)) > 1, f"{name}: exits all at {exits}")
    scan_ms, scan_exits, err = [], [], 0.0
    for s, st in enumerate(steps):
        scan_plain.set_thresholds([sweep[s]] * n)
        scan_plain.reset()
        if st["carry_in"] is not None:
            scan_plain.carry, scan_plain._carry_rows = st["carry_in"], 1
        t0 = time.perf_counter()
        act = scan_plain.step(*st["inputs"][0], **st["inputs"][1])
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        scan_exits.append(scan_plain.last_exit_layer)
        err = max(err, float(np.abs(act - st["act"]).max()))
    check(scan_exits == exits,
          f"{name}: exits {exits}, ScanDeerPolicy {scan_exits}")
    check(err <= BUCKETED_TOL["arm_max_abs"],
          f"{name}: actions differ by {err}")
    out = {"phase": name, "config": config,
           "engine": "DeerPolicy", "thresholds": sweep, "exit_layers": exits,
           "b1_step_ms": [st["ms"] for st in steps],
           "b1_median_ms": statistics.median(st["ms"] for st in steps),
           "scan_cublas_exit_layers": scan_exits,
           "scan_cublas_step_ms": scan_ms,
           "scan_cublas_median_ms": statistics.median(scan_ms),
           "scan_k2_b1_median_ms": serve["b1_median_ms"],
           "vs_scan_arm_max_abs": err, "tolerance": BUCKETED_TOL,
           "launches": launches}
    emit(out)
    return out


@contextlib.contextmanager
def merge_log(log: list):
    """While open, appends (src, dst) on the host for every ToMe merge the
    models run (``ops.tome.match_pairs``, one call a merging layer)."""
    from deer_vla_tpu_torch.ops import tome
    match = tome.match_pairs

    def logged(metric, r):
        src, unm, dst = match(metric, r)
        log.append((src.cpu(), dst.cpu()))
        return src, unm, dst

    tome.match_pairs = logged
    try:
        yield log
    finally:
        tome.match_pairs = match


def merges_agree(torch, a: list, b: list) -> list:
    """Per merging layer, the share of (image, merge) entries whose source
    and destination tokens are the same in two runs' logs."""
    check(len(a) == len(b), f"{len(a)} against {len(b)} merging layers")
    return [float(((sa == sb) & (da == db)).float().mean())
            for (sa, da), (sb, db) in zip(a, b)]


def phase_serve_tome(torch, np, cfg, params, cpu_params) -> dict:
    """``ScanDeerPolicy`` with ToMe (r = TOME_R) in bf16: phase_serve's B=1
    and B=8 steps (K1 at the ToMe shapes with their bias), then one
    full-depth step on the card in bf16 and in fp32 against fp32 on the CPU
    through the plain versions, with the merge indices compared layer by
    layer (TOME_TOL_BF16 / CROSS_TOL_FP32 on the step; in fp32 the merges
    must agree)."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg_t = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, tome_r=TOME_R))
    pol = ScanDeerPolicy(params, cfg_t, indexed_mm=True)
    res = phase_serve(torch, np, cfg_t, pol, name="serve_tome")
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    logs = {"bf16": [], "fp32": [], "cpu": []}
    with merge_log(logs["bf16"]):
        act_bf16, hid_bf16 = full_depth_step(np, pol, cfg_t, inputs)
    del pol
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg_t, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32, indexed_mm=True)
    with merge_log(logs["fp32"]):
        act_f32, hid_f32 = full_depth_step(np, card32, cfg32, inputs)
    del card32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True, device="cpu")
    with merge_log(logs["cpu"]):
        act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs)
    cpu_s = time.perf_counter() - t0
    del cpu
    bf16 = compare(np, torch, act_bf16, hid_bf16, act_ref, hid_ref)
    f32 = compare(np, torch, act_f32, hid_f32, act_ref, hid_ref)
    agree_bf16 = merges_agree(torch, logs["bf16"], logs["cpu"])
    agree_f32 = merges_agree(torch, logs["fp32"], logs["cpu"])
    out = {"phase": "serve_tome_cross_check", "tome_r": TOME_R,
           "merging_layers": len(logs["cpu"]),
           "bf16_first_layer_merging_otherwise": next(
               (i for i, a in enumerate(agree_bf16) if a < 1.0), None),
           "card_bf16_vs_cpu_fp32": bf16, "tol_bf16": TOME_TOL_BF16,
           "card_fp32_vs_cpu_fp32": f32, "tol_fp32": CROSS_TOL_FP32,
           "merges_agree_bf16_per_layer": agree_bf16,
           "merges_agree_fp32_per_layer": agree_f32, "cpu_seconds": cpu_s}
    emit(out)
    for got, tol, what in ((bf16, TOME_TOL_BF16, "bf16"),
                           (f32, CROSS_TOL_FP32, "fp32")):
        for key, limit in tol.items():
            check(got[key] <= limit, f"serve_tome {what} {key} {got[key]}")
    check(all(a == 1.0 for a in agree_f32),
          f"serve_tome: fp32 merges differ from the CPU's: {agree_f32}")
    res["cross_check"] = out
    return res


# frames of the cache phases: a frame three times, a new one twice
CACHE_FRAMES = (0, 0, 0, 1, 1)
# the action cache: the first frame four times (a refresh at the fourth),
# then a new one twice: misses at 0, 3, 4, hits at 1, 2, 5
ACTION_CACHE_FRAMES = (0, 0, 0, 0, 1, 1)


def phase_caches(torch, np, cfg, scan, deer) -> dict:
    """The vision caches around ``scan`` (ScanDeerPolicy, K2) and ``deer``
    (DeerPolicy) over CACHE_FRAMES: encode hits counted (K1 launches only on
    a miss), and every step's action equal to the uncached policy's step
    from the same carry; then the action cache around ``scan`` over
    ACTION_CACHE_FRAMES: hits, refreshes and the replayed actions."""
    from deer_vla_tpu_torch.eval.caching import (ActionCachePolicy,
                                                 VisionCacheDeerPolicy,
                                                 VisionCacheScanPolicy)
    counters = kernel_counters()
    n = len(scan.exits)
    scan.set_thresholds([SWEEP[3]] * n)
    deer.controller.set_threshold_values([SWEEP[3]] * n)
    out = {"phase": "caches", "thresholds": [SWEEP[3]] * n, "vision": {}}
    for name, inner, wrap in (("scan", scan, VisionCacheScanPolicy),
                              ("bucketed", deer, VisionCacheDeerPolicy)):
        cache = wrap(inner, tau=0.05)
        launches = {k: 0 for k in counters}
        exits, ms = [], []
        for t, seed in enumerate(CACHE_FRAMES):
            inputs = make_policy_inputs(np, cfg, 1, seed=500 + seed)
            carry_in = (None if inner.carry is None
                        else tuple(c.clone() for c in inner.carry))
            before = {k: f.launches for k, f in counters.items()}
            cache.set_timestep(t)
            t0 = time.perf_counter()
            act = cache.step(*inputs)
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in serve_launches(counters, before).items():
                launches[k] += v
            exit_layer, carry_out = cache.last_exit_layer, inner.carry
            inner.carry = carry_in
            if name == "scan" and carry_in is not None:
                inner._carry_rows = 1
            ref = inner.step(*inputs)
            check(np.array_equal(act, ref)
                  and inner.last_exit_layer == exit_layer,
                  f"caches {name} step {t}: {act} / {exit_layer} against "
                  f"the uncached {ref} / {inner.last_exit_layer}")
            inner.carry = carry_out
            exits.append(exit_layer)
        misses = len(set(CACHE_FRAMES))
        check(cache.encode_hits == len(CACHE_FRAMES) - misses,
              f"caches {name}: {cache.encode_hits} encode hits")
        check(launches["flash_attention"] == misses * VIT_LAYERS,
              f"caches {name}: K1 ran {launches['flash_attention']} times "
              f"for {misses} encodes")
        out["vision"][name] = {"encode_hits": cache.encode_hits,
                               "steps": cache.steps, "exit_layers": exits,
                               "step_ms": ms, "launches": launches}
    scan.reset()
    cache = ActionCachePolicy(scan, tau=0.03, refresh_every=3)
    acts, exits = [], []
    for t, seed in enumerate(ACTION_CACHE_FRAMES):
        cache.set_timestep(t)
        acts.append(cache.step(*make_policy_inputs(np, cfg, 1,
                                                   seed=500 + seed)))
        exits.append(cache.last_exit_layer)
    hits = [e == -1 for e in exits]
    frames = ACTION_CACHE_FRAMES
    refreshes = sum(not h and t > 0 and frames[t] == frames[t - 1]
                    for t, h in enumerate(hits))
    check(hits == [False, True, True, False, False, True] and refreshes == 1
          and cache.hits == 3 and cache.steps == 6
          and np.array_equal(acts[1], acts[0])
          and np.array_equal(acts[5], acts[4]),
          f"action cache: exits {exits}, {cache.hits} hits")
    out["action"] = {"hits": cache.hits, "steps": cache.steps,
                     "refreshes": refreshes, "exit_layers": exits}
    out["launches"] = {k: sum(v["launches"][k] for v in out["vision"].values())
                       for k in counters}
    emit(out)
    return out


def phase_batched_bucketed(torch, np, cfg, params, scan_plain) -> dict:
    """``BatchedDeerPolicy`` at B=8 (one shared threshold, SWEEP[3], at
    every exit), 4 steps, against ``scan_plain.step_batch`` on the same
    inputs from the same (zero) carry: the same exits per stream, actions
    within BUCKETED_TOL; the kernel counts are those of the batched steps
    (K1 in its encode, no K2-K4)."""
    from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
    n = len(scan_plain.exits)
    bp = BatchedDeerPolicy(params, cfg, batch=8,
                           thresholds=[SWEEP[3]] * (n - 1) + [1e8])
    scan_plain.set_thresholds([SWEEP[3]] * n)
    scan_plain.reset()
    counters = kernel_counters()
    launches = {k: 0 for k in counters}
    ms, exits, err = [], [], 0.0
    for s in range(4):
        inputs = make_policy_inputs(np, cfg, 8, seed=200 + s)
        before = {k: f.launches for k, f in counters.items()}
        t0 = time.perf_counter()
        acts, ex = bp.step(*inputs)
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in serve_launches(counters, before).items():
            launches[k] += v
        ref, ex_ref = scan_plain.step_batch(*inputs)
        check(np.array_equal(ex, ex_ref),
              f"batched_bucketed step {s}: exits {ex} against {ex_ref}")
        err = max(err, float(np.abs(acts - ref).max()))
        exits.append(ex.tolist())
    check(err <= BUCKETED_TOL["arm_max_abs"],
          f"batched_bucketed: actions differ by {err}")
    check(launches["flash_attention"] > 0
          and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
          f"batched_bucketed: K1 must run and K2-K4 not: {launches}")
    out = {"phase": "batched_bucketed", "batch": 8, "threshold": SWEEP[3],
           "exit_layers": exits, "b8_step_ms": ms,
           "b8_median_ms": statistics.median(ms),
           "vs_scan_arm_max_abs": err, "tolerance": BUCKETED_TOL,
           "launches": launches}
    emit(out)
    return out


def train_inputs(torch, cfg, device):
    """One DebugBatcher batch (1 trajectory of cfg's window) as the train
    step takes it on ``device``, no random shift, and fixed layer draws
    (sampling 1 the exits in turn, sampling 2 the last exit)."""
    from deer_vla_tpu_torch.train.trainer import TrainConfig, prepare_batch
    cfg, batches = calib_debug_batches(cfg, 1, 1)
    batch = prepare_batch(batches[0], cfg, None,
                          TrainConfig(rgb_pad=0, gripper_pad=0), device)
    exits = cfg.all_exit_ids()
    w = cfg.window_size
    draws = {"rand_layer_ids": torch.tensor([[exits[i % len(exits)]
                                              for i in range(w)]]),
             "switch_layer_ids": torch.full((1, w), exits[-1])}
    return cfg, batch, draws


def train_step_parts(torch, params, cfg, batch, draws, snapshot: bool):
    """One joint-phase step of ``make_train_step``, its gradients read where
    the step hands them to the update: (loss, {key: grad}, {key: param
    after the update}, and with ``snapshot`` {key: param before it}), all
    on the CPU in fp32."""
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.train.optimizer import (flat_leaves,
                                                    make_optimizer)
    from deer_vla_tpu_torch.train.train_step import (init_train_state,
                                                     make_train_step)
    opt = make_optimizer(params, cfg, phase="joint", learning_rate=1e-4,
                         warmup_steps=0, total_steps=1,
                         trainable=trainable_mask(params, cfg, "joint"))
    keys = opt.trainable_keys()
    flat = flat_leaves(params)
    before = ({k: flat[k].detach().float().cpu().clone() for k in keys}
              if snapshot else None)
    grads = {}

    def keep(step_grads, loss, metrics):
        grads.update({k: g.float().cpu() for k, g in step_grads.items()})

    with on_update(keep):
        _, metrics = make_train_step(cfg, opt)(
            init_train_state(params, opt), batch, draws=[draws])
    return (float(metrics["loss"]), grads,
            {k: flat[k].float().cpu() for k in keys}, before)


def phase_train_cross_check(torch, np, params, cpu_params) -> None:
    """deer_3b at W=2, one trajectory: a joint-phase train step in fp32 on
    the card against fp32 on the CPU (the same weights, batch and layer
    draws; no dropout): the loss, every trainable gradient and every
    updated param."""
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    cfg2 = deer_3b(window_size=CALIB_CROSS_WINDOW, dtypes=FP32)
    cfg2, batch, draws = train_inputs(torch, cfg2, torch.device("cuda"))
    card = train_step_parts(torch, params, cfg2, batch, draws, True)
    t0 = time.perf_counter()
    cpu = train_step_parts(torch, cpu_params, cfg2,
                           {k: v.cpu() for k, v in batch.items()}, draws,
                           False)
    cpu_s = time.perf_counter() - t0

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())),
                           1e-30))

    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_rel = {k: rel_l2(g, cpu[1][k]) for k, g in card[1].items()}
    worst_param, param_rel = 0.0, {}
    for k, p in card[2].items():
        want, before = cpu[2][k], card[3][k]
        err = float(torch.linalg.vector_norm((p - want).double()))
        scale = (TRAIN_TOL_FP32["param_rel_l2"]
                 * float(torch.linalg.vector_norm(want.double()))
                 + TRAIN_TOL_FP32["grad_rel_l2"]
                 * float(torch.linalg.vector_norm((want - before).double())))
        worst_param = max(worst_param, err / max(scale, 1e-30))
        param_rel[k] = err / max(
            float(torch.linalg.vector_norm(want.double())), 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    moved = sum(not torch.equal(p, card[3][k]) for k, p in card[2].items())
    emit({"phase": "train_cross_check", "config": "deer_3b W=2 B=1 fp32",
          "loss": {"card": card[0], "cpu": cpu[0], "rel": loss_rel},
          "grad_leaves": len(grad_rel), "grad_worst": [worst,
                                                       grad_rel[worst]],
          "param_err_over_bound": worst_param,
          "param_worst_rel_l2": max(param_rel.items(), key=lambda kv: kv[1]),
          "params_moved": moved,
          "tol_fp32": TRAIN_TOL_FP32, "cpu_seconds": cpu_s})
    check(np.isfinite(card[0]) and loss_rel <= TRAIN_TOL_FP32["loss_rel"],
          f"train cross-check: loss {card[0]} vs {cpu[0]}")
    check(grad_rel[worst] <= TRAIN_TOL_FP32["grad_rel_l2"],
          f"train cross-check: grad {worst} rel {grad_rel[worst]}")
    check(worst_param <= 1.0, f"train cross-check: params {worst_param}")
    check(moved > 0, "train cross-check: no param moved")


def phase_train_guard(torch, params) -> None:
    """``--unfreeze_vit`` on the card: a train step must raise the kernel
    guard's error (K1 has no backward), nothing else."""
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.train.optimizer import make_optimizer
    from deer_vla_tpu_torch.train.train_step import (TrainState,
                                                     make_train_step)
    cfg2 = dataclasses.replace(deer_3b(window_size=CALIB_CROSS_WINDOW,
                                       dtypes=FP32), unfreeze_vit=True)
    cfg2, batch, draws = train_inputs(torch, cfg2, torch.device("cuda"))
    opt = make_optimizer(params, cfg2, phase="joint", learning_rate=1e-4,
                         warmup_steps=0, total_steps=1,
                         trainable=trainable_mask(params, cfg2, "joint"))
    check(any(k.startswith("vit/") for k in opt.trainable_keys()),
          "train guard: the ViT is not trainable")
    step = make_train_step(cfg2, opt)
    want = "flash_attention: an input requires grad"
    try:
        step(TrainState(params, {}, 0), batch, draws=[draws])
    except RuntimeError as err:
        check(str(err).startswith(want), f"train guard: raised {err!r}")
        emit({"phase": "train_guard", "raised": str(err)})
    else:
        check(False, "train guard: the step trained the ViT on the card")
    check(not any(t.requires_grad for t in params["vit"]["blocks"][0]
                  ["qkv"].values()), "train guard: grads left switched on")


@contextlib.contextmanager
def on_update(hook):
    """While open, calls ``hook(grads, loss, metrics)`` after each optimizer
    update of ``make_train_step``'s step (``metrics`` the update's own)."""
    from deer_vla_tpu_torch.train import train_step
    real = train_step._apply_update

    def wrapped(optimizer, state, grads, loss, metrics):
        out = real(optimizer, state, grads, loss, metrics)
        hook(grads, loss, out[1])
        return out

    train_step._apply_update = wrapped
    try:
        yield
    finally:
        train_step._apply_update = real


def train_updates(steps: list):
    """A context that records each optimizer update of the train step: when
    it ended (synchronised), the phase's trainable keys, which leaves got a
    nonzero gradient and which one above Adam's eps, the loss.  The
    bookkeeping's own time is recorded apart."""
    from deer_vla_tpu_torch.train.optimizer import EPS
    import torch

    def record(grads, loss, metrics):
        torch.cuda.synchronize()
        t = time.perf_counter()
        peak = torch.stack([g.abs().amax().float() for g in grads.values()])
        peak = dict(zip(grads, peak.cpu().tolist()))
        steps.append({"t": t, "keys": set(grads),
                      "nonzero": {k for k, v in peak.items() if v > 0},
                      "above_eps": {k for k, v in peak.items() if v > EPS},
                      "loss": float(loss),
                      "grad_norm": float(metrics["grad_norm"]),
                      "bookkeeping_s": time.perf_counter() - t})

    return on_update(record)


def phase_train(torch, np) -> dict:
    """``cli/train.main`` in-process on the card: deer_3b (bf16, fp32
    masters of the trainable leaves, bf16 frozen leaves), 1 joint and 1
    exit-only epoch of 4 DebugBatcher batches of 6 trajectories, W=12.
    Checks every loss is finite, K1 ran 24 times a step and K2-K4 never,
    the frozen leaves are bit for bit a fresh draw of the seed (the
    backbone an evaluation rebuilds), every joint-trainable leaf with a
    gradient moved in the joint phase (deer_0.ckpt against the fresh
    draw), and the exit-only phase moved head leaves only (the final
    params against deer_0.ckpt).  "With a gradient" is a gradient above
    Adam's eps (1e-8) in some step: Adam scales a smaller one down by
    |g| / (|g| + eps), and the update can round away on a leaf near 1
    (a LayerNorm scale).  With the init's x-attn gates at 0 and step 0's
    lr at 0, the x-attn internals see their first gradients in step 2 of
    the joint phase."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    from deer_vla_tpu_torch.models.flamingo import (cast_frozen_to_bf16,
                                                    init_deer,
                                                    trainable_mask)
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train.checkpoint import load_checkpoint
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    held_gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer = cli.main(TRAIN_ARGV)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "cli_train.log").write_text(buf.getvalue())
    cfg = trainer.cfg
    check(len(steps) == TRAIN_STEPS, f"train: {len(steps)} steps")
    check(all(np.isfinite(s["loss"]) for s in steps),
          f"train: losses {[s['loss'] for s in steps]}")
    check(launches["flash_attention"] == VIT_LAYERS * TRAIN_STEPS,
          f"train: K1 launched {launches['flash_attention']} times")
    check(all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"train: K2-K4 launched: {launches}")

    with torch.no_grad():
        fresh = init_deer(cfg, seed=trainer.tcfg.seed, device="cuda")
        fresh = cast_frozen_to_bf16(fresh, trainable_mask(fresh, cfg,
                                                          "joint"))
    final = flat_leaves(trainer.params)
    start = flat_leaves(fresh)
    joint_end = flat_leaves(load_checkpoint(
        str(TRAIN_DIR / "deer_0.ckpt"), trainer.params)[0])
    joint_mask = {flat_key(p): m for p, m in tree_leaves_with_path(
        trainable_mask(fresh, cfg, "joint"))}
    frozen_changed = [k for k, m in joint_mask.items()
                      if not m and not torch.equal(final[k], start[k])]
    check(not frozen_changed, f"train: frozen leaves changed: "
                              f"{frozen_changed[:5]}")
    joint_steps, exit_steps = steps[:TRAIN_STEPS // 2], steps[TRAIN_STEPS // 2:]
    joint_grad = set().union(*(s["above_eps"] for s in joint_steps))
    joint_nonzero = set().union(*(s["nonzero"] for s in joint_steps))
    joint_keys = joint_steps[0]["keys"]
    unmoved = [k for k in joint_grad
               if torch.equal(joint_end[k], start[k])]
    check(not unmoved, f"train: joint leaves with a gradient did not "
                       f"move: {unmoved[:5]}")
    exit_keys = exit_steps[0]["keys"]
    heads = {"lm_head", "extra_exit", "lm_exits"}
    check(all(k.split("/")[0] in heads for k in exit_keys),
          "train: the exit-only phase trains non-head leaves")
    exit_grad = set().union(*(s["above_eps"] for s in exit_steps))
    exit_nonzero = set().union(*(s["nonzero"] for s in exit_steps))
    moved_in_exit = {k for k in final if not torch.equal(final[k],
                                                         joint_end[k])}
    check(moved_in_exit <= exit_keys and exit_grad <= moved_in_exit,
          f"train: exit-only moved {sorted(moved_in_exit - exit_keys)[:5]}, "
          f"left {sorted(exit_grad - moved_in_exit)[:5]}")
    secs = step_intervals(steps)
    files = {f.name: f.stat().st_size for f in sorted(TRAIN_DIR.iterdir())}
    out = {"phase": "train", "argv": TRAIN_ARGV, "seconds": seconds,
           "steps": len(steps), "losses": [s["loss"] for s in steps],
           "grad_norms": [s["grad_norm"] for s in steps],
           # warm medians: a phase's first step is not in its list
           "joint_step_s_median": statistics.median(secs[:3]),
           "exit_step_s_median": statistics.median(secs[4:]),
           "step_s": secs, "peak_memory_gb": peak_gb,
           "allocated_before_gb": held_gb,
           "trainable_joint": len(joint_keys),
           "joint_no_gradient": len(joint_keys - joint_nonzero),
           "joint_gradient_below_eps": len(joint_nonzero - joint_grad),
           "joint_below_eps_unmoved": sum(
               torch.equal(joint_end[k], start[k])
               for k in joint_nonzero - joint_grad),
           "trainable_exit_only": len(exit_keys),
           "exit_no_gradient": len(exit_keys - exit_nonzero),
           "exit_gradient_below_eps": len(exit_nonzero - exit_grad),
           "frozen_leaves": sum(not m for m in joint_mask.values()),
           "checkpoint_files": files, "launches": launches}
    emit(out)
    del trainer, fresh, final, start, joint_end
    torch.cuda.empty_cache()
    return out


def phase_train_eval(torch, np) -> dict:
    """``cli/eval --evaluate_from_checkpoint`` on the training run's last
    checkpoint, in-process on the card: the delta overlays the rebuilt
    backbone (every stored leaf consumed), then calibration and 2 DebugEnv
    rollout sequences with K1 and K2 counted; then the same with
    ``--layerwise_exit_eval`` (each exit's own trained head, on the
    host-bucketed engine: ``phase_rollout``'s checks)."""
    import io
    import warnings
    from deer_vla_tpu_torch.cli import eval as cli
    ckpt = str(TRAIN_DIR / "deer_1.ckpt")
    argv = ["--debug", "--model", "deer_3b", "--evaluate_from_checkpoint",
            ckpt, "--calib_batches", "2", "--num_sequences_override", "2",
            "--ep_len", "40", "--exit_ratio", "0.5"]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(buf):
        warnings.simplefilter("always")
        report = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    text = buf.getvalue()
    (OUT_DIR / "cli_eval_from_checkpoint.log").write_text(text)
    loaded = re.search(r"loaded (\d+) param groups from ckpt", text)
    unmatched = [str(w.message) for w in caught
                 if "not matched" in str(w.message)]
    check(loaded and int(loaded.group(1)) > 0,
          "train_eval: no leaf loaded from the checkpoint")
    check(not unmatched, f"train_eval: unconsumed keys: {unmatched}")
    check(launches["flash_attention"] > 0 and launches["indexed_matmul"] > 0,
          f"train_eval: K1 / K2 not launched: {launches}")
    out = {"phase": "train_eval", "argv": argv, "seconds": seconds,
           "loaded_keys": int(loaded.group(1)), "unconsumed_keys": 0,
           "avg_seq_len": report["avg_seq_len"],
           "avg_exit_layer": report["avg_exit_layer"],
           "exit_hist": report["exit_hist"], "launches": launches}
    emit(out)
    layerwise = phase_rollout(torch, np, "train_eval_layerwise",
                              argv + ["--layerwise_exit_eval"])
    out["runs"] = {"layerwise": layerwise}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the CALVIN phases
# ---------------------------------------------------------------------------


def read_ms(fn, reps: int = 10) -> float:
    """Host milliseconds of one ``fn()`` call, mean of ``reps`` after one."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


@contextlib.contextmanager
def numpy_reader():
    """While open, the datasets read their windows with ``np.load``: the
    native library is set aside as a failed build would leave it."""
    from deer_vla_tpu_torch.data import native_loader
    kept = native_loader._lib, native_loader._error
    native_loader._lib, native_loader._error = None, "set aside to time np.load"
    try:
        yield
    finally:
        native_loader._lib, native_loader._error = kept


def loader_batches_per_s(batches: int) -> float:
    """Batches a second of ``CalvinLoader`` over the training split at
    cli/train's defaults (B=6, W=12, 4 loader threads, prefetch 3), after
    its first batch."""
    from deer_vla_tpu_torch.data.calvin import (CalvinDataConfig,
                                                CalvinLoader,
                                                DiskCalvinDataset)
    from deer_vla_tpu_torch.data.text import HashTokenizer
    ds = DiskCalvinDataset(CalvinDataConfig(
        dataset_dir=str(CALVIN_DIR / "training"), window_size=12),
        validation=False)
    it = iter(CalvinLoader(ds, HashTokenizer(max_length=32), TRAIN_BATCH,
                           workers=4))
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    rate = batches / (time.perf_counter() - t0)
    it.close()
    return rate


def phase_calvin_data(np) -> dict:
    """Writes the CALVIN-format tree, holds the native reader against
    ``np.load`` bit for bit on a STORED and a DEFLATE window of 12 frames
    (CALVIN's five keys), times a window's read both ways (the dataset's
    four keys) and the loader's batches a second with either reader."""
    from deer_vla_tpu_torch.data import native_loader
    from deer_vla_tpu_torch.data.calvin import DiskCalvinDataset
    from deer_vla_tpu_torch.data.debug_data import make_synthetic_calvin
    shutil.rmtree(CALVIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    split_bytes = {}
    for i, (split, (n, ep_len)) in enumerate(CALVIN_SPLITS.items()):
        d = make_synthetic_calvin(str(CALVIN_DIR), n_episodes=n,
                                  ep_len=ep_len, img_hw=200, grip_hw=84,
                                  split=split, seed=SEED + i,
                                  compressed_episodes=set(range(1, n, 2)))
        split_bytes[split] = sum(f.stat().st_size
                                 for f in Path(d).glob("episode_*.npz"))
    write_s = time.perf_counter() - t0
    native_loader.reset_counts()
    t0 = time.perf_counter()
    status = native_loader.status()  # builds the reader
    build_s = time.perf_counter() - t0
    check(status["available"],
          f"calvin_data: the native reader did not build: {status['error']}")
    train = CALVIN_DIR / "training"
    ep_len = CALVIN_SPLITS["training"][1]
    windows = {"stored": range(0, 12), "deflate": range(ep_len, ep_len + 12)}
    keys = DiskCalvinDataset.EPISODE_KEYS
    reads = {}
    for kind, frames in windows.items():
        paths = [str(train / f"episode_{i:07d}.npz") for i in frames]
        got = native_loader.read_window_keys(paths, CALVIN_KEYS)
        check(got is not None, f"calvin_data: no native read of {kind}")
        loaded = [np.load(p) for p in paths]
        for k in CALVIN_KEYS:
            want = np.stack([f[k] for f in loaded])
            check(got[k].dtype == want.dtype and np.array_equal(got[k], want),
                  f"calvin_data: {kind} {k} differs from np.load")

        def numpy_window():
            fs = [np.load(p) for p in paths]
            return {k: np.stack([f[k] for f in fs]) for k in keys}

        reads[kind] = {
            "native_ms": read_ms(lambda: native_loader.read_window_keys(
                paths, keys)),
            "numpy_ms": read_ms(numpy_window)}
        reads[kind]["speedup"] = (reads[kind]["numpy_ms"]
                                  / reads[kind]["native_ms"])
    native_loader.reset_counts()
    rates = {"native": loader_batches_per_s(8)}
    with numpy_reader():
        rates["numpy"] = loader_batches_per_s(8)
    rates["native_again"] = loader_batches_per_s(8)
    served = native_loader.status()
    check(served["native_windows"] > 0 and served["numpy_windows"] > 0,
          f"calvin_data: windows served {served}")
    out = {"phase": "calvin_data", "root": str(CALVIN_DIR),
           "splits": {k: {"episodes": n, "frames_each": e,
                          "bytes": split_bytes[k],
                          "compressed_episodes": list(range(1, n, 2))}
                      for k, (n, e) in CALVIN_SPLITS.items()},
           "write_s": write_s, "reader_build_s": build_s,
           "reader_status": status, "window_read": reads,
           "loader_batches_per_s": rates, "loader_reader": served}
    emit(out)
    return out


class TimedLoader:
    """The trainer's loader, with the seconds the step loop waited for each
    batch (the first one includes starting the loader)."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


def run_calvin_training(torch, argv, save_last: bool):
    """cli/train's trainer for ``argv``, built and run on the card as
    ``cli.train.main`` runs it, each optimizer update recorded, the loader
    timed and the kernels and readers counted from 0; no epoch checkpoint
    is written, and with ``save_last`` the last epoch is saved once at the
    end.  Returns (trainer, record)."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    from deer_vla_tpu_torch.data import native_loader
    held_gb = released_gb(torch)
    trainer, _ = cli.build_trainer(argv)
    trainer.tcfg = dataclasses.replace(trainer.tcfg, save_every_epoch=False)
    loader = trainer.loader = TimedLoader(trainer.loader)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    native_loader.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer.train()
    seconds = time.perf_counter() - t0
    record = {"seconds": seconds, "steps": steps,
              "launches": {n: f.launches for n, f in counters.items()},
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "allocated_before_gb": held_gb,
              "loader_waits_s": loader.waits,
              "reader": native_loader.status(), "log": buf.getvalue()}
    if save_last:
        t0 = time.perf_counter()
        path = trainer.save(trainer.tcfg.num_epochs - 1)
        record["checkpoint"] = {"path": path,
                                "seconds": time.perf_counter() - t0,
                                "bytes": Path(path).stat().st_size}
    return trainer, record


def step_intervals(steps: list) -> list:
    """Seconds between consecutive optimizer updates, less the recording's
    own time."""
    ends = [s["t"] for s in steps]
    book = [s["bookkeeping_s"] for s in steps]
    return [ends[i] - ends[i - 1] - book[i - 1] for i in range(1, len(ends))]


def check_training(np, name: str, record: dict, n_steps: int) -> None:
    steps, launches = record["steps"], record["launches"]
    check(len(steps) == n_steps, f"{name}: {len(steps)} steps")
    check(all(np.isfinite(s["loss"]) for s in steps),
          f"{name}: losses {[s['loss'] for s in steps]}")
    check(launches["flash_attention"] == VIT_LAYERS * n_steps,
          f"{name}: K1 launched {launches['flash_attention']} times")
    check(all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"{name}: K2-K4 launched: {launches}")
    check(record["reader"]["native_windows"] > 0
          and record["reader"]["numpy_windows"] == 0,
          f"{name}: windows served {record['reader']}")


def phase_train_calvin(torch, np) -> dict:
    """cli/train on the CALVIN tree (deer_3b, bf16, B=6, W=12, rgb_pad 10,
    gripper_pad 4): 1 joint and 1 exit-only epoch of 4 batches, one
    checkpoint (the last epoch's).  Checks the losses, K1 24 times a step
    and K2-K4 never, every window read natively, the frozen leaves bit for
    bit a fresh draw of the seed, every joint leaf with a gradient above
    Adam's eps moved, and the exit-only phase trained head leaves only."""
    from deer_vla_tpu_torch.models.flamingo import (cast_frozen_to_bf16,
                                                    init_deer,
                                                    trainable_mask)
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    shutil.rmtree(CALVIN_RUN, ignore_errors=True)
    trainer, r = run_calvin_training(torch, CALVIN_TRAIN_ARGV, True)
    (OUT_DIR / "cli_train_calvin.log").write_text(r.pop("log"))
    n = len(trainer.loader)
    check(n == 4, f"train_calvin: {n} batches an epoch")
    check_training(np, "train_calvin", r, 2 * n)
    steps = r.pop("steps")
    cfg = trainer.cfg
    with torch.no_grad():
        fresh = init_deer(cfg, seed=trainer.tcfg.seed, device="cuda")
        fresh = cast_frozen_to_bf16(fresh, trainable_mask(fresh, cfg,
                                                          "joint"))
    final, start = flat_leaves(trainer.params), flat_leaves(fresh)
    joint_mask = {flat_key(p): m for p, m in tree_leaves_with_path(
        trainable_mask(fresh, cfg, "joint"))}
    frozen_changed = [k for k, m in joint_mask.items()
                      if not m and not torch.equal(final[k], start[k])]
    check(not frozen_changed, f"train_calvin: frozen leaves changed: "
                              f"{frozen_changed[:5]}")
    joint_grad = set().union(*(s["above_eps"] for s in steps[:n]))
    unmoved = [k for k in joint_grad if torch.equal(final[k], start[k])]
    check(not unmoved, f"train_calvin: joint leaves with a gradient did "
                       f"not move: {unmoved[:5]}")
    heads = {"lm_head", "extra_exit", "lm_exits"}
    check(all(k.split("/")[0] in heads for k in steps[n]["keys"]),
          "train_calvin: the exit-only phase trains non-head leaves")
    secs = step_intervals(steps)
    waits = r.pop("loader_waits_s")
    out = {"phase": "train_calvin", "argv": CALVIN_TRAIN_ARGV,
           "batches_per_epoch": n, "losses": [s["loss"] for s in steps],
           "grad_norms": [s["grad_norm"] for s in steps],
           # warm medians: a phase's first step is not in its list
           "joint_step_s_median": statistics.median(secs[:n - 1]),
           "exit_step_s_median": statistics.median(secs[n:]),
           "step_s": secs, "loader_wait_s": waits,
           "loader_wait_s_warm_median": statistics.median(waits[1:]),
           "trainable_joint": len(steps[0]["keys"]),
           "joint_with_gradient_above_eps": len(joint_grad), **r}
    emit(out)
    del trainer, fresh, final, start
    torch.cuda.empty_cache()
    return out


def phase_train_calvin_difws(torch, np) -> dict:
    """cli/train --dif_ws at W=24 (288 ViT images a step), 1 joint epoch
    of 5 batches, without remat, with --remat and with --remat_policy dots:
    the same seeds and batches in each.  Checks each run as train_calvin,
    the losses of the remat runs against no remat (``DIFWS_LOSS_REL``) and
    the --remat (full) peak memory below no remat's."""
    runs = {}
    for name, extra in DIFWS_RUNS:
        trainer, r = run_calvin_training(torch, DIFWS_ARGV + extra, False)
        r.pop("log")
        check(trainer.cfg.window_size == 24
              and trainer.loader.loader.ds.cfg.max_window_size == 24
              and trainer.cfg.remat_layers == (name != "none")
              and (name == "none" or trainer.cfg.remat_policy == name),
              f"train_calvin_difws {name}: config {trainer.cfg.remat_policy}")
        check_training(np, f"train_calvin_difws {name}", r, DIFWS_STEPS)
        steps = r.pop("steps")
        secs = step_intervals(steps)
        runs[name] = {"losses": [s["loss"] for s in steps],
                      "step_s": secs, "step_s_median": statistics.median(secs),
                      **r}
        del trainer
        torch.cuda.empty_cache()
    base = runs["none"]
    for name in ("full", "dots"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs[name]["losses"],
                                                      base["losses"]))
        runs[name]["loss_max_rel_vs_none"] = rel
        runs[name]["peak_vs_none"] = (runs[name]["peak_memory_gb"]
                                      / base["peak_memory_gb"])
        check(rel <= DIFWS_LOSS_REL, f"train_calvin_difws {name}: losses "
              f"{runs[name]['losses']} vs {base['losses']}")
    check(runs["full"]["peak_memory_gb"] < base["peak_memory_gb"],
          f"train_calvin_difws: remat peak {runs['full']['peak_memory_gb']} "
          f"GB not below {base['peak_memory_gb']}")
    out = {"phase": "train_calvin_difws", "argv": DIFWS_ARGV,
           "loss_tolerance_rel": DIFWS_LOSS_REL, "runs": runs}
    emit(out)
    return out


def phase_calib_calvin(torch, np) -> dict:
    """cli/eval --calvin_dataset on train_calvin's checkpoint, without
    --debug: 2 validation batches of 6 trajectories (W=12, 144 ViT images
    each through K1), the values sidecar written, then the asserted
    dropped-env SystemExit; then cli/eval --debug on the same
    --value_cache stem, which must serve those values (no calibration)."""
    import io
    from deer_vla_tpu_torch.cli import eval as cli
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.data import native_loader
    from deer_vla_tpu_torch.train.checkpoint import load_calibration_values
    ckpt = str(CALVIN_RUN / "deer_1.ckpt")
    stem = str(CALVIN_DIR / "calvin_values")
    argv = ["--model", "deer_3b", "--calvin_dataset", str(CALVIN_DIR),
            "--evaluate_from_checkpoint", ckpt, "--value_cache", stem,
            "--batch_size_calvin", str(TRAIN_BATCH), "--calib_batches", "2",
            "--exit_ratio", "0.5"]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    native_loader.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    raised = None
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as err:
            raised = str(err)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    reader = native_loader.status()
    text = buf.getvalue()
    (OUT_DIR / "cli_eval_calvin.log").write_text(text + f"\n{raised}\n")
    check(raised == cli.CALVIN_ENV_DROPPED,
          f"calib_calvin: ended with {raised!r}")
    values = load_calibration_values(stem)
    n_exits = len(deer_3b().all_exit_ids())
    check(values is not None and values.shape == (n_exits, 2 * TRAIN_BATCH * 6)
          and bool(np.isfinite(values).all()),
          f"calib_calvin: values {None if values is None else values.shape}")
    check(launches["flash_attention"] == 2 * VIT_LAYERS
          and all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"calib_calvin: launches {launches}")
    check(reader["native_windows"] > 0 and reader["numpy_windows"] == 0,
          f"calib_calvin: windows served {reader}")
    thresholds = text.strip().splitlines()[-1]
    argv2 = ["--debug", "--model", "deer_3b", "--evaluate_from_checkpoint",
             ckpt, "--value_cache", stem, "--num_sequences_override", "2",
             "--ep_len", "40", "--exit_ratio", "0.5"]
    for f in counters.values():
        f.launches = 0
    buf2 = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf2):
        report = cli.main(argv2)
    seconds2 = time.perf_counter() - t0
    launches2 = {n: f.launches for n, f in counters.items()}
    text2 = buf2.getvalue()
    (OUT_DIR / "cli_eval_calvin_values.log").write_text(text2)
    check("reusing calibration values" in text2 and "calibrated" not in text2,
          "calib_calvin: the --debug run did not serve the cached values")
    check(text2.strip().splitlines()[-3] == thresholds,
          f"calib_calvin: thresholds {text2.strip().splitlines()[-3]} vs "
          f"{thresholds}")
    out = {"phase": "calib_calvin", "argv": argv, "seconds": seconds,
           "raised": raised, "values_shape": list(values.shape),
           "values_median": float(np.median(values)),
           "thresholds": thresholds, "launches": launches,
           "loader_reader": reader, "debug_argv": argv2,
           "debug_seconds": seconds2, "debug_launches": launches2,
           "avg_seq_len": report["avg_seq_len"],
           "avg_exit_layer": report["avg_exit_layer"]}
    emit(out)
    shutil.rmtree(CALVIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# deer_9b (MPT-7B, x-attn every 4 layers) and bc_llama, after deer_3b's
# phases have freed their weights
# ---------------------------------------------------------------------------

# the 9B and llama serve phases sweep from -1 (no early exit: full depth)
# to 1e8 (the first exit fires), so both early and full-depth exits occur
# whatever these weights' deltas are
SWEEP_9B = [-1.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1e8]
ROLLOUT_9B_ARGV = ["--debug", "--model", "mpt_9b"] + ROLLOUT_ARGV[3:]
# bc_llama's preset depth (cli/eval cuts every model to 12 layers unless
# --max_layer says otherwise)
LLAMA_DEPTH = 32
ROLLOUT_LLAMA_ARGV = (["--debug", "--model", "llama_9b", "--max_layer",
                       str(LLAMA_DEPTH)] + ROLLOUT_ARGV[3:])


def phase_weights(torch, cfg, name: str):
    """Seeded weights of ``cfg`` on the card, their size and the seconds
    the draw took."""
    from deer_vla_tpu_torch.ops.layers import tree_leaves_with_path
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_weights(torch, cfg)
    torch.cuda.synchronize()
    emit({"phase": name, "seconds": time.perf_counter() - t0, "seed": SEED,
          "held_before_gb": gb, "mpt": [cfg.n_layers, cfg.mpt.d_model,
                                        cfg.mpt.n_heads, cfg.mpt.arch],
          "xattn_layers": [i for i in range(cfg.n_layers)
                           if cfg.has_xattn(i)],
          "exits": list(cfg.all_exit_ids()),
          "params": sum(t.numel() for _, t in tree_leaves_with_path(params)),
          "params_bytes": tree_bytes(params),
          "decoder_blocks_bytes": tree_bytes(params["decoder"]["blocks"]),
          "xattn_bytes": tree_bytes(params["decoder"]["xattn"])})
    return params


def phase_cross_check_plain_quantized(torch, np, cfg, params,
                                      name: str) -> None:
    """int8 and int4 in fp32 on the card: one full-depth step through K3 /
    K4 against the same codes through their plain products (``linear`` on
    each layer's slice), within CROSS_TOL_FP32."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    for mode in ("int8", "int4"):
        steps = []
        for imm in (True, False):
            pol = ScanDeerPolicy(params, cfg32, indexed_mm=imm,
                                 quantize=mode)
            steps.append(full_depth_step(np, pol, cfg32, inputs))
            del pol
            torch.cuda.empty_cache()
        got = compare(np, torch, *steps[0], *steps[1])
        emit({"phase": f"{name}_{mode}", "exit_layer": cfg.n_layers - 1,
              "kernel_fp32_vs_plain_fp32": got, "tol_fp32": CROSS_TOL_FP32})
        for key, limit in CROSS_TOL_FP32.items():
            check(got[key] <= limit, f"{name} {mode} {key} {got[key]}")


def calibrate_launches(calib: dict) -> dict:
    return {name: sum(b[name] for r in calib["regimes"].values()
                      for b in r["launches_per_batch"])
            for name in kernel_counters()}


def drive_9b(torch, np) -> tuple:
    """deer_9b at full width and its preset depth (12 layers, d_model
    4096, exits [3, 7, 11]) from seeded weights: ``ScanDeerPolicy`` with K2
    in every serving mode, ``DeerPolicy`` against the scan engine's plain
    products, a full-depth step against fp32 on the CPU (the weights are
    14.4 GB in fp32; the host has the room), K3 / K4 against their plain
    products, calibration, then ``cli/eval --debug --model mpt_9b``."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.core.config import deer_9b
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    cfg = deer_9b()
    params = phase_weights(torch, cfg, "weights_9b")
    pol = ScanDeerPolicy(params, cfg, indexed_mm=True)
    serve = phase_serve(torch, np, cfg, pol, name="serve_9b",
                        config="deer_9b", sweep=SWEEP_9B)
    quantized = phase_serve_quantized(torch, np, cfg, params,
                                      serve["stacked_bytes"],
                                      config="deer_9b", sweep=SWEEP_9B,
                                      prefix="serve_9b")
    deer = DeerPolicy(params, cfg, controller=ExitController(
        exit_id_list=list(cfg.all_exit_ids()), max_layer=cfg.n_layers))
    scan_plain = ScanDeerPolicy(params, cfg)
    bucketed = phase_serve_bucketed(torch, np, cfg, deer, scan_plain, serve,
                                    name="serve_9b_bucketed",
                                    config="deer_9b", sweep=SWEEP_9B)
    del deer, scan_plain
    torch.cuda.empty_cache()
    cpu_params = to_torch(params, "cpu")
    phase_cross_check(torch, np, cfg, params, cpu_params, pol,
                      name="cross_check_9b")
    del cpu_params, pol
    gc.collect()
    torch.cuda.empty_cache()
    phase_cross_check_plain_quantized(torch, np, cfg, params,
                                      "cross_check_9b")
    calib = phase_calibrate(torch, np, cfg, params, name="calibrate_9b",
                            model="mpt_9b")
    del params
    released_gb(torch)
    rollout = phase_rollout(torch, np, "rollout_9b", ROLLOUT_9B_ARGV)
    return ([serve, bucketed, rollout] + list(quantized.values()),
            {"calibrate_9b": calibrate_launches(calib)})


def drive_llama(torch, np) -> list:
    """bc_llama at full width (d_model 4096, 32 heads, SwiGLU 11008) and
    its preset depth of 32 layers: ``ScanDeerPolicy`` (``linear`` on each
    layer's slice: none of K2-K4, K1 24 times a step) in bf16 and int8 at
    B=1 / B=8, a full-depth bf16 step against fp32 on the card, then
    ``cli/eval --debug --model llama_9b`` at the same depth."""
    from deer_vla_tpu_torch.core.config import FP32, bc_llama
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg = bc_llama(n_layers=LLAMA_DEPTH)
    # the preset keeps MPT's media token id (50277), outside llama's 32000
    # ids: take the debug tokenizer's, as cli/eval does
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    params = phase_weights(torch, cfg, "weights_llama")
    pol = ScanDeerPolicy(params, cfg)
    serve = phase_serve(torch, np, cfg, pol, name="serve_llama",
                        config="bc_llama", sweep=SWEEP_9B)
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    act_bf16, hid_bf16 = full_depth_step(np, pol, cfg, inputs)
    del pol
    torch.cuda.empty_cache()
    quantized = phase_serve_quantized(torch, np, cfg, params,
                                      serve["stacked_bytes"],
                                      modes=(("int8", 8),),
                                      config="bc_llama", sweep=SWEEP_9B,
                                      prefix="serve_llama")
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32)
    act32, hid32 = full_depth_step(np, card32, cfg32, inputs)
    del card32, params
    got = compare(np, torch, act_bf16, hid_bf16, act32, hid32)
    emit({"phase": "cross_check_llama", "exit_layer": cfg.n_layers - 1,
          "card_bf16_vs_card_fp32": got, "tol_bf16": CROSS_TOL_BF16,
          "fp32": "the plain fp32 path on the card (cuBLAS products, K1's "
                  "fp32 path in the ViT)",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for key, limit in CROSS_TOL_BF16.items():
        check(got[key] <= limit, f"cross_check_llama {key} {got[key]}")
    released_gb(torch)
    rollout = phase_rollout(torch, np, "rollout_llama", ROLLOUT_LLAMA_ARGV)
    return [serve, rollout] + list(quantized.values())


def tome_rows(rows: list) -> list:
    """K1 at the ToMe shapes, one entry a query length."""
    return [{"sq": r["shape"][2], "ms": r["kernel_ms"],
             "plain_ms": r["reference_ms"], "library_ms": r["library_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "max_abs_err": r["max_abs_err"]} for r in rows]


def kernels_line(summary: dict, launches: dict, tc: dict,
                 path_launches: dict) -> dict:
    """``launches`` maps each kernel to its count on the serve path that
    runs it: K1 and K2 on the bf16 serve, K3 on int8's, K4 on int4's (and
    ``<name>_9b`` on deer_9b's); ``path_launches`` holds every kernel's
    count on the calibration, rollout, training, 9B and llama paths, by
    path."""
    k1 = summary["flash_attention"]
    out = [{"name": "flash_attention", "route": "cuda",
            "source": "deer_vla_tpu_torch/csrc/flash_attention.cu",
            "replaces": "deer_vla_tpu/ops/pallas/flash_attention.py:109",
            "launches": launches["flash_attention"],
            "max_abs_err": k1["max_abs_err"], "tolerance": k1["tolerance"],
            "ms": k1["kernel_ms"], "plain_ms": k1["reference_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": k1["library_ms"], "bytes": k1["bytes"],
            "flops": k1["flops"],
            "b8_ms": summary["flash_attention_b8"]["kernel_ms"],
            "b8_library_ms": summary["flash_attention_b8"]["library_ms"],
            "calib_ms": summary["flash_attention_calib"]["kernel_ms"],
            "calib_plain_ms": summary["flash_attention_calib"]["reference_ms"],
            "calib_library_ms": summary["flash_attention_calib"]["library_ms"],
            "calib_bound_ms": summary["flash_attention_calib"]["bound_ms"],
            "calib_shape": "q,k,v (48,16,257,64) bf16 strided views of a "
                           "fused qkv (ViT layer of a calibration batch)",
            "train_ms": summary["flash_attention_train"]["kernel_ms"],
            "train_plain_ms": summary["flash_attention_train"]["reference_ms"],
            "train_library_ms": summary["flash_attention_train"]["library_ms"],
            "train_bound_ms": summary["flash_attention_train"]["bound_ms"],
            "train_max_abs_err":
                summary["flash_attention_train"]["max_abs_err"],
            "train_shape": "q,k,v (144,16,257,64) bf16 strided views of a "
                           "fused qkv (ViT layer of a training batch)",
            "difws_ms": summary["flash_attention_difws"]["kernel_ms"],
            "difws_plain_ms": summary["flash_attention_difws"]["reference_ms"],
            "difws_library_ms": summary["flash_attention_difws"]["library_ms"],
            "difws_bound_ms": summary["flash_attention_difws"]["bound_ms"],
            "difws_max_abs_err":
                summary["flash_attention_difws"]["max_abs_err"],
            "difws_shape": "q,k,v (288,16,257,64) bf16 strided views of a "
                           "fused qkv (ViT layer of a --dif_ws W=24 batch)",
            "folded_ms": summary["flash_attention_folded"]["kernel_ms"],
            "folded_plain_ms":
                summary["flash_attention_folded"]["reference_ms"],
            "folded_library_ms":
                summary["flash_attention_folded"]["library_ms"],
            "folded_bound_ms": summary["flash_attention_folded"]["bound_ms"],
            "folded_b8_ms": summary["flash_attention_folded_b8"]["kernel_ms"],
            "folded_b8_plain_ms":
                summary["flash_attention_folded_b8"]["reference_ms"],
            "folded_b8_library_ms":
                summary["flash_attention_folded_b8"]["library_ms"],
            "folded_b8_bound_ms":
                summary["flash_attention_folded_b8"]["bound_ms"],
            "folded_shape": "q,k,v (24 | 192,16,257,64) bf16 strided views "
                            "(ViT layer of a W=12 window-folded step, B=1 "
                            "| B=8, uncached)",
            "tensor_core_sass": tc["flash_attention"]["hmma_hgmma"],
            "shape": "q,k,v (2,16,257,64) bf16, no bias (ViT layer, B=1)",
            "tome_shape": f"ToMe r={TOME_R}: q,k,v (2B,16,Sq,64) bf16 "
                          "strided, Sk = Sq, bias (2B,1,Sq,Sq) fp32 "
                          "(stride 0 along Sq), B=1 and a calibration "
                          "batch (B=24)",
            "tome_b1": tome_rows(summary["flash_attention_tome"]),
            "tome_calib": tome_rows(summary["flash_attention_tome_calib"])}]
    for name, source, line, weights, library in (
            ("indexed_matmul", "indexed_matmul.cu", 289,
             "W (12, K, N) bf16", "x @ W[i]"),
            ("indexed_matmul_q8", "indexed_matmul_quant.cu", 153,
             "Wq (12, K, N) int8, s (12, N) fp32",
             "x @ Wd[i], Wd dequantized to bf16 beforehand"),
            ("indexed_matmul_q4", "indexed_matmul_quant.cu", 258,
             "Wq4 (12, K/2, N) packed int4, s (12, N) fp32",
             "x @ Wd[i], Wd dequantized to bf16 beforehand")):
        k = summary[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"deer_vla_tpu_torch/csrc/{source}",
            "replaces": f"deer_vla_tpu/ops/pallas/indexed_matmul.py:{line}",
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library": library,
            "bytes": k["bytes"], "flops": k["flops"],
            "shape": f"one decoder layer's four products, x (32, K) bf16, "
                     f"{weights}, B=1"})
    for tag in ("hist", "hist_b8"):
        k = summary["indexed_matmul_" + tag]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err"):
            out[1][f"{key}_{tag}"] = k[key]
    out[1]["shape_hist"] = ("one decoder layer's four products, x (384 | "
                            "3072, K) bf16: use_hist's W=12 text rows a "
                            "stream, B=1 | B=8")
    for row in out[1:]:
        b8 = summary[row["name"] + "_b8"]
        row["b8_ms"] = b8["ms"]
        row["b8_library_ms"] = b8["library_ms"]
        row["b8_bound_ms"] = b8["bound_ms"]
        row["tensor_core_sass"] = tc[row["name"]]["hmma_hgmma"]
        row["conversion_sass"] = tc[row["name"]]["conversions"]
        for tag in ("9b", "9b_b8"):
            k = summary[row["name"] + "_" + tag]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "max_abs_err"):
                row[f"{key}_{tag}"] = k[key]
        row["launches_9b"] = launches[row["name"] + "_9b"]
        row["shape_9b"] = ("one deer_9b decoder layer's four products, x "
                           "(32 | 256, K) bf16, K x N in (4096, 12288), "
                           "(4096, 4096), (4096, 16384), (16384, 4096), "
                           "L = 12, B=1 | B=8")
    for row in out:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in path_launches.items()}
    return {"kernels": out}


# ---------------------------------------------------------------------------
# the vision, state and window variants (deer_3b at full width)
# ---------------------------------------------------------------------------

# name -> DeerConfig changes ("k": head.multi_step_action; use_state sets
# the head's too, as cli/train's one flag does)
SERVE_VARIANTS = (("use_state", {"use_state": True}),
                  ("pre", {"fusion_mode": "pre"}),
                  ("two_way", {"fusion_mode": "two_way"}),
                  ("sep_resampler", {"sep_resampler": True}),
                  ("gripper_res84", {"gripper_res": 84}),
                  ("multi_step3", {"k": 3}))
FOLDED_VARIANTS = (("vit_concat", {"fusion_mode": "vit_concat"}),
                   ("use_hist", {"use_hist": True}))
CROSS_VARIANTS = (("vit_concat_use_state", {"fusion_mode": "vit_concat",
                                            "use_state": True}),
                  ("gripper_res84", {"gripper_res": 84}))
# the frame cache against the uncached step: the same per-frame tokens go
# into the same fuse and decode, so the exits must be equal and the arm
# actions within 2e-4 relative L2 (both in bf16 on the card)
FOLDED_STEPS = 15
FOLDED_REL_L2 = 2e-4
VARIANT_TRAIN_DIR = REPO / "build" / "chip_smoke_variants"
VARIANT_TRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--use_state",
                      "--fusion_mode", "vit_concat", "--batch_size_calvin",
                      str(TRAIN_BATCH), "--num_joint_epochs", "1",
                      "--num_exit_epochs", "0", "--joint_warmup_steps", "1",
                      "--logging_steps", "1", "--from_scratch",
                      "--run_name", str(VARIANT_TRAIN_DIR)]


def variant_config(cfg, changes: dict):
    """``cfg`` with a variant's changes."""
    changes = dict(changes)
    head = {}
    if changes.get("use_state"):
        head["use_state"] = True
    if "k" in changes:
        head["multi_step_action"] = changes.pop("k")
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, **head), **changes)


def variant_weights(torch, base: dict, cfg) -> dict:
    """The variant's tree on the base draw: its second resampler, state
    projection or frame embeddings (``init_variant_leaves``), and heads of
    its own when their widths or state embedding differ, drawn on the card
    from SEED + 2; every other leaf is the base's."""
    from deer_vla_tpu_torch.models.action_head import init_head
    from deer_vla_tpu_torch.models.flamingo import init_variant_leaves
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    pdt = cfg.dtypes.pdt
    p = dict(base)
    if cfg.head.use_state or cfg.head.multi_step_action != 1:
        for key in ("lm_head", "extra_exit"):
            p[key] = init_head(gen, cfg.head, "cuda", pdt)
        p["lm_exits"] = {k: init_head(gen, cfg.head, "cuda", pdt)
                         for k in base["lm_exits"]}
    p.update(init_variant_leaves(gen, cfg, "cuda", pdt))
    return p


def variant_inputs(np, cfg):
    """``inputs(b, seed)`` for ``phase_serve``: b streams' frames (W a
    stream, stream-major, for the window-folded variants; the gripper at
    ``gripper_res``), text (a row a frame under use_hist) and, for a state
    model, proprio rows a frame (the gripper entry at +-1)."""
    from deer_vla_tpu_torch.eval.scan_policy import folded_window
    w = folded_window(cfg)

    def inputs(b, seed):
        r = np.random.RandomState(seed)
        hw = cfg.vit.image_size
        ghw = cfg.gripper_res or hw
        img = r.randn(b * w, 1, 1, 3, hw, hw).astype(np.float32)
        grip = r.randn(b * w, 1, 1, 3, ghw, ghw).astype(np.float32)
        _, _, ids, mask = make_policy_inputs(np, cfg, b, seed)
        if cfg.use_hist:
            ids, mask = (np.repeat(a, w, axis=0) for a in (ids, mask))
        kw = {}
        if cfg.use_state:
            st = r.randn(b * w, 1, 1, cfg.state_dim).astype(np.float32)
            st[..., -1] = np.where(st[..., -1] > 0, 1.0, -1.0)
            kw["state"] = st
        return (img, grip, ids, mask), kw

    return inputs


def phase_serve_variants(torch, np, cfg, base: dict, serve: dict) -> list:
    """Each of SERVE_VARIANTS through ``ScanDeerPolicy`` with K1 and K2: 8
    B=1 and 4 B=8 steps (``phase_serve``: exits among the exit set, finite
    actions, (B, 3, 7) plans for multi_step3), medians beside the post
    model's from phase serve; use_state also in int8 (K3 must replace K2)
    and through ``DeerPolicy``, held against the scan engine with the same
    products (``phase_serve_bucketed``: equal exits)."""
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    results, summary = [], {}
    for name, changes in SERVE_VARIANTS:
        vcfg = variant_config(cfg, changes)
        p = variant_weights(torch, base, vcfg)
        inputs = variant_inputs(np, vcfg)
        modes = [None] + (["int8"] if name == "use_state" else [])
        for mode in modes:
            pol = ScanDeerPolicy(p, vcfg, indexed_mm=True, quantize=mode)
            res = phase_serve(torch, np, vcfg, pol, mode,
                              name=f"serve_{name}" + (f"_{mode}" if mode
                                                      else ""),
                              inputs=inputs)
            results.append(res)
            summary[res["phase"]] = {k: res[k] for k in (
                "b1_median_ms", "b8_median_ms", "b1_exit_layers",
                "launches_per_step")}
            del pol
        if name == "use_state":
            deer = DeerPolicy(p, vcfg, controller=ExitController(
                exit_id_list=list(vcfg.all_exit_ids()),
                max_layer=vcfg.n_layers))
            scan_plain = ScanDeerPolicy(p, vcfg)
            results.append(phase_serve_bucketed(
                torch, np, vcfg, deer, scan_plain, serve,
                name="serve_use_state_bucketed", inputs=inputs))
            del deer, scan_plain
        del p
        torch.cuda.empty_cache()
    emit({"phase": "serve_variants",
          "post": {"b1_median_ms": serve["b1_median_ms"],
                   "b8_median_ms": serve["b8_median_ms"]},
          "variants": summary})
    return results


def phase_cross_check_variants(torch, np, cfg, base: dict,
                               cpu_base: dict) -> None:
    """A full-depth bf16 step of each CROSS_VARIANTS model (and the same
    weights in fp32 on the card) against fp32 on the CPU
    (``phase_cross_check``'s tolerances): vit_concat with state on a
    W-frame window, and the native-size gripper."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    for name, changes in CROSS_VARIANTS:
        vcfg = variant_config(cfg, changes)
        p = variant_weights(torch, base, vcfg)
        cpu_p = dict(cpu_base, **{k: to_torch(v, "cpu") for k, v in p.items()
                                  if v is not base.get(k)})
        pol = ScanDeerPolicy(p, vcfg, indexed_mm=True)
        phase_cross_check(torch, np, vcfg, p, cpu_p, pol,
                          name=f"cross_check_{name}",
                          inputs=variant_inputs(np, vcfg)(1, 300))
        del pol, p, cpu_p
        gc.collect()
        torch.cuda.empty_cache()


def rel_l2(np, a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_serve_folded(torch, np, cfg, base: dict) -> list:
    """vit_concat and use_hist at W=12: B=1 steps over FOLDED_STEPS new
    frames, uncached (the engine re-encodes the rolling window, left padded
    with the first frame) and through ``FrameCachePolicy`` (the newest
    frame only), with equal exits and arm actions within FOLDED_REL_L2 at
    every step; K1 launches and step times of both; then 4 uncached B=8
    steps (``phase_serve``)."""
    import copy
    from deer_vla_tpu_torch.eval.caching import FrameCachePolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    counters = kernel_counters()
    results = []
    for name, changes in FOLDED_VARIANTS:
        vcfg = variant_config(cfg, changes)
        w = vcfg.window_size
        p = variant_weights(torch, base, vcfg)
        pol = ScanDeerPolicy(p, vcfg, indexed_mm=True)
        cached = FrameCachePolicy(copy.copy(pol))
        (img, grip, ids, mask), _ = variant_inputs(np, vcfg)(1, 400)
        r = np.random.RandomState(401)
        hw = vcfg.vit.image_size
        frames_i = r.randn(FOLDED_STEPS, 1, 1, 3, hw, hw).astype(np.float32)
        frames_g = r.randn(FOLDED_STEPS, 1, 1, 3, hw, hw).astype(np.float32)
        runs = {}
        for kind, policy in (("uncached", pol), ("cached", cached)):
            policy.reset()
            for f in counters.values():
                f.launches = 0
            ms, exits, arms = [], [], []
            for t in range(FOLDED_STEPS):
                policy.set_thresholds([SWEEP[t % len(SWEEP)]]
                                      * len(pol.exits))
                rows = [max(0, i) for i in range(t - w + 1, t + 1)]
                fi, fg = ((frames_i[rows], frames_g[rows])
                          if kind == "uncached"
                          else (frames_i[t:t + 1], frames_g[t:t + 1]))
                t0 = time.perf_counter()
                act = policy.step(fi, fg, ids, mask)
                ms.append((time.perf_counter() - t0) * 1e3)
                check(act.shape == (7,) and bool(np.isfinite(act).all()),
                      f"serve_folded {name} {kind} step {t}: {act}")
                exits.append(policy.last_exit_layer)
                arms.append(act[:6])
            runs[kind] = {
                "step_ms": ms, "median_ms": statistics.median(ms[w:]),
                "exit_layers": exits, "arms": arms,
                "launches": {n: f.launches for n, f in counters.items()},
                "k1_per_step": counters["flash_attention"].launches
                / FOLDED_STEPS}
        u, c = runs["uncached"], runs["cached"]
        errs = [rel_l2(np, a, b) for a, b in zip(c.pop("arms"),
                                                 u.pop("arms"))]
        check(c["exit_layers"] == u["exit_layers"],
              f"serve_folded {name}: exits {c['exit_layers']} cached, "
              f"{u['exit_layers']} uncached")
        check(max(errs) <= FOLDED_REL_L2,
              f"serve_folded {name}: arm rel L2 {max(errs)}")
        check(u["launches"]["indexed_matmul"] > 0
              and c["launches"]["indexed_matmul"] > 0
              and c["k1_per_step"] > 0,
              f"serve_folded {name}: kernels not launched: {runs}")
        out = {"phase": f"serve_folded_{name}", "window": w,
               "steps": FOLDED_STEPS, "k1_images_per_step":
                   {"uncached": 2 * w, "cached": 2},
               "cached_vs_uncached_arm_rel_l2": errs,
               "tolerance": FOLDED_REL_L2, "runs": runs,
               "launches": u["launches"]}
        emit(out)
        results.append(out)
        results.append(phase_serve(
            torch, np, vcfg, pol, b1_steps=0, name=f"serve_folded_{name}_b8",
            inputs=variant_inputs(np, vcfg)))
        del pol, cached, p
        torch.cuda.empty_cache()
    return results


def phase_calibrate_variants(torch, np, cfg, base: dict) -> dict:
    """Calibration (B=2, W=12, 2 debug batches with robot_obs) of the
    use_state model in both regimes, and of vit_concat with the warm
    prefix of ``--calib_warm 2``: values finite, of the regime's shape,
    K1 launched a batch."""
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE as bs
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    counters = kernel_counters()
    out = {"phase": "calibrate_variants", "batch_size": bs, "runs": {}}
    for name, changes, regime, warm in (
            ("use_state", {"use_state": True}, "folded", 0),
            ("use_state", {"use_state": True}, "streamed", 0),
            ("vit_concat", {"fusion_mode": "vit_concat"}, "folded", 2)):
        vcfg, batches = calib_debug_batches(variant_config(cfg, changes),
                                            bs, 2)
        p = variant_weights(torch, base, vcfg)
        streamed = regime == "streamed"
        esp = (streamed_sample_probs(vcfg, 1.0, None, "exp", "deer_3b")
               if streamed else None)
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = generate_calibration_values(
            p, vcfg, batches, gen=torch.Generator(device="cuda").manual_seed(
                SEED), warm_prefix=warm, streamed=streamed,
            exit_sample_probs=esp)
        secs = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
        folded = vcfg.fusion_mode == "vit_concat"
        per_traj = (1 if folded else vcfg.window_size // 2
                    + (1 if streamed else 0))
        check(v.shape == (vcfg.num_exits, bs * len(batches) * per_traj)
              and bool(np.isfinite(v).all()),
              f"calibrate_variants {name} {regime}: values {v.shape}")
        check(launches["flash_attention"] > 0,
              f"calibrate_variants {name}: K1 not launched: {launches}")
        out["runs"][f"{name}_{regime}"] = {
            "warm_prefix": warm, "values_shape": list(v.shape),
            "min": float(v.min()), "median": float(np.median(v)),
            "max": float(v.max()), "seconds_per_batch": secs / len(batches),
            "launches": launches}
        del p
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_train_variants(torch, np) -> list:
    """``cli/train --debug --use_state --fusion_mode vit_concat`` in-process
    at JAX's defaults (B=6, W=12), one joint epoch of 4 batches: finite
    losses, K1 24 times a step, K2-K4 never; step seconds and peak memory.
    Then ``cli/eval --evaluate_from_checkpoint --frame_cache`` on its
    checkpoint (``phase_rollout``'s checks): the sidecar config carries the
    variant into calibration and the cached scan engine."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    shutil.rmtree(VARIANT_TRAIN_DIR, ignore_errors=True)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    held_gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer = cli.main(VARIANT_TRAIN_ARGV)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "cli_train_variants.log").write_text(buf.getvalue())
    cfg = trainer.cfg
    check(cfg.fusion_mode == "vit_concat" and cfg.use_state
          and cfg.head.use_state, f"train_variants: config {cfg}")
    check(len(steps) == TRAIN_STEPS // 2 and all(
        np.isfinite(s["loss"]) for s in steps),
        f"train_variants: losses {[s['loss'] for s in steps]}")
    check(launches["flash_attention"] == VIT_LAYERS * len(steps)
          and all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"train_variants: launches {launches}")
    secs = step_intervals(steps)
    out = {"phase": "train_variants", "argv": VARIANT_TRAIN_ARGV,
           "seconds": seconds, "losses": [s["loss"] for s in steps],
           "step_s": secs, "step_s_median": statistics.median(secs),
           "peak_memory_gb": peak_gb, "allocated_before_gb": held_gb,
           "trainable": len(steps[0]["keys"]), "launches": launches}
    emit(out)
    del trainer
    released_gb(torch)
    argv = ["--debug", "--model", "deer_3b", "--evaluate_from_checkpoint",
            str(VARIANT_TRAIN_DIR / "deer_0.ckpt"), "--calib_batches", "2",
            "--num_sequences_override", "2", "--ep_len", "40",
            "--exit_ratio", "0.5", "--frame_cache", "--calib_warm", "2"]
    out["runs"] = {"eval_frame_cache": phase_rollout(
        torch, np, "train_variants_eval", argv)}
    shutil.rmtree(VARIANT_TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return [out]


# ---------------------------------------------------------------------------
# the head families (ROADMAP M10b: fc, gpt, diffusion) on the deer_3b draw
# ---------------------------------------------------------------------------

# name -> DeerConfig changes: the fc head needs the window folded, the
# diffusion head takes the default 150 timesteps, horizon 32, 6 steps of
# history and down dims (256, 512, 1024)
HEAD_FAMILIES = (("gpt", {"head_type": "gpt"}),
                 ("fc", {"head_type": "fc", "fusion_mode": "vit_concat"}),
                 ("diffusion", {"head_type": "diffusion"}))
# the thresholds the head phases sweep, one a step (a stream at B=8): six
# decades, as the families compare arm actions or 1024-wide features
HEAD_SWEEP = [10.0 ** (-6 + 6 * s / 7) for s in range(8)]
# DDIM evaluations of a plan in the serve and rollout phases
DDIM_STEPS = 10
# the U-Net on the card against fp32 on the CPU with the same inputs and
# noise: the convolutions are fp32 products (no TF32; the settings are
# recorded beside), so one call differs by summation order (1e-5 relative
# L2), and a DDIM plan, 10 calls deep and scaled by 1 / sqrt(alpha_bar) at
# the chain's start, is held to 1e-4
UNET_TOL = {"unet_rel_l2": 1e-5, "plan_rel_l2": 1e-4}
HEAD_TRAIN_DIR = REPO / "build" / "chip_smoke_heads"
HEAD_TRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--batch_size_calvin",
                   str(TRAIN_BATCH), "--num_joint_epochs", "1",
                   "--num_exit_epochs", "0", "--joint_warmup_steps", "1",
                   "--logging_steps", "1", "--from_scratch"]
HEAD_ROLLOUTS = (
    ("rollout_gpt", ["--head_type", "gpt"]),
    ("rollout_diffusion", ["--head_type", "diffusion", "--diff_steps",
                           str(DDIM_STEPS)]),
    ("rollout_diffusion_lanes2", ["--head_type", "diffusion", "--diff_steps",
                                  str(DDIM_STEPS), "--lanes", "2"]))


def head_weights(torch, np, base: dict, cfg) -> dict:
    """The family's tree on the base draw: every head (final, per-layer
    exits, extra exit) of ``cfg.head_type`` drawn on the card from
    SEED + 3, then the variant leaves and, for diffusion, the U-Net and the
    normalizer, fitted on 2 debug batches' actions; the backbone is the
    base's."""
    from deer_vla_tpu_torch.models.flamingo import (init_diffusion_leaves,
                                                    init_variant_leaves)
    from deer_vla_tpu_torch.models.heads import init_any_head
    from deer_vla_tpu_torch.train.trainer import fit_action_normalizer
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    pdt = cfg.dtypes.pdt
    p = dict(base)
    for key in ("lm_head", "extra_exit"):
        p[key] = init_any_head(gen, cfg, "cuda", pdt)
    p["lm_exits"] = {k: init_any_head(gen, cfg, "cuda", pdt)
                     for k in base["lm_exits"]}
    p.update(init_variant_leaves(gen, cfg, "cuda", pdt))
    if cfg.head_type == "diffusion":
        p.update(init_diffusion_leaves(gen, cfg, "cuda", pdt))
        p = fit_action_normalizer(p, calib_debug_batches(cfg, 2, 2)[1])
    return p


def unet_settings(torch) -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def plan_inputs(torch, np, sampler, b: int, seed: int, device):
    """(cond, mask, features, noise) of ``b`` plans with a random history,
    drawn on the host and moved to ``device``."""
    r = np.random.RandomState(seed)
    hist = r.uniform(-1, 1, (b, sampler.hist_len, sampler.adim)).astype(
        np.float32)
    cond, mask = sampler.cond(hist)
    feats = torch.as_tensor(r.randn(b, sampler.dcfg.global_cond_dim).astype(
        np.float32))
    noise = sampler.noise(SEED, range(b)).cpu()
    return (cond.to(device), mask.to(device), feats.to(device),
            noise.to(device))


def profiled_launches(torch, fn) -> dict:
    """CUDA kernels launched by one ``fn()`` and their busy time
    (torch.profiler), beside its host-clock time."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0.0)
               for e in kernels) / 1e3
    return {"kernel_launches": sum(e.count for e in kernels),
            "device_busy_ms": busy, "profiled_wall_ms": wall}


def phase_diffusion_plans(torch, np, cfg, p, pol) -> dict:
    """The diffusion model's plans on the card: the feature step (the scan
    engine, K1 and K2, median of 5) and the plan apart.  A DDIM plan of
    DDIM_STEPS U-Net evaluations is timed on the host clock (median of 5
    after one), profiled once for its CUDA launches, and runs 4 steps of
    ``DiffusionSamplerPolicy`` around the engine; the full 150-evaluation
    DDPM chain runs once through the wrapper (its step less the feature
    step's median is its plan time) and is profiled once.  Each wrapper
    step gives a finite (W - hist, 7) plan with the gripper at +-1."""
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        DiffusionSamplerPolicy
    from deer_vla_tpu_torch.models.diffusion import sampler_steps
    pol.set_thresholds([HEAD_SWEEP[4]] * len(pol.exits))
    pol.reset()
    args, _ = variant_inputs(np, cfg)(1, 500)
    feat_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        feature = pol.step(*args)
        feat_ms.append((time.perf_counter() - t0) * 1e3)
    feat_median = statistics.median(feat_ms)
    out = {"phase": "serve_heads_diffusion_plans",
           "feature_step_ms": feat_ms, "feature_step_median_ms": feat_median,
           "feature_width": int(feature.shape[0]),
           "unet_settings": unet_settings(torch), "plans": {}}
    rows = cfg.window_size - (cfg.n_obs_steps - 1)
    for kind, steps, wrapper_steps in (("ddim", DDIM_STEPS, 4),
                                       ("ddpm", 0, 1)):
        wrapper = DiffusionSamplerPolicy(pol, p, seed=SEED,
                                         sample_steps=steps)
        s = wrapper.sampler
        cond, mask, feats, noise = plan_inputs(torch, np, s, 1, 501, "cuda")

        def plan():
            return s.sample(cond, mask, feats, noise)

        ms = []
        if kind == "ddim":
            plan()
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = plan()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(x).all()), "ddim plan not finite")
        wrapper.reset()
        plans, step_ms = [], []
        for t in range(wrapper_steps):
            t0 = time.perf_counter()
            plans.append(wrapper.step(*variant_inputs(np, cfg)(1, 510 + t)[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(a.shape == (rows, 7) and bool(np.isfinite(a).all())
                  and set(a[:, 6].tolist()) <= {-1.0, 1.0} for a in plans),
              f"{kind}: sampler plans {[a.shape for a in plans]}")
        if kind == "ddpm":
            ms = [step_ms[0] - feat_median]
        prof = profiled_launches(torch, plan)
        evals = sampler_steps(s.dcfg, steps)
        out["plans"][kind] = {
            "unet_evaluations": evals, "plan_ms": ms,
            "plan_median_ms": statistics.median(ms),
            "sampler_step_ms": step_ms,
            "launches_per_plan": prof["kernel_launches"],
            "launches_per_unet": prof["kernel_launches"] / evals,
            "device_busy_ms": prof["device_busy_ms"],
            "profiled_wall_ms": prof["profiled_wall_ms"],
            "sampler_plan_rows": rows}
    emit(out)
    return out


def full_depth_launches(torch, np, cfg, pol) -> dict:
    """Every CUDA kernel a full-depth step launches (every exit checked,
    the last one taken) and the device's busy time, at B=1 and B=8, one
    profiled step each after one unprofiled."""
    out = {}
    pol.set_thresholds([-1.0] * (len(pol.exits) - 1) + [1e8])
    for b in (1, 8):
        args, _ = variant_inputs(np, cfg)(b, 600 + b)

        def step():
            pol.reset()
            return pol.step_batch(*args) if b > 1 else pol.step(*args)

        step()
        out[f"b{b}"] = profiled_launches(torch, step)
    return out


def phase_serve_heads(torch, np, cfg, base: dict, serve: dict) -> list:
    """Each HEAD_FAMILIES model through ``ScanDeerPolicy`` with K1 and K2:
    8 B=1 and 4 B=8 steps over HEAD_SWEEP (``phase_serve``: exits among
    the exit set, finite outputs: a 7-dof action, or the diffusion head's
    1024-wide feature), peak memory, and every CUDA launch of a full-depth
    step at B=1 and B=8 beside post's (``full_depth_launches``); the gpt
    model also through
    ``DeerPolicy``, held against the scan engine with the same products
    (``phase_serve_bucketed``: equal exits, actions within 1e-2); the
    diffusion model's plans (``phase_diffusion_plans``)."""
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    results, summary = [], {}
    pol = ScanDeerPolicy(base, cfg, indexed_mm=True)
    summary["post"] = full_depth_launches(torch, np, cfg, pol)
    del pol
    for name, changes in HEAD_FAMILIES:
        hcfg = variant_config(cfg, changes)
        p = head_weights(torch, np, base, hcfg)
        pol = ScanDeerPolicy(p, hcfg, indexed_mm=True)
        torch.cuda.reset_peak_memory_stats()
        res = phase_serve(torch, np, hcfg, pol, name=f"serve_heads_{name}",
                          sweep=HEAD_SWEEP, inputs=variant_inputs(np, hcfg))
        res["head_params"] = sum(
            v.numel() for v in flat_leaves(p["extra_exit"]).values())
        res["full_depth"] = full_depth_launches(torch, np, hcfg, pol)
        results.append(res)
        summary[name] = {k: res[k] for k in (
            "b1_median_ms", "b8_median_ms", "b1_exit_layers",
            "launches_per_step", "peak_mem_gb", "head_params", "full_depth")}
        if name == "gpt":
            deer = DeerPolicy(p, hcfg, controller=ExitController(
                exit_id_list=list(hcfg.all_exit_ids()),
                max_layer=hcfg.n_layers))
            scan_plain = ScanDeerPolicy(p, hcfg)
            results.append(phase_serve_bucketed(
                torch, np, hcfg, deer, scan_plain, serve,
                name="serve_heads_gpt_bucketed", sweep=HEAD_SWEEP,
                inputs=variant_inputs(np, hcfg)))
            del deer, scan_plain
        if name == "diffusion":
            plans = phase_diffusion_plans(torch, np, hcfg, p, pol)
            results.append(plans)
            summary[name]["plans"] = {k: {x: v[x] for x in (
                "plan_median_ms", "launches_per_plan", "unet_evaluations")}
                for k, v in plans["plans"].items()}
        del pol, p
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_heads",
          "post": {"b1_median_ms": serve["b1_median_ms"],
                   "b8_median_ms": serve["b8_median_ms"]},
          "families": summary})
    return results


def phase_cross_check_heads(torch, np, cfg, base: dict,
                            cpu_base: dict) -> None:
    """A full-depth bf16 step of the gpt and the fc model (and the same
    weights in fp32 on the card) against fp32 on the CPU
    (``phase_cross_check``'s tolerances); then the diffusion model's U-Net
    (3 rows at timesteps 0, 75, 149) and a DDIM plan of DDIM_STEPS
    evaluations, on the card against the CPU with the same inputs and
    noise (UNET_TOL)."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.eval.diffusion_policy import _PlanSampler
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.diffusion import unet_forward
    for name, changes in HEAD_FAMILIES[:2]:
        hcfg = variant_config(cfg, changes)
        p = head_weights(torch, np, base, hcfg)
        cpu_p = dict(cpu_base, **{k: to_torch(v, "cpu") for k, v in p.items()
                                  if v is not base.get(k)})
        pol = ScanDeerPolicy(p, hcfg, indexed_mm=True)
        phase_cross_check(torch, np, hcfg, p, cpu_p, pol,
                          name=f"cross_check_heads_{name}",
                          inputs=variant_inputs(np, hcfg)(1, 300))
        del pol, p, cpu_p
        gc.collect()
        torch.cuda.empty_cache()
    hcfg = variant_config(cfg, dict(HEAD_FAMILIES)["diffusion"])
    p = head_weights(torch, np, base, hcfg)
    card = _PlanSampler(hcfg, p, "cuda", DDIM_STEPS, 0.0)
    cpu = _PlanSampler(hcfg, p, "cpu", DDIM_STEPS, 0.0)
    cond, mask, feats, noise = plan_inputs(torch, np, cpu, 3, 520, "cpu")
    t = torch.tensor([0, 75, 149])
    x = noise[0]
    with torch.inference_mode():
        u_card = unet_forward(card.unet, x.cuda(), t.cuda(), card.dcfg,
                              feats.cuda()).cpu()
        u_cpu = unet_forward(cpu.unet, x, t, cpu.dcfg, feats)
        x_card = card.sample(cond.cuda(), mask.cuda(), feats.cuda(),
                             noise.cuda()).cpu()
        x_cpu = cpu.sample(cond, mask, feats, noise)
    got = {"unet_rel_l2": rel_l2(np, u_card.numpy(), u_cpu.numpy()),
           "plan_rel_l2": rel_l2(np, x_card.numpy(), x_cpu.numpy()),
           "plan_max_abs": float((x_card - x_cpu).abs().max())}
    emit({"phase": "cross_check_heads_diffusion", "ddim_steps": DDIM_STEPS,
          "unet_rows": 3, "timesteps": t.tolist(), "card_vs_cpu_fp32": got,
          "tolerance": UNET_TOL, "unet_settings": unet_settings(torch)})
    for key, limit in UNET_TOL.items():
        check(got[key] <= limit, f"cross_check_heads_diffusion {key} "
                                 f"{got[key]}")
    del card, cpu, p
    torch.cuda.empty_cache()


def realized_mix(np, values, thresholds: dict, exits: list) -> list:
    """The exit mix the thresholds give the calibration samples: a sample
    exits at the first exit whose delta is at most its threshold, at the
    last one otherwise."""
    taken = np.full(values.shape[1], len(exits) - 1)
    for i in reversed(range(len(exits) - 1)):
        taken = np.where(values[i] <= thresholds[exits[i]], i, taken)
    return (np.bincount(taken, minlength=len(exits))
            / values.shape[1]).tolist()


def phase_calibrate_heads(torch, np, cfg, base: dict) -> dict:
    """Calibration (B=2, W=12, 2 debug batches) of the gpt and the
    diffusion model, folded and streamed: seconds and kernel counts a
    batch, the deltas (the diffusion head's on its features), and the
    realized mix on the samples of the thresholds solved for ratio 0.5
    against its target."""
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE as bs
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    from deer_vla_tpu_torch.models.value_net import (exit_probs,
                                                     solve_thresholds)
    counters = kernel_counters()
    out = {"phase": "calibrate_heads", "batch_size": bs, "runs": {}}
    for name in ("gpt", "diffusion"):
        hcfg, batches = calib_debug_batches(
            variant_config(cfg, dict(HEAD_FAMILIES)[name]), bs, 2)
        p = head_weights(torch, np, base, hcfg)
        exits = list(hcfg.all_exit_ids())
        for regime in ("folded", "streamed"):
            streamed = regime == "streamed"
            esp = (streamed_sample_probs(hcfg, 0.5, None, "exp", "deer_3b")
                   if streamed else None)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            vals, secs, launches = [], [], []
            for batch in batches:
                for f in counters.values():
                    f.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vals.append(generate_calibration_values(
                    p, hcfg, [batch], gen=gen, streamed=streamed,
                    exit_sample_probs=esp))
                secs.append(time.perf_counter() - t0)
                launches.append({n: f.launches for n, f in counters.items()})
            v = np.concatenate(vals, axis=1)
            per_traj = hcfg.window_size // 2 + (1 if streamed else 0)
            check(v.shape == (len(exits), bs * len(batches) * per_traj)
                  and bool(np.isfinite(v).all()),
                  f"calibrate_heads {name} {regime}: values {v.shape}")
            check(all(n["flash_attention"] > 0 for n in launches),
                  f"calibrate_heads {name}: K1 not launched: {launches}")
            th, _ = solve_thresholds(v, 0.5, exits, hcfg.n_layers - 1,
                                     model_name="deer_3b")
            target = exit_probs(len(exits), 0.5, "exp", "deer_3b").tolist()
            mix = realized_mix(np, v, th, exits)
            out["runs"][f"{name}_{regime}"] = {
                "values_shape": list(v.shape), "min": float(v.min()),
                "median": float(np.median(v)), "max": float(v.max()),
                "thresholds": th, "target_mix": target,
                "realized_mix": mix,
                "mix_max_abs_gap": max(abs(a - b)
                                       for a, b in zip(mix, target)),
                "seconds_per_batch": secs, "launches": launches[-1]}
        del p
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_train_heads(torch, np) -> list:
    """``cli/train --debug --head_type diffusion`` and ``--head_type gpt``
    in-process at JAX's defaults (B=6, W=12), one joint epoch of 4
    batches: finite losses, K1 24 times a step and K2-K4 never, step
    seconds and peak memory; the diffusion run's checkpoint holds the
    normalizer it fitted.  Then ``cli/eval --evaluate_from_checkpoint`` on
    each checkpoint (``phase_rollout``'s checks; DDIM for diffusion).  The
    run directories are deleted after."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    from deer_vla_tpu_torch.train.checkpoint import load_checkpoint
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    results = []
    for name, flags, eval_flags in (
            ("diffusion", ["--head_type", "diffusion"],
             ["--diff_steps", str(DDIM_STEPS)]),
            ("gpt", ["--head_type", "gpt"], [])):
        run = HEAD_TRAIN_DIR / name
        shutil.rmtree(run, ignore_errors=True)
        argv = HEAD_TRAIN_ARGV + ["--run_name", str(run)] + flags
        counters = kernel_counters()
        for f in counters.values():
            f.launches = 0
        held_gb = released_gb(torch)
        torch.cuda.reset_peak_memory_stats()
        steps, buf = [], io.StringIO()
        t0 = time.perf_counter()
        with train_updates(steps), contextlib.redirect_stdout(buf):
            trainer = cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / f"cli_train_heads_{name}.log").write_text(buf.getvalue())
        check(trainer.cfg.head_type == name, f"train_heads {name}: config")
        check(len(steps) == TRAIN_STEPS // 2 and all(
            np.isfinite(s["loss"]) for s in steps),
            f"train_heads {name}: losses {[s['loss'] for s in steps]}")
        check(launches["flash_attention"] == VIT_LAYERS * len(steps)
              and all(launches[n] == 0 for n in DECODER_KERNEL.values()),
              f"train_heads {name}: launches {launches}")
        ckpt = run / "deer_0.ckpt"
        out = {"phase": f"train_heads_{name}", "argv": argv,
               "seconds": seconds, "losses": [s["loss"] for s in steps],
               "step_s": step_intervals(steps),
               "step_s_median": statistics.median(step_intervals(steps)),
               "peak_memory_gb": peak_gb, "allocated_before_gb": held_gb,
               "trainable": len(steps[0]["keys"]),
               "trainable_params": sum(
                   v.numel() for k, v in flat_leaves(trainer.params).items()
                   if k in steps[0]["keys"]),
               "checkpoint_bytes": ckpt.stat().st_size, "launches": launches}
        if name == "diffusion":
            norm = trainer.params["diffusion"]["norm"]
            saved = load_checkpoint(str(ckpt), trainer.params)[0][
                "diffusion"]["norm"]
            check(all(torch.equal(saved[k], norm[k]) for k in norm)
                  and not bool((norm["scale"] == 1).all()),
                  "train_heads diffusion: the fitted normalizer is not in "
                  "the checkpoint")
            out["normalizer"] = {k: v.tolist() for k, v in norm.items()}
        emit(out)
        del trainer
        released_gb(torch)
        eval_argv = (["--debug", "--model", "deer_3b",
                      "--evaluate_from_checkpoint", str(ckpt)]
                     + ROLLOUT_ARGV[3:] + eval_flags)
        out["runs"] = {"eval": phase_rollout(
            torch, np, f"train_heads_{name}_eval", eval_argv)}
        shutil.rmtree(run, ignore_errors=True)
        torch.cuda.empty_cache()
        results.append(out)
    shutil.rmtree(HEAD_TRAIN_DIR, ignore_errors=True)
    return results


def drive_paths(torch, np, cfg) -> tuple:
    """The main paths on seeded deer_3b weights: serving in every mode with
    its cross-checks, the serving variants (DeerPolicy, the caches,
    BatchedDeerPolicy, ToMe), the vision, state and window variants on the
    same draw (serve_variants, cross_check_variants, serve_folded,
    calibrate_variants), the head families (serve_heads,
    cross_check_heads, calibrate_heads), calibration with its cross-check,
    the train step's cross-check and guard, the cli/eval rollouts (the head
    families' too), then cli/train and cli/eval on its checkpoint, and the
    same for a vit_concat state model (train_variants) and for the
    diffusion and gpt heads (train_heads)."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    t0 = time.perf_counter()
    params = build_weights(torch, cfg)
    pol = ScanDeerPolicy(params, cfg, indexed_mm=True)
    emit({"phase": "weights", "seconds": time.perf_counter() - t0,
          "seed": SEED, "exits": pol.exits})
    serve = phase_serve(torch, np, cfg, pol)
    quantized = phase_serve_quantized(torch, np, cfg, params,
                                      serve["stacked_bytes"])
    cpu_params = to_torch(params, "cpu")
    phase_cross_check(torch, np, cfg, params, cpu_params, pol)
    deer = DeerPolicy(params, cfg, controller=ExitController(
        exit_id_list=list(cfg.all_exit_ids()), max_layer=cfg.n_layers))
    scan_plain = ScanDeerPolicy(params, cfg)  # cuBLAS products, no K2
    variants = [phase_serve_bucketed(torch, np, cfg, deer, scan_plain, serve),
                phase_caches(torch, np, cfg, pol, deer),
                phase_batched_bucketed(torch, np, cfg, params, scan_plain)]
    del pol, deer, scan_plain
    torch.cuda.empty_cache()
    variants.append(phase_serve_tome(torch, np, cfg, params, cpu_params))
    torch.cuda.empty_cache()
    phase_cross_check_quantized(torch, np, cfg, params, cpu_params)
    variants += phase_serve_variants(torch, np, cfg, params, serve)
    phase_cross_check_variants(torch, np, cfg, params, cpu_params)
    variants += phase_serve_folded(torch, np, cfg, params)
    variants.append(phase_calibrate_variants(torch, np, cfg, params))
    variants += phase_serve_heads(torch, np, cfg, params, serve)
    phase_cross_check_heads(torch, np, cfg, params, cpu_params)
    variants.append(phase_calibrate_heads(torch, np, cfg, params))
    calib = phase_calibrate(torch, np, cfg, params)
    phase_calibrate_cross_check(torch, np, cfg, params, cpu_params)
    phase_train_cross_check(torch, np, params, cpu_params)
    del cpu_params
    phase_train_guard(torch, params)
    del params
    torch.cuda.empty_cache()
    rollouts = {name: phase_rollout(torch, np, name, ROLLOUT_ARGV + flags)
                for name, flags in ROLLOUT_RUNS + HEAD_ROLLOUTS}
    piped, plain = (rollouts["rollout_lanes4_pipeline2"]["report"],
                    rollouts["rollout_lanes4"]["report"])
    check(piped == plain, f"--pipeline 2 --env_workers 2 changed the "
                          f"report: {piped} against {plain}")
    paths = variants + list(rollouts.values()) + [
        phase_train(torch, np), phase_train_eval(torch, np)]
    paths += phase_train_variants(torch, np)
    paths += phase_train_heads(torch, np)
    phase_calvin_data(np)
    paths += [phase_train_calvin(torch, np),
              phase_train_calvin_difws(torch, np),
              phase_calib_calvin(torch, np)]
    return serve, quantized, calib, paths


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "deer_vla_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the deer_vla_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np

    from deer_vla_tpu_torch.core.config import deer_3b

    smi = phase_device(torch)
    tc = phase_build()
    cfg = deer_3b()
    summary = phase_kernels(torch, vit_batches(cfg))
    summary.update(phase_kernels_9b(torch, summary["k2_checked"]))

    k1_seen, k2_seen = set(), set()
    with k1_calls(k1_seen), k2_calls(k2_seen):
        serve, quantized, calib, paths = drive_paths(torch, np, cfg)
        paths_9b, path_launches = drive_9b(torch, np)
        paths += paths_9b + drive_llama(torch, np)
    unchecked = k1_seen - summary["k1_checked"]
    emit({"phase": "k1_shapes", "driven": sorted(map(str, k1_seen)),
          "unchecked": sorted(map(str, unchecked))})
    check(k1_seen and not unchecked,
          f"K1 ran at shapes no phase held against its plain version: "
          f"{unchecked}")
    unchecked = k2_seen - summary["k2_checked"]
    emit({"phase": "k2_shapes", "driven": sorted(map(str, k2_seen)),
          "unchecked": sorted(map(str, unchecked))})
    check(k2_seen and not unchecked,
          f"K2-K4 ran at shapes no phase held against its plain version: "
          f"{unchecked}")

    path_launches["calibrate"] = calibrate_launches(calib)
    for r in paths:  # the rollouts, the training and CALVIN phases, and
        # the 9B and llama serve and rollout phases
        if "launches" in r:
            path_launches[r["phase"]] = r["launches"]
        for name, run in r.get("runs", {}).items():
            path_launches[f"{r['phase']}_{name}"] = run["launches"]
        if "debug_launches" in r:
            path_launches[r["phase"] + "_debug"] = r["debug_launches"]
    launches = dict(serve["launches"])
    launches["indexed_matmul_q8"] = \
        quantized["int8"]["launches"]["indexed_matmul_q8"]
    launches["indexed_matmul_q4"] = \
        quantized["int4"]["launches"]["indexed_matmul_q4"]
    for name, phase in (("indexed_matmul", "serve_9b"),
                        ("indexed_matmul_q8", "serve_9b_int8"),
                        ("indexed_matmul_q4", "serve_9b_int4")):
        launches[name + "_9b"] = path_launches[phase][name]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernels_line(summary, launches, tc, path_launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
