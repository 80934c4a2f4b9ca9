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
quantize to the same bits) in int8 and int4.

Every phase prints one JSON line; any failed check raises and the script
exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the port's package beside this file, it
exits non-zero and prints no result.  Compiler logs go to
``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import dataclasses
import json
import re
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


def vit_strided_qkv(torch, streams: int):
    """q, k, v as the ViT hands them to K1: ``split_heads`` views of one
    fused (2B, 257, 3 * 1024) qkv projection, no copy."""
    from deer_vla_tpu_torch.ops.attention import split_heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * streams)
    qkv = torch.randn(2 * streams, 257, 3 * 1024, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (split_heads(t, 16) for t in qkv.chunk(3, dim=-1))
    check(not q.is_contiguous() and q.data_ptr() == qkv.data_ptr(),
          "split_heads did not give a view")
    return q, k, v


DECODER_PRODUCTS = (("wqkv", 2048, 6144), ("out_proj", 2048, 2048),
                    ("mlp_up", 2048, 8192), ("mlp_down", 8192, 2048))
# (streams, x dtype) of the indexed-matmul cases: M = 32 text rows a stream
INDEXED_CASES = ((1, "bfloat16"), (2, "bfloat16"), (4, "bfloat16"),
                 (8, "bfloat16"), (32, "bfloat16"), (1, "float32"))
# row counts at which each of K2's block configs is checked and timed: 1-4
# and 8 streams (96 rows fill a 128-row block partly)
K2_CONFIG_ROWS = (32, 64, 96, 128, 256)


def k2_cases(torch, streams: int, dt):
    """(name, x, w) for the decoder's four stacked products."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + streams)
    out = []
    for name, k, n in DECODER_PRODUCTS:
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
                 run, plain, library, idxs) -> dict:
    """One layer-indexed product: every one of the 12 layers checked
    against the plain version (tolerance relative to max|y|), then timed
    by ``k2_times``."""
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
    row = {"kernel": kernel, "case": name, "m": m, "k": kk, "n": n,
           "layers": 12, "max_abs_err": err, "tolerance": tol}
    row.update(bound(nbytes, 2 * m * kk * n, dts))
    row.update(k2_times(torch, run, plain, library, idxs))
    return row


def layer_summary(rows: list, m: int = 32) -> dict:
    """One deer_3b decoder layer in bf16 at ``m`` rows (32 a stream): the
    four products' times, bytes and operations summed, and their bound."""
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


def phase_kernels(torch) -> dict:
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_reference)
    rows = []
    summary = {}

    from deer_vla_tpu_torch.ops.attention import merge_heads
    from deer_vla_tpu_torch.ops.kernels.flash_attention import TC_HEAD_DIMS
    cases = k1_cases(torch)
    for streams in (1, 8):
        q, k, v = vit_strided_qkv(torch, streams)
        cases.append((f"vit_strided_b{streams}_bfloat16", q, k, v, None,
                      0.125))
    for name, q, k, v, bias, scale in cases:
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
    k2_rows = []
    for streams, dts in INDEXED_CASES:
        for name, x, w in k2_cases(torch, streams, getattr(torch, dts)):
            m, kk = x.shape
            n = w.shape[2]
            k2_rows.append(indexed_case(
                torch, "indexed_matmul", name, x, n,
                (kk * n + m * kk + m * n) * x.element_size(),
                lambda i: indexed_matmul(x, w, i),
                lambda i: indexed_matmul_reference(x, w, i),
                lambda i: x @ w[i], idxs))
    summary["indexed_matmul"] = layer_summary(k2_rows)
    summary["indexed_matmul_b8"] = layer_summary(k2_rows, m=256)
    emit({"phase": "kernels", "cases": rows + k2_rows})
    summary.update(phase_kernels_quantized(torch, idxs))
    for kernel in DECODER_KERNEL.values():
        phase_determinism_and_graph(torch, idxs, kernel)
        phase_configs(torch, idxs, kernel)
    return summary


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


def phase_determinism_and_graph(torch, idxs, kernel: str) -> None:
    """The split-K sums are combined in a fixed order: two launches give
    bit-identical outputs.  The four products of a layer captured once in a
    CUDA graph, replayed after ``idx.fill_(j)`` for each of the 12 layers,
    equal the eager launches bit for bit and the plain version within
    K2_REL_TOL: the layer index is read on the device at every replay."""
    fn, plain, plan_of, _ = indexed_kernel(kernel)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    stacks = [(prod, stacked_weights(torch, gen, kernel, k, n))
              for prod, k, n in DECODER_PRODUCTS]
    phase = ("k2" if kernel == "indexed_matmul" else "k3_k4") \
        + "_determinism_and_graph"
    out = {"phase": phase, "kernel": kernel, "cases": []}
    for streams in (1, 2, 3, 4, 8):
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
        out["cases"].append({"streams": streams,
                             "products": [p[0] for p in prods],
                             "splits": splits, "repeat_bit_identical": True,
                             "graph_layers_replayed": 12,
                             "graph_equals_eager": True,
                             "graph_worst_err_over_tol": worst})
        del graph, ys, prods
    emit(out)


def phase_configs(torch, idxs, kernel: str) -> dict:
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
    for prod, k, n in DECODER_PRODUCTS:
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
    emit({"phase": "k2_configs" if kernel == "indexed_matmul"
          else "k3_k4_configs", "kernel": kernel,
          "configs": [c._asdict() for c in configs],
          "layer_ms": by_rows, "rows": rows})
    return by_rows


def phase_kernels_quantized(torch, idxs) -> dict:
    """K3 and K4 at the four decoder products.  The library call is
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
    for prod, k, n in DECODER_PRODUCTS:
        w = torch.randn(12, k, n, generator=gen, device="cuda") * k ** -0.5
        q8, s8 = quantize_weight(w)
        q4, s4 = quantize_weight4(w)
        del w
        xs = {(streams, dts): torch.randn(32 * streams, k, generator=gen,
                                          device="cuda").to(getattr(torch,
                                                                    dts))
              for streams, dts in INDEXED_CASES}
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
                    lambda i: x @ wd[dts][i], idxs))
            del wd
    emit({"phase": "kernels_quantized",
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
    """Seeded random deer_3b weights on the card.  The init leaves the
    cross-attention gates at zero, as the reference does; they are drawn
    here so that the vision path reaches the actions."""
    from deer_vla_tpu_torch.models.flamingo import init_deer
    params = init_deer(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for x in params["decoder"]["xattn"]:
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
                b8_steps=4) -> dict:
    """Serve ``b1_steps`` single-stream steps, then ``b8_steps`` eight-stream
    steps, with every kernel's launch count set to 0 just before and read
    just after."""
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    n_exits = len(pol.exits)
    # one threshold per step (per stream at B=8), over three decades: with
    # these random heads the exit deltas lie around 1e-5 (the first full
    # run), so the dynamic exit has room to pick different layers
    sweep = [10.0 ** (-6 + 3 * s / 7) for s in range(8)]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    b1_ms, b1_exits = [], []
    pol.reset()
    for s in range(b1_steps):
        pol.set_thresholds([sweep[s]] * n_exits)
        inputs = make_policy_inputs(np, cfg, 1, seed=100 + s)
        t0 = time.perf_counter()
        act = pol.step(*inputs)
        b1_ms.append((time.perf_counter() - t0) * 1e3)
        check(act.shape == (7,) and bool(np.isfinite(act).all()),
              f"{quantize} B=1 step {s}: action {act}")
        b1_exits.append(pol.last_exit_layer)
    b8_ms, b8_exits = [], []
    pol.set_thresholds_batch([[t] * n_exits for t in sweep])
    pol.reset()
    for s in range(b8_steps):
        inputs = make_policy_inputs(np, cfg, 8, seed=200 + s)
        t0 = time.perf_counter()
        acts, exits = pol.step_batch(*inputs)
        b8_ms.append((time.perf_counter() - t0) * 1e3)
        check(acts.shape == (8, 7) and bool(np.isfinite(acts).all()),
              f"{quantize} B=8 step {s}: non-finite actions")
        b8_exits.append(exits.tolist())
    launches = {name: f.launches for name, f in counters.items()}
    every = set(b1_exits) | {e for row in b8_exits for e in row}
    check(every <= set(pol.exits), f"exit layers {every} not in {pol.exits}")
    if b1_steps:
        check(len(set(b1_exits)) > 1, f"{quantize} B=1 exits all at "
                                      f"{b1_exits}")
    decoder = DECODER_KERNEL.get(quantize)
    check(launches["flash_attention"] > 0
          and (decoder is None or launches[decoder] > 0),
          f"{quantize}: kernels not launched on the main path: {launches}")
    if quantize:
        check(launches["indexed_matmul"] == 0,
              f"{quantize}: the bf16 kernel K2 ran: {launches}")
    out = {"phase": "serve" if quantize is None else f"serve_{quantize}",
           "config": "deer_3b", "quantize": quantize,
           "vit": [cfg.vit.layers, cfg.vit.width], "mpt": [cfg.n_layers,
                                                           cfg.mpt.d_model],
           "compute": str(cfg.dtypes.cdt)[6:],
           "params": str(cfg.dtypes.pdt)[6:],
           "b1_thresholds": sweep[:b1_steps], "b1_exit_layers": b1_exits,
           "b1_step_ms": b1_ms,
           "b1_median_ms": statistics.median(b1_ms) if b1_ms else None,
           "b8_stream_thresholds": sweep, "b8_exit_layers": b8_exits,
           "b8_step_ms": b8_ms, "b8_median_ms": statistics.median(b8_ms),
           "launches": launches, "stacked_bytes": tree_bytes(pol.stacked),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def phase_serve_quantized(torch, np, cfg, params, bf16_bytes: int) -> dict:
    """int8 and int4 at B=1 and B=8 through K3 / K4, then the w8a8 modes at
    B=8; each policy is freed before the next is built."""
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    out = {}
    for mode, b1_steps in (("int8", 8), ("int4", 8), ("int8_w8a8", 0),
                           ("int4_w8a8", 0)):
        pol = ScanDeerPolicy(params, cfg, indexed_mm=True, quantize=mode)
        torch.cuda.reset_peak_memory_stats()
        res = phase_serve(torch, np, cfg, pol, mode, b1_steps=b1_steps)
        res["stacked_bytes_vs_bf16"] = res["stacked_bytes"] / bf16_bytes
        out[mode] = res
        del pol
        torch.cuda.empty_cache()
    emit({"phase": "serve_quantized_summary",
          "stacked_bytes_bf16": bf16_bytes,
          "modes": {m: {"b1_median_ms": r["b1_median_ms"],
                        "b8_median_ms": r["b8_median_ms"],
                        "stacked_bytes": r["stacked_bytes"],
                        "stacked_bytes_vs_bf16": r["stacked_bytes_vs_bf16"],
                        "launches": r["launches"]}
                    for m, r in out.items()}})
    return out


def full_depth_step(np, pol, cfg, inputs):
    pol.set_thresholds([-1.0] * (len(pol.exits) - 1) + [1e8])
    pol.reset()
    act = pol.step(*inputs)
    check(pol.last_exit_layer == cfg.n_layers - 1,
          f"full-depth step exited at {pol.last_exit_layer}")
    return act[:6], pol.last_hidden.float().cpu()


def compare(np, torch, act, hid, act_ref, hid_ref) -> dict:
    return {"arm_max_abs": float(np.abs(act - act_ref).max()),
            "hidden_rel_l2": float(torch.linalg.vector_norm(hid - hid_ref)
                                   / torch.linalg.vector_norm(hid_ref))}


def phase_cross_check(torch, np, cfg, params, cpu_params, pol) -> None:
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    act_bf16, hid_bf16 = full_depth_step(np, pol, cfg, inputs)
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32, indexed_mm=True)
    act_f32, hid_f32 = full_depth_step(np, card32, cfg32, inputs)
    del card32
    t0 = time.perf_counter()
    cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True, device="cpu")
    act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs)
    cpu_s = time.perf_counter() - t0
    bf16 = compare(np, torch, act_bf16, hid_bf16, act_ref, hid_ref)
    f32 = compare(np, torch, act_f32, hid_f32, act_ref, hid_ref)
    emit({"phase": "cross_check", "exit_layer": cfg.n_layers - 1,
          "card_bf16_vs_cpu_fp32": bf16, "tol_bf16": CROSS_TOL_BF16,
          "card_fp32_vs_cpu_fp32": f32, "tol_fp32": CROSS_TOL_FP32,
          "arm_card_bf16": act_bf16.tolist(), "arm_cpu_fp32": act_ref.tolist(),
          "cpu_seconds": cpu_s})
    for got, tol, what in ((bf16, CROSS_TOL_BF16, "bf16"),
                           (f32, CROSS_TOL_FP32, "fp32")):
        for key, limit in tol.items():
            check(got[key] <= limit, f"cross_check {what} {key} {got[key]}")


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


def kernels_line(summary: dict, launches: dict, tc: dict) -> dict:
    """``launches`` maps each kernel to its count on the serve path that
    runs it: K1 and K2 on the bf16 serve, K3 on int8's, K4 on int4's."""
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
            "tensor_core_sass": tc["flash_attention"]["hmma_hgmma"],
            "shape": "q,k,v (2,16,257,64) bf16, no bias (ViT layer, B=1)"}]
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
    for row in out[1:]:
        b8 = summary[row["name"] + "_b8"]
        row["b8_ms"] = b8["ms"]
        row["b8_library_ms"] = b8["library_ms"]
        row["b8_bound_ms"] = b8["bound_ms"]
        row["tensor_core_sass"] = tc[row["name"]]["hmma_hgmma"]
        row["conversion_sass"] = tc[row["name"]]["conversions"]
    return {"kernels": out}


def main() -> int:
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

    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy

    smi = phase_device(torch)
    tc = phase_build()
    summary = phase_kernels(torch)

    cfg = deer_3b()
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
    del pol
    torch.cuda.empty_cache()
    phase_cross_check_quantized(torch, np, cfg, params, cpu_params)

    launches = dict(serve["launches"])
    launches["indexed_matmul_q8"] = \
        quantized["int8"]["launches"]["indexed_matmul_q8"]
    launches["indexed_matmul_q4"] = \
        quantized["int4"]["launches"]["indexed_matmul_q4"]
    emit(kernels_line(summary, launches, tc))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
