"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deer_vla_tpu_torch/csrc/``, holds each
against its plain PyTorch version at the shapes the serving step gives it
(K1 flash attention, K2 / K3 / K4 the bf16 / int8 / int4 layer-indexed
matmuls), then serves ``deer_3b`` at full width (24-layer ViT-L/14, 6-layer
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
    """Device time of one call, from CUDA events around ``iters`` calls."""
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


def phase_build() -> None:
    from deer_vla_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(info["log"])
    usage = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "ptxas": usage})


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
    return cases


DECODER_PRODUCTS = (("wqkv", 2048, 6144), ("out_proj", 2048, 2048),
                    ("mlp_up", 2048, 8192), ("mlp_down", 8192, 2048))
# (streams, x dtype) of the indexed-matmul cases: M = 32 text rows a stream
INDEXED_CASES = ((1, "bfloat16"), (8, "bfloat16"), (32, "bfloat16"),
                 (1, "float32"))


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


def indexed_case(torch, kernel: str, name: str, x, n: int, nbytes: int,
                 run, plain, library, idxs) -> dict:
    """One layer-indexed product: every one of the 12 layers checked
    against the plain version (tolerance relative to max|y|), then the
    kernel, the plain version and the library call timed cycling through
    the layers, so each call reads a slice the previous call did not, as
    the decoder loop does (a stack of 12 exceeds the 50 MB L2).  ``run``
    and ``plain`` take the 0-dim int32 layer tensor, ``library`` the
    layer as an int (a tensor index would sync the host each call)."""
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
    it = iter(range(10 ** 9))
    row["kernel_ms"] = time_ms(torch, lambda: run(idxs[next(it) % 12]), 48)
    row["reference_ms"] = time_ms(
        torch, lambda: plain(idxs[next(it) % 12]), 24)
    row["library_ms"] = time_ms(torch, lambda: library(next(it) % 12), 48)
    return row


def layer_summary(rows: list) -> dict:
    """One deer_3b decoder layer at B=1 in bf16: the four products'
    times, bytes and operations summed, and their bound."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0, "max_abs_err": 0.0}
    for row in rows:
        if row["m"] == 32 and row["case"].endswith("bfloat16"):
            for key, src in (("ms", "kernel_ms"), ("plain_ms", "reference_ms"),
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
    F = torch.nn.functional
    rows = []
    summary = {}

    for name, q, k, v, bias, scale in k1_cases(torch):
        dt = str(q.dtype)[6:]
        got = flash_attention(q, k, v, bias, scale)
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
            row["kernel_ms"] = time_ms(
                torch, lambda: flash_attention(q, k, v, None, scale), 50)
            row["reference_ms"] = time_ms(
                torch, lambda: flash_attention_reference(q, k, v, None,
                                                         scale), 20)
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 50)
            if name == "vit_b1_bfloat16":
                summary["flash_attention"] = row
        rows.append(row)

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
    emit({"phase": "kernels", "cases": rows + k2_rows})
    summary.update(phase_kernels_quantized(torch, idxs))
    return summary


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
    return {kernel: layer_summary(r) for kernel, r in rows.items()}


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


def kernels_line(summary: dict, launches: dict) -> dict:
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
    phase_build()
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
    emit(kernels_line(summary, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
