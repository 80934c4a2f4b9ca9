"""K1's backward on one GPU at the calls the port trains through it.

    python3 scripts/torch_k1_backward.py [--times-only] [--out FILE]

Makes, seeded, the calls ``cli/pretrain``'s MMC4 step at 256 tokens gives
``flash_attention_backward`` on deer_3b's widths (the decoder's
self-attention, q, k, v (4, 16, 256, 128) bf16 views of one fused qkv with
its (4, 16, 256, 256) bf16 ALiBi + causal + padding bias; the
cross-attention, q (4, 8, 256, 64) over 384 media keys with its
(4, 1, 256, 384) fp32 mask, three text rows masked everywhere) and the
fp32 ViT call (4, 16, 257, 64) of ``--unfreeze_vit``, and runs
``chip_smoke.py``'s ``k1_backward`` phase on them, which adds the synthetic
bf16 ViT call: every check and time of that phase, after the build's
register and spill report for the backward's kernels.  ``--times-only``
times the kernel alone (CUDA-graph replays, ``chip_smoke.graph_ms``) at
those calls and the bf16 ViT one, handing it the forward's row statistics
where the wrapper takes them, so that an earlier checkout, given a copy of
this script, is timed by the same code in the same call.  Prints JSON
lines (also to ``--out``) and, last, the card and its power limit.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def calls(torch, smoke) -> dict:
    """``k1_key`` -> (q, k, v, bias, out, dout, scale, stats) of the paths'
    calls, and the bf16 ViT call under the key "vit_bf16"."""
    import deer_vla_tpu_torch.ops.kernels.flash_attention as fa
    from deer_vla_tpu_torch.ops.alibi import full_attn_bias
    from deer_vla_tpu_torch.ops.attention import split_heads
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    mask = torch.ones(4, 256, dtype=torch.int64, device="cuda")
    mask[1, 200:] = 0
    mask[3, 130:] = 0
    xbias = torch.zeros(4, 1, 256, 384, device="cuda")
    xbias[:, :, :, 192:] = -1e9   # media after the text position
    xbias[:, :, :3, :] = -1e9     # text before the first media token
    qkv = rand(4, 256, 3 * 16 * 128)
    vit = rand(4, 257, 3 * 16 * 64)
    cases = {
        "decoder": (*(split_heads(x, 16) for x in qkv.chunk(3, dim=-1)),
                    full_attn_bias(mask, 16, 256, 8.0, torch.bfloat16),
                    128 ** -0.5),
        "xattn": (split_heads(rand(4, 256, 512), 8),
                  *(split_heads(x, 8) for x in rand(4, 384, 1024).chunk(
                      2, dim=-1)), xbias, 64 ** -0.5),
        "vit_fp32": (*(rand(4, 16, 257, 64, dtype=torch.float32)
                       for _ in range(3)), None, 64 ** -0.5),
        "vit_bf16": (*(split_heads(x, 16) for x in vit.chunk(3, dim=-1)),
                     None, 64 ** -0.5)}
    out = {}
    for name, (q, k, v, bias, scale) in cases.items():
        if hasattr(fa, "flash_attention_with_stats"):
            o, stats = fa.flash_attention_with_stats(q, k, v, bias, scale)
        else:  # an earlier version: its forward saves nothing
            o, stats = fa.flash_attention(q, k, v, bias, scale), None
        key = "vit_bf16" if name == "vit_bf16" else smoke.k1_key(q, k, bias)
        out[key] = (q, k, v, bias, o, rand(*q.shape, dtype=q.dtype), scale,
                    stats)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "torch_k1_backward.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_backward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    from deer_vla_tpu_torch.ops.kernels import build
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_backward)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    ptxas, entry = [], ""
    for line in build.build_info()["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "attn_bwd" in entry and ("registers" in line or "spill" in line):
            ptxas.append(f"{entry}: {line.strip()}")
    emit({"repo": str(REPO), "build_s": build.build_info()["seconds"],
          "ptxas": ptxas})
    cases = calls(torch, smoke)
    if args.times_only:
        takes_stats = "stats" in inspect.signature(
            flash_attention_backward).parameters
        for key, (q, k, v, bias, o, do, scale, stats) in cases.items():
            extra = (stats,) if takes_stats else ()
            emit({"case": str(key), "kernel_ms": smoke.graph_ms(
                torch, lambda: flash_attention_backward(
                    q, k, v, bias, o, do, scale, *extra), 8)})
    else:
        del cases["vit_bf16"]  # the phase makes its own
        emit({"cases": smoke.phase_k1_backward(torch, cases)})
    emit({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
