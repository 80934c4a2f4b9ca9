"""What K3's widen stage costs on one GPU.

    python3 scripts/torch_widen_cost.py [--out chiprun_out/torch_widen_cost.jsonl]

Builds ``deer_vla_tpu_torch/csrc/indexed_matmul_quant.cu`` three ways into
``build/widen_cost/``: as it is (variant 0), without the widen stage of
both tensor-core paths (variant 1: the multiply reads whatever the widened
tiles hold; the barriers stay), and also without the wgmma path's barrier
after the widen (variant 2).  Variants 1 and 2 compute garbage; they bound
what a design that hides the widen entirely could reach.  Each variant
runs K3 (``deer_indexed_matmul_q8``) on one deer_3b decoder layer's four
products at 32 and 256 rows with the plan ``indexed_matmul_quant_plan``
picks, timed by ``chip_smoke.py``'s ``graph_ms`` (CUDA-graph replays
cycling the 12 layers).  One JSON line per product and variant, then the
layer sums, then the card and its power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the widen stage of the mma.sync path's producers, then of the wgmma path
MMA_WIDEN = """      bf16* ws = reinterpret_cast<bf16*>(smem + (kt & 1) * C::W_BYTES);
      widen_tile<Codes, C::BN, C::PRODUCERS>(
          pt, ring + (kt % C::STAGES) * STAGE + C::X_BYTES,
          [&](int r, int c, uint4 v) { *reinterpret_cast<uint4*>(ws + r * C::WLD + c) = v; });
"""
WG_WIDEN_START = "    widen_tile<Codes, C::BN, C::THREADS>(tid, stage + C::X_BYTES, [&](int r, int c, uint4 v) {\n      const int ch"
WG_WIDEN_END = "    __syncthreads();\n"


def variant(src: str, v: int) -> str:
    """The source without the widen stage (v = 1), and also without the
    wgmma path's barrier after it (v = 2)."""
    if v == 0:
        return src
    assert src.count(MMA_WIDEN) == 1 and src.count(WG_WIDEN_START) == 1
    a = src.index(WG_WIDEN_START)
    b = src.index(WG_WIDEN_END, a) + len(WG_WIDEN_END)
    keep_wg = "    deer::fence_proxy_async();\n    __syncthreads();\n" if v == 1 else ""
    return (src[:a] + keep_wg + src[b:]).replace(MMA_WIDEN, "")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "torch_widen_cost.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_widen_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from deer_vla_tpu_torch.ops.kernels import build
    from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")

    work = REPO / "build" / "widen_cost"
    work.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "indexed_matmul_quant.cu").read_text()
    procs = {}
    for v in (0, 1, 2):  # one nvcc each, all started together
        cu, so = work / f"v{v}.cu", work / f"v{v}.so"
        cu.write_text(variant(src, v))
        procs[v] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
             "-shared", str(cu), "-o", str(so), "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for v, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        fn = ctypes.CDLL(str(so)).deer_indexed_matmul_q8
        fn.argtypes, fn.restype = imm._Q_ARGTYPES, ctypes.c_int
        fns[v] = fn

    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    layer = {}
    for prod, k, n in smoke.DECODER_PRODUCTS["deer_3b"]:
        wq, s = smoke.stacked_weights(torch, gen, "indexed_matmul_q8", k, n)
        for m in (32, 256):
            x = torch.randn(m, k, generator=gen,
                            device="cuda").to(torch.bfloat16)
            y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            plan = imm.indexed_matmul_quant_plan(m, k, n, False)
            for v, fn in fns.items():
                it = iter(range(10 ** 9))

                def run():
                    err = fn(x.data_ptr(), wq.data_ptr(), s.data_ptr(),
                             idxs[next(it) % 12].data_ptr(), y.data_ptr(), m,
                             k, n, 12, 1, plan.config, plan.splits,
                             torch.cuda.current_stream().cuda_stream)
                    smoke.check(err == 0, f"variant {v}: CUDA error {err}")

                ms = smoke.graph_ms(torch, run, 48)
                layer[(m, v)] = layer.get((m, v), 0.0) + ms
                emit({"product": prod, "m": m, "variant": v,
                      "config": plan.config, "splits": plan.splits,
                      "ms": ms})
        del wq, s
    emit({"layer_ms": {f"m{m}_variant{v}": ms
                       for (m, v), ms in sorted(layer.items())}})
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
