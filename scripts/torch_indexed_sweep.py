"""Every block config and K split of the layer-indexed matmuls on one GPU.

    python3 scripts/torch_indexed_sweep.py [--kernels indexed_matmul_q8,...]
        [--rows 32,256] [--out chiprun_out/torch_indexed_sweep.jsonl]

For each kernel (K2 ``indexed_matmul``, K3 ``indexed_matmul_q8``, K4
``indexed_matmul_q4``; default K3 and K4), each deer_3b decoder product,
each row count, each block config and each legal split of K over a
thread-block cluster (1, 2, 4, 8, not only the plan's), checks the kernel
against its plain version at one layer and times it with
``chip_smoke.py``'s ``graph_ms`` (device time of one call from CUDA-graph
replays cycling the 12 layers).  It prints one JSON line per case and, last,
the card and its power limit; the lines also go to ``--out``.  This is where
a plan's choice of config and split is checked against the alternatives.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="indexed_matmul_q8,indexed_matmul_q4")
    ap.add_argument("--rows", default="32,256")
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "torch_indexed_sweep.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_indexed_sweep: no CUDA device", file=sys.stderr)
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

    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    for kernel in args.kernels.split(","):
        fn, plain, plan_of, configs = smoke.indexed_kernel(kernel)
        for prod, k, n in smoke.DECODER_PRODUCTS["deer_3b"]:
            w = smoke.stacked_weights(torch, gen, kernel, k, n)
            for m in map(int, args.rows.split(",")):
                x = torch.randn(m, k, generator=gen,
                                device="cuda").to(torch.bfloat16)
                planned = plan_of(m, k, n)
                ref = plain(x, *w, idxs[3]).float()
                tol = smoke.K2_REL_TOL["bfloat16"] * ref.abs().max().item()
                for c in range(len(configs)):
                    if n % configs[c].bn:
                        continue
                    base = plan_of(m, k, n, config=c)
                    for splits in (1, 2, 4, 8):
                        if k % (64 * splits) or base.bm % splits:
                            continue
                        plan = base._replace(
                            splits=splits,
                            blocks=splits * base.m_chunks * base.strips,
                            k_slice=k // splits)
                        err = (fn(x, *w, idxs[3], plan=plan).float()
                               - ref).abs().max().item()
                        smoke.check(err <= tol, f"{kernel} {prod} m={m} "
                                                f"config {c} splits {splits}: "
                                                f"{err} > {tol}")
                        it = iter(range(10 ** 9))
                        ms = smoke.graph_ms(torch, lambda: fn(
                            x, *w, idxs[next(it) % 12], plan=plan), 48)
                        emit({"kernel": kernel, "product": prod, "m": m,
                              "config": c, "splits": splits,
                              "blocks": plan.blocks,
                              "planned": (c, splits) == (planned.config,
                                                         planned.splits),
                              "ms": ms, "max_abs_err": err,
                              "tolerance": tol})
            del w
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
