"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's files are found from ``BENCHMARK.json`` (``harness.Cell``); the
traffic file's ``kind`` names the module that drives it.  The last line
of standard output is the result; the last lines of standard error are
the output check's numbers beside their limits.  Without a CUDA device
(or with fewer than the cell asks for) it prints no result and exits 2;
with JAX or the JAX package loaded after the window, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import paths  # noqa: E402

paths.setup_env()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import harness
    cell = harness.load_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    kind = importlib.import_module(cell.traffic["kind"])
    out = kind.run(cell, args.seed % 2 ** 63, args.seconds,
                   bool(args.trace), torch.device("cuda"), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = harness.judge(cell.limits, out["numbers"])
    if args.trace:
        metrics = harness.read_per_layer(cell, out["readings"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["info"]["peak_bytes"]}
    result = {"correct": bool(checks) and all(c["ok"]
                                              for c in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    red = out["readings"].get("trace")
    if red is not None:
        from tracing import breakdown
        device["busy_s"] = red["busy_s"]
        device["window_s"] = red["window_s"]
        result["breakdown"] = breakdown(red)
    result["info"] = dict(out["info"], numbers=out["numbers"])
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
