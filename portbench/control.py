"""Readings of a rollout cell's output check on many seeds in one
process, each judged by the harness against the cell's limits: the
program as configured ("program"); the same run with the control's
numbers beside it ("low": the reference with fp8 products, the nearest
precision below the configuration's bf16, put in the program's place,
calibrating and serving the same steps from the same carries); or the
program with a fault planted in its engine ("carry": a step that leaves
its state unchanged; "half": the second half of the batch served the
first half's actions; "answer": an action altered where it is made).
The limits in ``portbench/limits/<cell>.json`` are set from these
readings (``PERF.md`` gives them).  The benchmark's own runs never run
this.

    python3 portbench/control.py --workload deer_3b.eval64 \
        --seeds 11,12,13 --mode low,carry [--out control.jsonl]

A seed runs one call at the cell's own 64 lanes whose chains are one
subtask of the mix's longest length, so the check compares the longest
kind of subtask the window serves.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import paths  # noqa: E402

paths.setup_env()

import numpy as np  # noqa: E402


class _Fault:
    """The engine with a fault planted where its outputs are produced."""

    def __init__(self, policy, kind: str):
        self._policy = policy
        self._kind = kind

    def __getattr__(self, name):
        return getattr(self._policy, name)

    def step_batch(self, *args, **kw):
        carry = self._policy.carry
        actions, exits = self._policy.step_batch(*args, **kw)
        actions = np.array(actions)
        if self._kind == "carry":
            self._policy.carry = carry  # the step leaves its state as it was
        elif self._kind == "half":
            half = len(actions) // 2  # the second half gets the first's
            actions[half:2 * half] = actions[:half]
        elif self._kind == "answer":
            actions[:, 0] += 0.1  # an answer altered where it is made
        return actions, exits


FAULTS = ("carry", "half", "answer")


def short_cell(cell):
    """The cell with every chain one subtask of the mix's longest length."""
    c = copy.copy(cell)
    t = dict(cell.traffic)
    t["subtask_steps"] = [max(t["subtask_steps"])]
    t["subtasks_per_chain"] = 1
    c.traffic = t
    return c


def readings(cell, seeds, mode: str, device, log=print) -> list:
    import harness
    import rollout
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        wrap = (lambda e: _Fault(e, mode)) if mode in FAULTS else None
        res = rollout.run(short_cell(cell), seed, None, False, device, t0,
                          low="fp8" if mode == "low" else None, wrap=wrap)
        sides = [("program" if mode == "low" else mode, res["numbers"])]
        if "control" in res:
            sides.append(("low", res["control"]))
        for side, numbers in sides:
            checks = harness.judge(cell.limits, numbers)
            row = {"cell": cell.name, "mode": side, "seed": seed,
                   "numbers": numbers,
                   "correct": all(c["ok"] for c in checks.values()),
                   "failed_checks": sorted(k for k, c in checks.items()
                                           if not c["ok"]),
                   "exit_mix": res["info"]["exit_mix"],
                   "steps": res["info"]["steps"],
                   "tracked": res["info"]["tracked"],
                   "seconds": time.perf_counter() - t0}
            log(json.dumps(row))
            out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program",
                   help="modes, comma separated: program, low, "
                   + ", ".join(FAULTS))
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import harness
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None

    def log(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    modes = args.mode.split(",")
    unknown = set(modes) - {"program", "low", *FAULTS}
    if unknown:
        p.error(f"unknown mode(s): {', '.join(sorted(unknown))}")
    try:
        for mode in modes:
            readings(cell, seeds, mode, torch.device("cuda"), log)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
