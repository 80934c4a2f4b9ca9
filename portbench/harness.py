"""What every cell of the benchmark shares: finding a cell's files by name,
building the program's configuration from a configuration file, the
per-layer metric readers, the guard against JAX, and the result line.

A cell is found from ``BENCHMARK.json`` alone: its ``config`` names
``portbench/configs/<config>.json``, its ``traffic`` names
``portbench/traffic/<traffic>.json`` (whose ``kind`` names the module that
reads it), the limits of its output check are ``portbench/limits/<cell>.json``
and each per-layer metric is read by ``portbench/metrics/<metric>.py``.
A later cell, mix or metric is new files and new entries, no edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deer_vla_tpu")


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, spec: dict, bench: dict, root: Path = BENCH_DIR):
        self.spec = spec
        self.name = spec["name"]
        self.chips = int(spec["chips"])
        self.bench = bench
        self.config = _load(root / "configs" / f"{spec['config']}.json")
        self.traffic = _load(root / "traffic" / f"{spec['traffic']}.json")
        lim = root / "limits" / f"{self.name}.json"
        self.limits = _load(lim)["limits"] if lim.exists() else {}
        self.root = root

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self._mine(m)]

    def per_layer(self) -> List[dict]:
        """This cell's per-layer metrics: those that list it, and those
        without a list whose end-to-end metric this cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def _mine(self, m: dict) -> bool:
        return "workloads" not in m or self.name in m["workloads"]

    def reader(self, metric: str) -> Callable:
        """``read(readings) -> float or None`` of a per-layer metric."""
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: Optional[Path] = None,
              root: Path = BENCH_DIR) -> Cell:
    bench_path = bench_path or root.parent / "BENCHMARK.json"
    bench = _load(bench_path)
    for spec in bench["workloads"]:
        if spec["name"] == name:
            return Cell(spec, bench, root)
    raise SystemExit(f"no workload {name!r} in {bench_path}")


def deer_config(config: dict):
    """The program's ``DeerConfig`` of a configuration file's ``deer``
    block (the fields of ``DeerConfig.to_json``)."""
    from deer_vla_tpu_torch.core.config import DeerConfig
    return DeerConfig.from_json(json.dumps(config["deer"]))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (the port's own name begins with the latter's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def read_per_layer(cell: Cell, readings: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer():
        value = cell.reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(limits: Dict[str, float], numbers: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each number the cell's limits file names, beside its limit; one
    that the check did not produce fails."""
    return {k: {"value": numbers.get(k), "limit": lim,
                "ok": k in numbers and numbers[k] <= lim}
            for k, lim in limits.items()}


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The last lines of stderr (each number compared beside its limit),
    then the result as the last line of stdout, its ``checks`` last."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    print(json.dumps(line, default=float), flush=True)
