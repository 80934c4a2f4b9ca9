"""Fixtures of the benchmark's own CPU tests: the benchmark's modules on
the path, and a throwaway benchmark at deer_tiny size made from files
alone (a configuration, a traffic mix, limits, the metric readers and a
``BENCHMARK.json`` that lists a rollout cell)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips itself without one")


TINY_LIMITS = {"arm_gap": 1e-5, "grip_gap": 1e-5, "exit_gap": 1e-3,
               "threshold_gap": 1e-2, "carry_gap": 1e-5, "start_gap": 0.0}


def write_tiny(root: Path, cell: str = "tiny.t4") -> Path:
    """A benchmark tree under ``root`` with one deer_tiny rollout cell of 4
    lanes; returns the path of its ``BENCHMARK.json``."""
    from deer_vla_tpu_torch.core.config import deer_tiny
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics", dirs_exist_ok=True)
    deer = json.loads(deer_tiny().to_json())
    (root / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "deer_tiny", "registry": "tiny",
         "reduced": [], "deer": deer}))
    t = json.loads((BENCH / "traffic" / "eval64.json").read_text())
    t.update(lanes=4, chains_per_call=4, subtask_steps=[2, 3, 2, 3, 2],
             frame_pool=8, tasks=6, warmup_steps=3, trace_steps=2,
             check={"lanes": 2, "block": 4})
    t["calibration"] = dict(t["calibration"], batches=2)
    (root / "traffic" / "tiny4.json").write_text(json.dumps(t))
    (root / "limits" / f"{cell}.json").write_text(json.dumps(
        {"limits": TINY_LIMITS}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": cell, "config": "tiny", "traffic": "tiny4", "chips": 1,
         "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def _cell(tmp_path, name):
    import torch
    torch.set_num_threads(2)
    import harness
    return harness.load_cell(name, write_tiny(tmp_path), tmp_path)


@pytest.fixture
def tiny(tmp_path):
    return _cell(tmp_path, "tiny.t4")
