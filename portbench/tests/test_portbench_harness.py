"""The harness: a cell, a traffic mix and a per-layer metric added as files
and entries alone; the guard against JAX by whole top-level names; the
entry point's refusal without a card."""

import json
import subprocess
import sys
import types

import pytest

import harness
from conftest import BENCH, ROOT, write_tiny


def test_a_new_cell_mix_and_metric_from_files_alone(tmp_path):
    path = write_tiny(tmp_path, "tiny.extra")
    bench = json.loads(path.read_text())
    (tmp_path / "metrics" / "lanes_seen.eval.py").write_text(
        "def read(r):\n    ex = r.get('dispatch_exits')\n"
        "    return None if not ex else float(len(ex[0]))\n")
    bench["per_layer"].append({
        "name": "lanes_seen.eval", "unit": "lanes", "better": "higher",
        "source": "program_counter", "layer": "engine", "moves":
        "env_steps_per_s", "workloads": ["tiny.extra"]})
    path.write_text(json.dumps(bench))
    cell = harness.load_cell("tiny.extra", path, tmp_path)
    assert cell.traffic["lanes"] == 4 and cell.config["name"] == "tiny"
    assert "lanes_seen.eval" in [m["name"] for m in cell.per_layer()]
    assert {m["name"] for m in cell.end_to_end()} >= {"env_steps_per_s",
                                                     "setup_s"}
    got = harness.read_per_layer(cell, {"dispatch_exits": [[1, 1, 3, 1]],
                                        "step_s": [0.1], "window_s": 0.2})
    assert got["lanes_seen.eval"] == {"value": 4.0, "unit": "lanes"}
    assert got["rollout_host_ms.eval"]["value"] == pytest.approx(100.0)
    # a reader that finds nothing to read leaves its metric out
    assert "device_idle.eval" not in got


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.limits, w["name"]
        assert cell.per_layer() and len(cell.end_to_end()) >= 2


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "deer_vla_tpu", raising=False)
    for name in [n for n in sys.modules if n.split(".")[0] in
                 harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "deer_vla_tpu_torch_extra",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deer_vla_tpu.core",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["deer_vla_tpu", "jax"]


def test_judge_compares_the_limits_numbers_and_fails_a_missing_one():
    got = harness.judge({"a": 1.0, "c": 1.0}, {"a": 0.5, "b": 9.0})
    assert got["a"]["ok"] and not got["c"]["ok"] and "b" not in got


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "deer_3b.eval64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""


def test_idle_gaps_are_named_by_the_innermost_open_span():
    from tracing import _name_gaps
    spans = [(0, 10, "rollout.call"), (1, 4, "engine.step_batch"),
             (5, 6, "rollout.env.step"), (7, 9, "rollout.env.step")]
    got = _name_gaps([(2, 3), (4.2, 4.8), (5.2, 5.4), (6.5, 6.6),
                      (10.5, 11)], spans, "rollout.loop")
    assert got == pytest.approx({"engine.step_batch": 1.0,
                                 "rollout.call": 0.7,
                                 "rollout.env.step": 0.2,
                                 "rollout.loop": 0.5})
