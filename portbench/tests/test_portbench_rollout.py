"""The rollout mix and the reference at deer_tiny, on the CPU, through the
harness's own functions: the program as configured agrees with the plain
reference; the control (the reference with fp8 products in the program's
place) and each fault the cell can have (a step that leaves its state
unchanged, half of the batch left out, an answer altered where it is
made) come out not correct; the window closes on the clock; nothing
loaded is JAX or the JAX package."""

import json
import subprocess
import sys
import time

import pytest
import torch

import control
import harness
import rollout
from conftest import BENCH, ROOT


def _numbers(cell, mode, seed=2 ** 31 + 7):
    rows = control.readings(cell, [seed], mode, torch.device("cpu"),
                            log=lambda _: None)
    (row,) = [r for r in rows if r["mode"] == mode]
    assert row["correct"] == all(
        c["ok"] for c in harness.judge(cell.limits, row["numbers"]).values())
    return row["numbers"]


def test_a_run_through_the_harness(tiny):
    out = rollout.run(tiny, 2 ** 31 + 5, None, False, torch.device("cpu"),
                      time.perf_counter())
    checks = harness.judge(tiny.limits, out["numbers"])
    assert all(c["ok"] for c in checks.values()), checks
    # one call: 4 lanes x the 5 subtasks' 12 steps, none of them parked
    assert out["info"]["steps"] == 12 and out["attempted"] == 48
    assert out["e2e"]["env_steps_per_s"] > 0 and out["failed"] == 0
    assert abs(sum(out["info"]["exit_mix"]) - 1) < 1e-6
    got = harness.read_per_layer(tiny, out["readings"])
    assert {"rollout_host_ms.eval", "wasted_layers.eval"} <= set(got)


def test_the_window_closes_on_the_clock(tiny):
    out = rollout.run(tiny, 2 ** 33 + 1, 0.3, False, torch.device("cpu"),
                      time.perf_counter())
    info = out["info"]
    # the first step after the close is not dispatched; the window's time
    # ends with the last env steps taken
    assert 0.3 <= info["window_s"] and info["steps"] >= 1
    assert out["attempted"] == 4 * info["steps"]
    assert all(c["ok"] for c in harness.judge(
        tiny.limits, out["numbers"]).values())


def test_the_tracked_lanes_cover_every_block_of_the_batch():
    for seed in (0, 7, 2 ** 31 + 11):
        got = rollout.tracked_lanes(64, 4, seed)
        assert [g // 16 for g in got] == [0, 1, 2, 3]


def test_every_seed_runs_the_same_work(tiny):
    from rollout import Inputs
    lens = []
    for seed in (1, 2 ** 31 + 3):
        inp = Inputs(tiny.traffic, tiny.config, seed)
        seqs, _, lengths = inp.call(0)
        lens.append(sorted(sorted(lengths[n] for n in chain)
                           for _, chain in seqs))
        assert {sum(lengths[n] for n in chain) for _, chain in seqs} == {12}
    assert lens[0] == lens[1]


@pytest.mark.parametrize("mode", ["low", "carry", "half", "answer"])
def test_the_control_and_each_fault_are_not_correct(tiny, mode):
    checks = harness.judge(tiny.limits, _numbers(tiny, mode))
    assert not all(c["ok"] for c in checks.values()), checks


def test_program_as_configured_is_correct(tiny):
    checks = harness.judge(tiny.limits, _numbers(tiny, "program"))
    assert all(c["ok"] for c in checks.values()), checks


def test_nothing_loaded_is_jax(tmp_path):
    code = f"""
import sys, time, json
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}, {str(BENCH / 'tests')!r}]
from pathlib import Path
import torch; torch.set_num_threads(2)
import harness, rollout
from conftest import write_tiny
path = write_tiny(Path({str(tmp_path)!r}))
cell = harness.load_cell("tiny.t4", path, Path({str(tmp_path)!r}))
rollout.run(cell, 5, None, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(harness.forbidden_modules()))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.card
def test_a_tiny_run_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = rollout.run(tiny, 9, None, True, torch.device("cuda"),
                      time.perf_counter())
    checks = harness.judge(tiny.limits, out["numbers"])
    assert all(c["ok"] for c in checks.values()), checks
    assert out["readings"]["trace"]["busy_s"] > 0
