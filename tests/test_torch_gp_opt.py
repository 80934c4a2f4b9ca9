"""The port's GP minimizer (``utils/gp_opt.py``) bit for bit against the
JAX package's, and its profiling and crash-record utilities
(``utils/profiling.py``, ``utils/errors.py``)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from deer_vla_tpu.utils import gp_opt as jax_gp
from deer_vla_tpu_torch.utils import gp_opt as torch_gp
from deer_vla_tpu_torch.utils.errors import record
from deer_vla_tpu_torch.utils.profiling import MetricLogger, Timer, trace

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BOUNDS = [(-1.0, 1.0), (-0.5, 1.5)]


def quadratic(p) -> float:
    return sum((x - 0.3) ** 2 for x in p)


def bumpy(p) -> float:
    return quadratic(p) + 0.1 * np.sin(5 * p[0])


def fields(result) -> dict:
    return dataclasses.asdict(result)


WARM = {"cold": {}, "warm": {"x0": [[0.1, 0.2]], "y0": [bumpy([0.1, 0.2])]}}


@pytest.mark.parametrize("warm", sorted(WARM))
@pytest.mark.parametrize("acq", ["EI", "LCB", "PI"])
def test_gp_minimize_lite_bit_equal_to_jax(acq, warm):
    kw = dict(n_calls=10, acq_func=acq, random_state=3, n_candidates=512,
              **WARM[warm])
    want = jax_gp.gp_minimize_lite(bumpy, BOUNDS, **kw)
    got = torch_gp.gp_minimize_lite(bumpy, BOUNDS, **kw)
    assert fields(got) == fields(want)
    assert len(got.x_iters) == 10 + len(WARM[warm].get("x0", []))


@pytest.mark.parametrize("warm", sorted(WARM))
@pytest.mark.parametrize("acq", ["EI", "LCB", "PI"])
def test_gp_minimize_lite_batch_bit_equal_to_jax(acq, warm):
    calls = []

    def batch(points):
        calls.append(len(points))
        return [bumpy(p) for p in points]

    kw = dict(q=3, n_calls=9, acq_func=acq, random_state=5,
              n_candidates=512, **WARM[warm])
    want = jax_gp.gp_minimize_lite_batch(batch, BOUNDS, **kw)
    n_jax = list(calls)
    calls.clear()
    got = torch_gp.gp_minimize_lite_batch(batch, BOUNDS, **kw)
    assert fields(got) == fields(want)
    assert calls == n_jax and set(calls) == {3}


def test_gp_minimize_lite_no_initial_points_matches_jax():
    """n_initial=0 without a warm start: both seed the GP with the box
    center."""
    kw = dict(n_calls=6, n_initial=0, random_state=0, n_candidates=256)
    want = jax_gp.gp_minimize_lite(quadratic, BOUNDS, **kw)
    got = torch_gp.gp_minimize_lite(quadratic, BOUNDS, **kw)
    assert fields(got) == fields(want)
    assert got.x_iters[0] == [0.0, 0.5]


def test_gp_minimize_converges_on_a_quadratic():
    res = torch_gp.gp_minimize_lite(quadratic, [(-1.0, 1.0)] * 2,
                                    n_calls=25, random_state=0)
    assert res.fun < 0.05, (res.x, res.fun)


def test_gp_warm_start_mismatch_raises():
    with pytest.raises(ValueError, match="warm-start"):
        torch_gp.gp_minimize_lite(quadratic, BOUNDS, x0=[[0.0, 0.0]],
                                  y0=[], n_calls=2)
    with pytest.raises(ValueError, match="values for"):
        torch_gp.gp_minimize_lite_batch(lambda pts: [0.0], BOUNDS, q=2,
                                        n_calls=2)


def test_timer_and_metric_logger(tmp_path):
    """JAX ``tests/test_misc.py::test_timer_and_metric_logger``, and the
    logger's float conversion of tensors and numpy scalars."""
    with Timer("t") as t:
        sum(range(1000))
    assert t.ms >= 0
    with Timer("cpu", sync_on={"a": [torch.ones(2)]}) as t2:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t2.ms >= 0
    p = tmp_path / "m.jsonl"
    ml = MetricLogger(str(p))
    ml.log({"loss": 1.5, "step": 1})
    ml.log({"loss": torch.tensor(0.25), "gn": np.float32(2.0)})
    ml.close()
    recs = [json.loads(line) for line in p.read_text().splitlines()]
    assert recs[0]["loss"] == 1.5 and "ts" in recs[0]
    assert recs[1]["loss"] == 0.25 and recs[1]["gn"] == 2.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert data["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_record_writes_a_crash_record_and_reraises(tmp_path, monkeypatch):
    path = tmp_path / "crash.jsonl"
    monkeypatch.setenv("DEER_ERROR_FILE", str(path))

    @record
    def boom(x):
        raise ValueError(f"bad {x}")

    with pytest.raises(ValueError, match="bad 3"):
        boom(3)
    rec = json.loads(path.read_text().strip())
    assert rec["error"] == "ValueError('bad 3')"
    assert rec["entry"].endswith("boom")
    assert "Traceback" in rec["traceback"] and rec["pid"] > 0
    assert {"ts", "host", "argv"} <= set(rec)
    assert "process_index" not in rec  # no process group here

    explicit = tmp_path / "explicit.jsonl"

    @record(error_file=str(explicit))
    def boom2():
        raise RuntimeError("x")

    with pytest.raises(RuntimeError):
        boom2()
    assert json.loads(explicit.read_text())["error"] == "RuntimeError('x')"


def test_record_lets_systemexit_through(tmp_path, monkeypatch):
    path = tmp_path / "crash.jsonl"
    monkeypatch.setenv("DEER_ERROR_FILE", str(path))

    @record
    def leave():
        raise SystemExit("done")

    @record
    def fine(a, b=2):
        return a + b

    with pytest.raises(SystemExit, match="done"):
        leave()
    assert fine(1, b=3) == 4
    assert not path.exists()


def test_every_port_cli_main_is_recorded(tmp_path, monkeypatch):
    """Each port CLI main is wrapped: a failure leaves a crash record."""
    from deer_vla_tpu_torch.cli import (bayes_opt, convert, eval,
                                        eval_ckpts, gen_sequences, serve,
                                        train)
    path = tmp_path / "crash.jsonl"
    monkeypatch.setenv("DEER_ERROR_FILE", str(path))
    mains = [m.main for m in (bayes_opt, convert, eval, eval_ckpts,
                              gen_sequences, serve, train)]
    assert all(hasattr(m, "__wrapped__") for m in mains)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval.main(["--debug", "--model", "tiny"])
    assert "eval.main" in json.loads(path.read_text())["entry"]
