"""PyTorch port, the micro-batching serving core (``serving/batcher.py``),
on the CPU at deer_tiny width: the cases of the JAX package's
tests/test_server_batched.py on the port's core (concurrent streams in one
dispatch, parked lanes, per-lane thresholds, capacity and busy streams,
lane reuse, the reset / dispatch races, engine errors as 500, the token
cache, stage reuse, window-folded and state lanes, the HTTP surface),
plus one dispatch held against the JAX ``BatchedActionServer`` on the
same bridged weights (equal exits, actions within 2e-4, the tolerance of
tests/test_torch_scan_policy.py), diffusion lanes and the parked lanes'
carry rows restored bit for bit.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxPolicy
from deer_vla_tpu.models.flamingo import init_deer as jax_init
from deer_vla_tpu.serving.batcher import BatchedActionServer as JaxBatcher
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.serving.batcher import BatchedActionServer, _Pending
from deer_vla_tpu_torch.serving.server import DeerActionServer, ServeError
from test_torch_fusion import open_gates
from test_torch_scan_policy import make_params
from test_torch_serving import (INSTRUCTIONS, TOL, payload, post, start,
                                tiny_configs)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, tok = tiny_configs()
    return jcfg, tcfg, make_params(jcfg), tok


def make_core(setup, lanes=4, window_ms=150.0, thresholds=None,
              steps_per_stage=1):
    _, tcfg, params, tok = setup
    pol = ScanDeerPolicy(params, tcfg, thresholds=thresholds or [1e8, 1e8],
                         steps_per_stage=steps_per_stage, device="cpu")
    return BatchedActionServer(pol, tok, lanes=lanes, window_ms=window_ms)


def concurrent_steps(core, payloads):
    results = [None] * len(payloads)

    def run(i):
        results[i] = core.step(payloads[i])

    ts = [threading.Thread(target=run, args=(i,))
          for i in range(len(payloads))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return results


def test_concurrent_streams_one_dispatch(setup):
    core = make_core(setup, window_ms=500.0)
    try:
        core.reset({"stream": "a"})
        core.reset({"stream": "b"})
        outs = concurrent_steps(core, [
            payload("a", 1, "lift the cup"), payload("b", 2, "open the door")])
        for o in outs:
            assert len(o["action"]) == 7 and np.isfinite(o["action"]).all()
        assert outs[0]["batched_with"] == outs[1]["batched_with"] == 2
        assert not np.allclose(outs[0]["action"], outs[1]["action"])
        h = core.healthz()
        assert h["mode"] == "batched" and h["steps"] == 2
        assert h["dispatches"] == 1
        assert h["avg_wasted_layers_per_step"] >= 0.0
        assert (outs[0]["batch_max_exit"] == outs[1]["batch_max_exit"]
                == max(outs[0]["exit_layer"], outs[1]["exit_layer"]))
    finally:
        core.shutdown()


def test_dispatch_matches_jax_batcher(setup):
    """Two streams with a first-exit and a last-exit row, pre-registered
    and stepped at once on both packages' cores, three dispatches: equal
    exits, actions within 2e-4, equal waste counters."""
    jcfg, tcfg, params, tok = setup
    jcore = JaxBatcher(
        JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                  thresholds=[3e-2, 1e8]),
        JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                     max_length=jcfg.text_len), lanes=4, window_ms=500.0)
    tcore = make_core(setup, window_ms=500.0, thresholds=[3e-2, 1e8])
    try:
        for core in (jcore, tcore):
            core.reset({"stream": "a", "thresholds": [1e8, 1e8]})
            core.reset({"stream": "b", "thresholds": [-1e8, 1e8]})
            core.reset({"stream": "c"})
        for t in range(3):
            ps = [payload(n, 10 + 3 * t + i, INSTRUCTIONS[i])
                  for i, n in enumerate("abc")]
            want = concurrent_steps(jcore, ps)
            got = concurrent_steps(tcore, ps)
            for g, w in zip(got, want):
                assert g["exit_layer"] == w["exit_layer"]
                assert g["batch_max_exit"] == w["batch_max_exit"]
                np.testing.assert_allclose(g["action"], w["action"], **TOL)
            assert [g["exit_layer"] for g in got[:2]] == [1, 3]
        # JAX reports the mean to 3 decimals, the port unrounded
        assert (tcore.healthz()["avg_wasted_layers_per_step"] == pytest.approx(
            jcore.healthz()["avg_wasted_layers_per_step"], abs=5e-4))
    finally:
        jcore.shutdown()
        tcore.shutdown()


def test_parked_lane_carry_isolated(setup):
    """B stepping while A sits out must not move A's carry: A's steps
    equal A alone on the server, and A's carry rows come back bit for bit
    after each dispatch it was parked in."""
    core = make_core(setup, window_ms=30.0)
    try:
        a1 = core.step(payload("a", 10))
        lane = core._lane_of["a"]
        before = [c[:, lane].clone() for c in core._engine.carry]
        core.step(payload("b", 11))
        core.step(payload("b", 12))
        for c, b in zip(core._engine.carry, before):
            assert torch.equal(c[:, lane], b)
        a2 = core.step(payload("a", 13))
    finally:
        core.shutdown()
    solo = make_core(setup, window_ms=30.0)
    try:
        s1 = solo.step(payload("a", 10))
        s2 = solo.step(payload("a", 13))
    finally:
        solo.shutdown()
    assert a1["action"] == s1["action"] and a2["action"] == s2["action"]


def test_per_stream_thresholds_and_reset(setup):
    core = make_core(setup)
    try:
        core.reset({"stream": "fast", "thresholds": [1e8, 1e8]})
        core.reset({"stream": "slow", "thresholds": [-1e8, 1e8]})
        outs = concurrent_steps(core, [payload("fast", 20),
                                       payload("slow", 20)])
        assert outs[0]["exit_layer"] == 1
        assert outs[1]["exit_layer"] == 3
        with pytest.raises(ServeError, match="thresholds"):
            core.reset({"stream": "fast", "thresholds": [1.0]})
    finally:
        core.shutdown()


def test_lane_capacity_and_busy(setup):
    core = make_core(setup, lanes=2)
    try:
        core.reset({"stream": "a"})
        core.reset({"stream": "b"})
        with pytest.raises(ServeError, match="limit"):
            core.reset({"stream": "c"})
        core.close({"stream": "b"})
        core.reset({"stream": "c"})  # the freed lane
        core._pending[core._lane_of["a"]] = _Pending(None)
        try:
            with pytest.raises(ServeError, match="busy"):
                core.reset({"stream": "a"})
            with pytest.raises(ServeError, match="busy"):
                core.close({"stream": "a"})
            assert "a" in core._lane_of  # the failed close kept it
        finally:
            core._pending.clear()
    finally:
        core.shutdown()


def test_lane_reuse_restores_default_thresholds(setup):
    core = make_core(setup, lanes=1)
    try:
        core.reset({"stream": "slow", "thresholds": [-1e8, 1e8]})
        core.close({"stream": "slow"})
        assert core.step(payload("fresh", 60))["exit_layer"] == 1
    finally:
        core.shutdown()


def test_reset_waits_out_dispatch(setup):
    core = make_core(setup)
    try:
        core.reset({"stream": "a"})
        with core._cond:
            core._dispatching = True
        done = threading.Event()

        def do_reset():
            core.reset({"stream": "a"})
            done.set()

        threading.Thread(target=do_reset, daemon=True).start()
        assert not done.wait(timeout=0.3), "reset ran during a dispatch"
        with core._cond:
            core._dispatching = False
            core._cond.notify_all()
        assert done.wait(timeout=10), "reset never resumed"
    finally:
        core.shutdown()


def test_new_stream_step_waits_out_dispatch(setup):
    core = make_core(setup)
    try:
        with core._cond:
            core._dispatching = True
        done = threading.Event()

        def do_step():
            core.step(payload("newbie", 11))
            done.set()

        threading.Thread(target=do_step, daemon=True).start()
        assert not done.wait(timeout=0.3)
        with core._cond:
            assert "newbie" not in core._lane_of, \
                "lane allocated during an in-flight dispatch"
            core._dispatching = False
            core._cond.notify_all()
        assert done.wait(timeout=30), "step never resumed"
    finally:
        core.shutdown()


def test_engine_error_is_not_client_error(setup):
    """An engine or kernel failure reaches the client raw (HTTP 500), and
    the core goes on serving; after shutdown a step refuses."""
    core = make_core(setup)
    httpd, base = start(core)
    try:
        def boom(*a, **k):
            raise RuntimeError("indexed_matmul: launch failed")
        core._policy.step_batch = boom
        with pytest.raises(RuntimeError, match="launch failed"):
            core.step(payload("a", 70))
        out = post(base, "/v1/step", payload("a", 71), expect=500)
        assert out["error"] == "RuntimeError: indexed_matmul: launch failed"
        del core._policy.step_batch
        assert len(post(base, "/v1/step", payload("a", 72))["action"]) == 7
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.shutdown()
    with pytest.raises(ServeError, match="shutting down"):
        core.step(payload("a", 73))


def test_failed_dispatch_leaves_every_lane_state(setup):
    """A failure after the step committed the carry (a device fault shows
    at finish_batch's wait): the client gets the error, and no lane's
    carry moves, neither the parked lane's nor the live one's, so the next
    steps equal those of a core that never saw the failed one."""
    core = make_core(setup, window_ms=30.0)
    try:
        core.step(payload("a", 80))
        core.step(payload("b", 81))
        before = [c.clone() for c in core._engine.carry]
        engine = core._engine

        def boom(handles):
            raise RuntimeError("unspecified launch failure")
        engine.finish_batch = boom
        with pytest.raises(RuntimeError, match="launch failure"):
            core.step(payload("b", 82))
        del engine.finish_batch
        for c, b in zip(core._engine.carry, before):
            assert torch.equal(c, b)
        got = [core.step(payload("b", 83)), core.step(payload("a", 84))]
    finally:
        core.shutdown()
    solo = make_core(setup, window_ms=30.0)
    try:
        solo.step(payload("a", 80))
        solo.step(payload("b", 81))
        want = [solo.step(payload("b", 83)), solo.step(payload("a", 84))]
    finally:
        solo.shutdown()
    assert [g["action"] for g in got] == [w["action"] for w in want]


def test_token_cache_bounded(setup):
    core = make_core(setup)
    try:
        core._tok_cache_cap = 3
        for i in range(8):
            core._tokens(f"instruction number {i}")
        assert len(core._tok_cache) <= 3
        assert "instruction number 7" in core._tok_cache
    finally:
        core.shutdown()


def recorded_rows(core):
    log = []
    orig = core._engine.set_threshold_array

    def rec(arr):
        log.append(np.asarray(arr, np.float32).copy())
        return orig(arr)

    core._engine.set_threshold_array = rec
    return log


def test_stage_reuse_per_lane_rows(setup):
    """steps_per_stage 2: a mid-stage dispatch forces the lane's previous
    exit through its row, a fresh stage uses its base row, and a reset
    restarts the lane's stage counter."""
    core = make_core(setup, lanes=2, window_ms=0.0, thresholds=[-1e8, 1e8],
                     steps_per_stage=2)
    try:
        log = recorded_rows(core)
        o1 = core.step(payload("a", 1))
        o2 = core.step(payload("a", 2))
        o3 = core.step(payload("a", 3))
        lane = core._lane_of["a"]
        assert core.healthz()["steps_per_stage"] == 2
        assert o1["exit_layer"] == 3 and o2["exit_layer"] == 3
        d1, d2, d3 = log[:3]
        assert d1[lane, 1] == np.float32(-1e8)
        assert d2[lane, 1] == np.float32(-1e30)
        assert d2[lane, 3] == np.float32(1e30)
        assert d3[lane, 1] == np.float32(-1e8)
        assert o3["exit_layer"] == 3
        core.step(payload("a", 4))
        core.reset({"stream": "a"})
        core.step(payload("a", 5))
        assert log[-1][lane, 1] == np.float32(-1e8)
    finally:
        core.shutdown()


def test_stage_reuse_mixed_phases_share_dispatch(setup):
    core = make_core(setup, lanes=2, window_ms=150.0,
                     thresholds=[-1e8, 1e8], steps_per_stage=2)
    try:
        core.step(payload("a", 1))
        log = recorded_rows(core)
        core.reset({"stream": "b"})
        outs = concurrent_steps(core, [payload("a", 2), payload("b", 3)])
        assert outs[0]["batched_with"] == outs[1]["batched_with"] == 2
        la, lb = core._lane_of["a"], core._lane_of["b"]
        assert log[0][la, 1] == np.float32(-1e30)
        assert log[0][lb, 1] == np.float32(-1e8)
    finally:
        core.shutdown()


def variant(setup, use_hist=False, mode=None, use_state=False, window=2):
    """A window-folded / state deer_tiny in both packages on a JAX draw."""
    jcfg0, tcfg0, _, tok = setup

    def change(cfg):
        return dataclasses.replace(
            cfg, use_hist=use_hist, fusion_mode=mode or cfg.fusion_mode,
            window_size=window, use_state=use_state,
            head=dataclasses.replace(cfg.head, window_size=window,
                                     use_state=use_state))

    jcfg, tcfg = change(jcfg0), change(tcfg0)
    params = open_gates(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), jcfg)))
    return jcfg, tcfg, params, tok


def per_stream_core(tcfg, params, tok):
    return DeerActionServer(ScanDeerPolicy(params, tcfg,
                                           thresholds=[1e8, 1e8],
                                           device="cpu"), tok)


@pytest.mark.parametrize("kind", ["vit_concat", "use_hist"])
def test_batched_folded_matches_per_stream(setup, kind):
    """Window-folded lanes: the rolling per-lane frame window equals the
    per-stream core's, with a parked interferer riding along."""
    _, tcfg, params, tok = variant(
        setup, use_hist=kind == "use_hist",
        mode="vit_concat" if kind == "vit_concat" else None)
    core = BatchedActionServer(ScanDeerPolicy(params, tcfg,
                                              thresholds=[1e8, 1e8],
                                              device="cpu"),
                               tok, lanes=2, window_ms=20.0)
    ref = per_stream_core(tcfg, params, tok)
    try:
        got, want = [], []
        for i, seed in enumerate([30, 31, 32]):
            got.append(core.step(payload("a", seed))["action"])
            if i == 1:
                core.step(payload("b", 99))
            want.append(ref.step(payload("a", seed))["action"])
        np.testing.assert_allclose(got, want, **TOL)
    finally:
        core.shutdown()


def test_batched_state_required_and_matches(setup):
    """State lanes: robot_obs is required, rides the window as per-frame
    rows, and matches the per-stream core; a gripper state the head
    cannot look up is a 400 and an in-range wrap is served."""
    _, tcfg, params, tok = variant(setup, mode="vit_concat", use_state=True)
    core = BatchedActionServer(ScanDeerPolicy(params, tcfg,
                                              thresholds=[1e8, 1e8],
                                              device="cpu"),
                               tok, lanes=2, window_ms=20.0)
    ref = per_stream_core(tcfg, params, tok)
    httpd, base = start(core)
    try:
        with pytest.raises(ServeError, match="robot_obs"):
            core.step(payload("a", 40))
        r = np.random.RandomState(7)
        got, want = [], []
        for seed, g in ((41, 1.0), (42, -3.5)):
            ro = r.randn(tcfg.state_dim)
            ro[-1] = g
            p = payload("a", seed, robot_obs=ro)
            got.append(core.step(p)["action"])
            want.append(ref.step(p)["action"])
        np.testing.assert_allclose(got, want, **TOL)
        ro[-1] = 3.0
        out = post(base, "/v1/step", payload("a", 43, robot_obs=ro),
                   expect=400)
        assert "gripper state" in out["error"]
        out = post(base, "/v1/step", payload("a", 43, robot_obs=ro[:3]),
                   expect=400)
        assert "values" in out["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.shutdown()


@pytest.mark.parametrize("kind", ["vit_concat", "use_hist"])
def test_batched_folded_state_matches_jax_batcher(setup, kind):
    """Window-folded state lanes on both packages' batched cores, one at
    the first exit and one at the last, each parked while the other
    steps: equal
    exits and actions within 2e-4 at every step, so the left-padded frame
    window and the state rows are collated as JAX collates them."""
    jcfg, tcfg, params, tok = variant(
        setup, use_hist=kind == "use_hist", use_state=True,
        mode="vit_concat" if kind == "vit_concat" else None)
    jcore = JaxBatcher(
        JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                  thresholds=[1e8, 1e8]),
        JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                     max_length=jcfg.text_len), lanes=2, window_ms=20.0)
    tcore = BatchedActionServer(ScanDeerPolicy(params, tcfg,
                                               thresholds=[1e8, 1e8],
                                               device="cpu"),
                                tok, lanes=2, window_ms=20.0)
    r = np.random.RandomState(11)
    steps = []
    for i, (stream, seed) in enumerate([("a", 60), ("b", 61), ("a", 62),
                                        ("a", 63)]):
        ro = r.randn(tcfg.state_dim)
        ro[-1] = (1.0, -1.0, -1.5, 1.0)[i]  # -1.5: an in-range wrap
        steps.append(payload(stream, seed, INSTRUCTIONS[i % 3],
                             robot_obs=ro))
    try:
        for core in (jcore, tcore):  # a exits first, b last
            core.reset({"stream": "a", "thresholds": [1e8, 1e8]})
            core.reset({"stream": "b", "thresholds": [-1e8, 1e8]})
        for p in steps:
            want, got = jcore.step(p), tcore.step(p)
            assert got["exit_layer"] == want["exit_layer"] == \
                (1 if p["stream"] == "a" else 3)
            np.testing.assert_allclose(got["action"], want["action"], **TOL)
    finally:
        jcore.shutdown()
        tcore.shutdown()


def test_batched_folded_reset_clears_window(setup):
    _, tcfg, params, tok = variant(setup, mode="vit_concat")
    core = BatchedActionServer(ScanDeerPolicy(params, tcfg,
                                              thresholds=[1e8, 1e8],
                                              device="cpu"),
                               tok, lanes=2, window_ms=20.0)
    try:
        first = core.step(payload("a", 50))["action"]
        core.step(payload("a", 51))
        core.reset({"stream": "a"})
        assert core.step(payload("a", 50))["action"] == first
    finally:
        core.shutdown()


def test_batched_http_surface(setup):
    import json
    import urllib.request
    core = make_core(setup)
    httpd, base = start(core)
    try:
        out = post(base, "/v1/step", payload("h", 30))
        assert len(out["action"]) == 7 and out["batched_with"] == 1
        with urllib.request.urlopen(base + "/healthz") as r:
            h = json.loads(r.read())
        assert h["mode"] == "batched" and h["streams"] == ["h"]
        assert h["quantize"] is None and h["exits"] == [1, 3]
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.shutdown()


def test_batched_diffusion_lanes(setup):
    """Diffusion lanes through BatchedDiffusionSampler: (k, 7) plans, a
    lane's plan is its own (equal to the same stream alone), a parked
    lane's history and counter stay; fc and gpt heads are refused."""
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        BatchedDiffusionSampler
    from test_torch_diffusion import DIFF, diff_params
    from test_torch_heads import configs
    tok = setup[3]
    jcfg, tcfg = configs(DIFF)
    tcfg = dataclasses.replace(tcfg, media_token_id=tok.media_token_id)
    p = diff_params(jcfg)

    def core_of():
        scan = ScanDeerPolicy(p, tcfg, thresholds=[0.1, 1e8], device="cpu")
        return BatchedActionServer(BatchedDiffusionSampler(
            scan, p, seed=0, sample_steps=3), tok, lanes=2, window_ms=300.0)

    core, solo = core_of(), core_of()
    try:
        core.reset({"stream": "a"})
        core.reset({"stream": "b"})
        outs = concurrent_steps(core, [payload("a", 1), payload("b", 2)])
        lane_b = core._lane_of["b"]
        hist = core._policy._hist[lane_b].copy()
        counts = core._policy._counts.copy()
        again = core.step(payload("a", 3))
        np.testing.assert_array_equal(core._policy._hist[lane_b], hist)
        assert core._policy._counts[lane_b] == counts[lane_b]
        k = tcfg.diff_horizon - (tcfg.n_obs_steps - 1)
        for o in outs + [again]:
            plan = np.asarray(o["action"])
            assert plan.shape == (k, 7) and np.isfinite(plan).all()
        s1 = solo.step(payload("a", 1))
        s2 = solo.step(payload("a", 3))
        assert s1["exit_layer"] == outs[0]["exit_layer"]
        np.testing.assert_allclose(s1["action"], outs[0]["action"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s2["action"], again["action"],
                                   rtol=1e-6, atol=1e-6)
    finally:
        core.shutdown()
        solo.shutdown()
    for head in ("gpt", "fc"):
        engine = type("Engine", (), {"cfg": dataclasses.replace(
            tcfg, head_type=head)})()
        with pytest.raises(ServeError, match="per-stream core"):
            BatchedActionServer(engine, tok, lanes=2)
