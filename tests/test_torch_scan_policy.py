"""PyTorch port, the whole dynamic-exit serving step: the port's
ScanDeerPolicy against the JAX ScanDeerPolicy on the same bridged deer_tiny
weights and the same inputs, on the CPU.

exit_layer must be equal for every stream and timestep; actions, gripper
and carry must agree within 2e-4 (the tolerance tests/test_scan_policy.py
holds the JAX engines to).  The cross-attention gates are set non-zero so
that the vision path reaches the actions (the init leaves them at zero).
"""

import copy
import dataclasses
import gc
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxPolicy
from deer_vla_tpu.models.flamingo import init_deer
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
THRESHOLDS = [[1e8, 1e8], [-1.0, 1e8], [0.05, 1e8]]


def make_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray,
                          init_deer(jax.random.PRNGKey(seed), jcfg))
    r = np.random.RandomState(seed + 100)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return params


def obs(cfg, b, seed):
    """Images, token ids with the media token at position 2 (not 0), and a
    padding mask that cuts the last streams short."""
    r = np.random.RandomState(seed)
    hw, s = cfg.vit.image_size, cfg.text_len
    img = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    ids = r.randint(0, cfg.media_token_id, size=(b, s)).astype(np.int32)
    ids[:, 2] = cfg.media_token_id
    mask = np.ones((b, s), np.int32)
    for i in range(1, b):
        mask[i, s - i:] = 0
    return img, grip, ids, mask


def pair(jcfg, tcfg, params, indexed_mm, exit_ids=None):
    jp = jax.tree.map(jnp.asarray, params)
    return (JaxPolicy(jp, jcfg, exit_ids=exit_ids, indexed_mm=indexed_mm),
            ScanDeerPolicy(params, tcfg, exit_ids=exit_ids,
                           indexed_mm=indexed_mm, device="cpu"))


def assert_same_carry(jpol, tpol):
    for cj, ct in zip(jpol.carry, tpol.carry):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    params = make_params(jcfg)
    return jcfg, tcfg, {imm: pair(jcfg, tcfg, params, imm)
                        for imm in (False, True)}


@pytest.fixture(scope="module")
def six_layers():
    """6 layers with the non-uniform exits [1, 2, 5] (one layer per loop
    iteration instead of strided segments)."""
    jcfg, tcfg = jconfig.deer_tiny(n_layers=6), tconfig.deer_tiny(n_layers=6)
    params = make_params(jcfg, seed=1)
    return jcfg, tcfg, {imm: pair(jcfg, tcfg, params, imm, [1, 2, 5])
                        for imm in (False, True)}


@pytest.mark.parametrize("indexed_mm", [False, True])
@pytest.mark.parametrize("th", THRESHOLDS)
def test_step_matches_jax(tiny, indexed_mm, th):
    jcfg, tcfg, pols = tiny
    jpol, tpol = pols[indexed_mm]
    for p in (jpol, tpol):
        p.set_thresholds(th)
        p.reset()
    for t in range(3):
        img, grip, ids, mask = obs(tcfg, 1, seed=t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                        jnp.asarray(ids), jnp.asarray(mask))
        a_t = tpol.step(img, grip, ids, mask)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        assert a_t.shape == (7,) and set(np.abs(a_t[-1:])) == {1.0}
        np.testing.assert_allclose(a_t, a_j, **TOL)
        assert_same_carry(jpol, tpol)


def run_batch(jpol, tpol, rows, cfg, b, steps=3):
    jpol.set_thresholds_batch(rows)
    tpol.set_thresholds_batch(rows)
    for p in (jpol, tpol):
        p.reset()
    seen = set()
    for t in range(steps):
        img, grip, ids, mask = obs(cfg, b, seed=10 + t)
        acts_j, ex_j = jpol.step_batch(jnp.asarray(img), jnp.asarray(grip),
                                       jnp.asarray(ids), jnp.asarray(mask))
        acts_t, ex_t = tpol.step_batch(img, grip, ids, mask)
        assert acts_t.shape == (b, 7) and ex_t.dtype == np.int64
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
        assert_same_carry(jpol, tpol)
        seen |= set(ex_t.tolist())
    return seen


@pytest.mark.parametrize("indexed_mm", [False, True])
def test_step_batch_per_stream_rows_match_jax(tiny, indexed_mm):
    jcfg, tcfg, pols = tiny
    rows = THRESHOLDS + [[0.02, 1e8]]
    seen = run_batch(*pols[indexed_mm], rows, tcfg, b=4)
    assert seen == {1, 3}


@pytest.mark.parametrize("indexed_mm", [False, True])
def test_non_uniform_exits_match_jax(six_layers, indexed_mm):
    jcfg, tcfg, pols = six_layers
    jpol, tpol = pols[indexed_mm]
    assert tpol.exits == jpol.exits == [1, 2, 5]
    for th in ([1e8, 1e8, 1e8], [-1.0, 1e8, 1e8], [-1.0, -1.0, 1e8]):
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for t in range(2):
            img, grip, ids, mask = obs(tcfg, 1, seed=20 + t)
            a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                            jnp.asarray(ids), jnp.asarray(mask))
            a_t = tpol.step(img, grip, ids, mask)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(a_t, a_j, **TOL)
            assert_same_carry(jpol, tpol)
    rows = [[1e8, 1e8, 1e8], [-1.0, 1e8, 1e8], [-1.0, -1.0, 1e8]]
    assert run_batch(jpol, tpol, rows, tcfg, b=3, steps=2) == {1, 2, 5}


def test_steps_per_stage_reuses_the_exit_layer(tiny):
    jcfg, tcfg, pols = tiny
    jpol, tpol = pols[False]
    for p in (jpol, tpol):
        p.set_thresholds([-1.0, 1e8])
        p.reset()
        p.steps_per_stage = 2
    try:
        for t in range(3):
            img, grip, ids, mask = obs(tcfg, 1, seed=30 + t)
            if t == 1:  # mid-stage: the exit is forced to the last one
                for p in (jpol, tpol):
                    p.set_thresholds([1e8, 1e8])
            for p in (jpol, tpol):
                p.set_timestep(t)
            a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                            jnp.asarray(ids), jnp.asarray(mask))
            a_t = tpol.step(img, grip, ids, mask)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(a_t, a_j, **TOL)
        assert tpol.last_exit_layer == 1
    finally:
        for p in (jpol, tpol):
            p.steps_per_stage = 1


def test_multi_step_action_plans_match_jax():
    """multi_step_action k=2: (k, 7) plans from step, (B, k, 7) from
    step_batch, exits compared over the whole 12-wide arm plan."""
    jcfg, tcfg = (dataclasses.replace(
        c, head=dataclasses.replace(c.head, multi_step_action=2))
        for c in (jconfig.deer_tiny(), tconfig.deer_tiny()))
    jpol, tpol = pair(jcfg, tcfg, make_params(jcfg, seed=2), False)
    for p in (jpol, tpol):
        p.set_thresholds([0.05, 1e8])
    for t in range(2):
        img, grip, ids, mask = obs(tcfg, 1, seed=50 + t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                        jnp.asarray(ids), jnp.asarray(mask))
        a_t = tpol.step(img, grip, ids, mask)
        assert a_t.shape == (2, 7)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        np.testing.assert_allclose(a_t, a_j, **TOL)
    rows = [[1e8, 1e8], [-1.0, 1e8]]
    jpol.set_thresholds_batch(rows)
    tpol.set_thresholds_batch(rows)
    img, grip, ids, mask = obs(tcfg, 2, seed=60)
    acts_j, ex_j = jpol.step_batch(jnp.asarray(img), jnp.asarray(grip),
                                   jnp.asarray(ids), jnp.asarray(mask))
    acts_t, ex_t = tpol.step_batch(img, grip, ids, mask)
    assert acts_t.shape == (2, 2, 7)
    np.testing.assert_array_equal(ex_t, ex_j)
    np.testing.assert_allclose(acts_t, acts_j, **TOL)
    assert_same_carry(jpol, tpol)


def test_reset_streams_zeroes_only_those_streams(tiny):
    _, tcfg, pols = tiny
    tpol = pols[False][1]
    tpol.set_thresholds_batch(THRESHOLDS)
    tpol.reset()
    tpol.step_batch(*obs(tcfg, 3, seed=40))
    before = tpol.carry[0].clone()
    tpol.reset_streams(np.array([False, True, False]))
    after = tpol.carry[0]
    assert not after[:, 1].any()
    assert torch.equal(after[:, 0], before[:, 0])
    assert torch.equal(after[:, 2], before[:, 2])


def test_token_ids_out_of_range_raise(tiny):
    _, tcfg, pols = tiny
    tpol = pols[False][1]
    img, grip, ids, mask = obs(tcfg, 1, seed=0)
    for bad in (tcfg.mpt.vocab_size, -1):
        ids_bad = ids.copy()
        ids_bad[0, 5] = bad
        with pytest.raises(ValueError, match="token ids"):
            tpol.step(img, grip, ids_bad, mask)


def test_threshold_row_layout(tiny):
    _, tcfg, pols = tiny
    jpol, tpol = pols[False]
    for th in ([0.3, 0.7], {1: 0.3, 3: 0.7}):
        np.testing.assert_array_equal(tpol.threshold_row(th),
                                      jpol.threshold_row(th))
    with pytest.raises(ValueError):
        tpol.threshold_row([0.1])
    assert dataclasses.asdict(tcfg)["mpt"]["n_layers"] == 4


# ---------------------------------------------------------------------------
# the asynchronous dispatch (eval/step_worker.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fresh(tiny):
    """A port engine of its own for the dispatch tests, and its weights."""
    jcfg, tcfg, _ = tiny
    params = make_params(jcfg)
    return tcfg, params, ScanDeerPolicy(params, tcfg, device="cpu")


def held(pol, gate: threading.Event, seen: list = None):
    """``pol.run_batch`` held back until ``gate`` is set; ``seen`` gets the
    thread, modes and intra-op thread count it ran under."""
    real = pol.run_batch

    def run(*args, **kw):
        if seen is not None:
            seen.append((threading.current_thread(),
                         torch.is_inference_mode_enabled(),
                         torch.is_grad_enabled(), torch.get_num_threads()))
        assert gate.wait(60)
        return real(*args, **kw)
    return run


def test_dispatch_batch_returns_before_the_step_runs(fresh):
    tcfg, _, pol = fresh
    pol.reset()
    gate, seen = threading.Event(), []
    pol.run_batch = held(pol, gate, seen)
    try:
        handle = pol.dispatch_batch(*obs(tcfg, 2, seed=50))
        assert not handle.done()
        # the step owns the carry and the thresholds until it is finished
        for touch in (lambda: pol.reset_streams([True, False]),
                      lambda: pol.set_thresholds([0.1, 1e8]),
                      lambda: pol.dispatch_batch(*obs(tcfg, 2, seed=51))):
            with pytest.raises(RuntimeError, match="in flight"):
                touch()
        gate.set()
        acts, exits = pol.finish_batch(handle)
    finally:
        gate.set()
        del pol.run_batch
    assert acts.shape == (2, 7) and exits.shape == (2,)
    assert seen[0][0] is not threading.main_thread()
    pol.reset_streams([True, False])  # idle again


def test_finish_batch_raises_the_steps_error(fresh):
    tcfg, _, pol = fresh

    def boom(*args, **kw):
        raise ValueError("the step failed")
    pol.run_batch = boom
    try:
        handle = pol.dispatch_batch(*obs(tcfg, 2, seed=52))
        with pytest.raises(ValueError, match="the step failed"):
            pol.finish_batch(handle)
    finally:
        del pol.run_batch
    pol.reset()  # the failed step left the engine idle
    pol.finish_batch(pol.dispatch_batch(*obs(tcfg, 2, seed=52)))


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_dispatches_equal_step_batches_under_the_callers_modes(fresh, mode):
    """Two dispatches on one engine are two step_batch calls, carries
    included, bit for bit; the worker runs them under the caller's grad
    and inference modes."""
    tcfg, params, pol = fresh
    other = ScanDeerPolicy(params, tcfg, device="cpu")
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    rows = [[1e8, 1e8], [2e-3, 1e8]]
    for p in (pol, other):
        p.set_thresholds_batch(rows)
        p.reset()
    gate, seen = threading.Event(), []
    gate.set()
    pol.run_batch = held(pol, gate, seen)
    try:
        with ctx():
            for t in range(2):
                inputs = obs(tcfg, 2, seed=60 + t)
                got = pol.finish_batch(pol.dispatch_batch(*inputs))
                want = other.step_batch(*inputs)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                for a, b in zip(pol.carry, other.carry):
                    assert torch.equal(a, b)
                    assert a.is_inference() == b.is_inference()
    finally:
        del pol.run_batch
    assert all(s[1] == (mode == "inference") for s in seen)
    assert all(s[2] == (mode == "grad") for s in seen)
    # OpenMP keeps a thread count a thread: the CPU's sums split by it
    assert all(s[3] == torch.get_num_threads() for s in seen)


def test_copies_share_one_worker_and_closing_stops_it(fresh):
    """Shallow copies (the rollout's lane groups) share the worker, so
    their steps run in dispatch order; close() stops the thread, a later
    dispatch starts one, and a collected engine stops its own."""
    tcfg, params, pol = fresh
    a = ScanDeerPolicy(params, tcfg, device="cpu")
    b = copy.copy(a)
    a.reset(), b.reset()
    assert b._worker is a._worker
    order = []
    for p, name in ((a, "a"), (b, "b")):
        real = p.run_batch

        def run(*args, real=real, name=name, **kw):
            order.append(name)
            return real(*args, **kw)
        p.run_batch = run
    ha = a.dispatch_batch(*obs(tcfg, 2, seed=70))
    hb = b.dispatch_batch(*obs(tcfg, 2, seed=71))
    b.finish_batch(hb)
    a.finish_batch(ha)
    assert order == ["a", "b"]
    worker = a._worker
    assert worker.alive
    a.close()
    assert not worker.alive
    del a.run_batch, b.run_batch
    a.finish_batch(a.dispatch_batch(*obs(tcfg, 2, seed=72)))
    assert worker.alive
    del a, b
    gc.collect()
    assert not worker.alive


def test_dispatch_stress_many_copies_keep_their_carries(fresh):
    """More lane groups than cores dispatching together under a short
    switch interval: every copy's actions and carry equal its own
    step_batch chain's, so no step wrote another copy's carry."""
    tcfg, _, pol = fresh
    copies = [copy.copy(pol) for _ in range(12)]
    refs = [copy.copy(pol) for _ in range(12)]
    for p in copies + refs:
        p.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in range(2):
            inputs = [obs(tcfg, 2, seed=100 * t + i) for i in range(12)]
            handles = [p.dispatch_batch(*x) for p, x in zip(copies, inputs)]
            for h in handles:
                h.future.result(timeout=120)
            for i in reversed(range(12)):
                got = copies[i].finish_batch(handles[i])
                want = refs[i].step_batch(*inputs[i])
                np.testing.assert_array_equal(got[0], want[0])
                for a, b in zip(copies[i].carry, refs[i].carry):
                    assert torch.equal(a, b)
    finally:
        sys.setswitchinterval(interval)
