"""PyTorch port, batched serving against the JAX package on the CPU: the
host-sequenced ``BatchedDeerPolicy`` (``eval/batched_policy.py``) and the
batched rollout's lane groups and threaded env stepping
(``eval/batched_rollout.py``, ``pipeline`` / ``env_workers``), on the same
bridged deer_tiny weights (the JAX tests/test_batched_policy.py and
tests/test_batched_rollout.py cases).

Exit layers must be equal for every stream and step, actions and carries
within 2e-4 (tests/test_torch_scan_policy.py's tolerance).  Rollout reports
are discrete (per-chain results, exit histograms, the per-task table, the
lockstep-waste counts) and must be equal: the port's ``pipeline=2`` to its
``pipeline=1`` and to JAX's ``pipeline=2``, ``env_workers=2`` to serial.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval import batched_rollout as jbatched
from deer_vla_tpu.eval import rollout as jrollout
from deer_vla_tpu.eval.batched_policy import BatchedDeerPolicy as JaxBatched
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScan
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import batched_rollout as tbatched
from deer_vla_tpu_torch.eval import rollout as trollout
from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy

from test_torch_policy import TH, make_params, obs

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread keeps them
    from waiting on a pool the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
REPORT_KEYS = ("avg_seq_len", "chain_sr", "success_exit_hist",
               "fail_exit_hist", "avg_exit_layer", "total_success_steps",
               "task_info", "batched_exit_waste")
NEVER = [-1.0, 1e8]   # every stream runs to the last exit
ALWAYS = [1e8, 1e8]   # every stream exits at the first


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.deer_tiny()
    return jcfg, tconfig.deer_tiny(), make_params(jcfg)


def batched_pair(tiny, b, th, steps_per_stage=1):
    jcfg, tcfg, params = tiny
    return (JaxBatched(jax.tree.map(jnp.asarray, params), jcfg, batch=b,
                       thresholds=th, steps_per_stage=steps_per_stage),
            BatchedDeerPolicy(params, tcfg, batch=b, thresholds=th,
                              steps_per_stage=steps_per_stage, device="cpu"))


def step_both(jp, tp, cfg, b, seed):
    img, grip, ids, mask = obs(cfg, b, seed)
    acts_j, ex_j = jp.step(jnp.asarray(img), jnp.asarray(grip),
                           jnp.asarray(ids), jnp.asarray(mask))
    acts_t, ex_t = tp.step(img, grip, ids, mask)
    np.testing.assert_array_equal(ex_t, np.asarray(ex_j))
    np.testing.assert_allclose(acts_t, np.asarray(acts_j), **TOL)
    for ct, cj in zip(tp.carry, jp.carry):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    return acts_t, ex_t


def test_batched_policy_matches_jax(tiny):
    jp, tp = batched_pair(tiny, 4, TH)
    seen = set()
    for t in range(3):
        acts, ex = step_both(jp, tp, tiny[1], 4, seed=t)
        assert acts.shape == (4, 7)
        seen |= set(ex.tolist())
    assert seen == {1, 3}


def test_batched_policy_full_depth_matches_single_stream(tiny):
    """Forced to the last exit, stream 0 equals DeerPolicy at B=1."""
    _, tcfg, params = tiny
    bp = BatchedDeerPolicy(params, tcfg, batch=3, thresholds=NEVER,
                           device="cpu")
    sp = DeerPolicy(params, tcfg, exit_id=tcfg.n_layers - 1, device="cpu")
    img, grip, ids, mask = obs(tcfg, 3, seed=4)
    for _ in range(3):
        acts, exits = bp.step(img, grip, ids, mask)
        a1 = sp.step(img[:1], grip[:1], ids[:1], mask[:1])
        assert (exits == tcfg.n_layers - 1).all()
        np.testing.assert_allclose(acts[0], a1, **TOL)


def test_batched_policy_masked_reset(tiny):
    jp, tp = batched_pair(tiny, 4, ALWAYS)
    _, ex = step_both(jp, tp, tiny[1], 4, seed=1)
    assert (ex == tiny[1].all_exit_ids()[0]).all()
    before = tp.carry[0].clone()
    mask = np.array([True, False, False, False])
    jp.reset(stream_mask=mask)
    tp.reset(stream_mask=mask)
    assert (tp.carry[0][:, 0] == 0).all()
    assert (tp.carry[0][:, 1:] == before[:, 1:]).all()
    step_both(jp, tp, tiny[1], 4, seed=2)


def test_batched_policy_steps_per_stage_matches_jax(tiny):
    """Per-stream stage clocks: a held stage ignores new thresholds, a reset
    stream decides afresh."""
    jp, tp = batched_pair(tiny, 2, NEVER, steps_per_stage=2)
    cfg = tiny[1]
    last, first = cfg.n_layers - 1, cfg.all_exit_ids()[0]
    want = []
    for th, reset in ((None, None), (ALWAYS, None), (None, None),
                      (NEVER, None), ("reset", None), (None, [True, False]),
                      (ALWAYS, None)):
        if th == "reset":
            jp.reset()
            tp.reset()
            continue
        if th is not None:
            jp.set_thresholds(th)
            tp.set_thresholds(th)
        if reset is not None:
            jp.reset(stream_mask=np.array(reset))
            tp.reset(stream_mask=np.array(reset))
            continue
        want.append(step_both(jp, tp, cfg, 2, seed=len(want))[1].tolist())
    assert want[:4] == [[last] * 2, [last] * 2, [first] * 2, [first] * 2]


# ---------------------------------------------------------------------------
# the batched rollout
# ---------------------------------------------------------------------------


def rollout_setup(tiny):
    jcfg, tcfg, params = tiny
    tok = HashTokenizer(vocab_size=tcfg.mpt.vocab_size,
                        max_length=tcfg.text_len)
    return tok, jcfg, tcfg, params


def run_port(tiny, pipeline=1, env_workers=0, lanes=4, latency=0.0):
    tok, _, tcfg, params = rollout_setup(tiny)
    pol = ScanDeerPolicy(params, tcfg, indexed_mm=True, device="cpu")
    pol.set_thresholds(TH)
    envs = [trollout.DebugEnv(img_hw=40, grip_hw=20, host_latency_ms=latency)
            for _ in range(lanes)]
    return tbatched.evaluate_policy_batched(
        pol, envs, trollout.make_debug_sequences(5, seed=2), {},
        trollout.DebugTaskOracle(0.6), tok, text_len=tcfg.text_len,
        ep_len=6, n_layers=tcfg.n_layers, pipeline=pipeline,
        env_workers=env_workers)


def assert_same(got, want):
    for k in REPORT_KEYS:
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def reports(tiny):
    """The port's 4-lane rollout serially and over 2 lane groups."""
    serial = run_port(tiny)
    exits = [e for h in ("success_exit_hist", "fail_exit_hist")
             for e, p in enumerate(serial[h]) if p > 0]
    assert set(exits) == {1, 3}, exits
    return {1: serial, 2: run_port(tiny, pipeline=2)}


def test_pipelined_rollout_matches_unpipelined_and_jax(tiny, reports):
    got = reports[2]
    for k in REPORT_KEYS[:-1]:
        assert got[k] == reports[1][k], k
    # the lockstep waste is counted per group dispatch: JAX's pipeline=2
    tok, jcfg, tcfg, params = rollout_setup(tiny)
    jpol = JaxScan(jax.tree.map(jnp.asarray, params), jcfg)
    jpol.set_thresholds(TH)
    want = jbatched.evaluate_policy_batched(
        jpol, [jrollout.DebugEnv(img_hw=40, grip_hw=20) for _ in range(4)],
        jrollout.make_debug_sequences(5, seed=2), {},
        jrollout.DebugTaskOracle(0.6), tok, text_len=jcfg.text_len,
        ep_len=6, n_layers=jcfg.n_layers, pipeline=2)
    assert_same(got, want)


@pytest.mark.parametrize("pipeline", [1, 2])
def test_env_workers_match_serial(tiny, reports, pipeline):
    got = run_port(tiny, pipeline=pipeline, env_workers=2, latency=1.0)
    assert_same(got, reports[pipeline])


def test_pipeline_rounds_down_to_a_divisor_of_the_lanes(tiny, reports):
    """pipeline 3 over 4 lanes runs 2 groups."""
    assert_same(run_port(tiny, pipeline=3), reports[2])
