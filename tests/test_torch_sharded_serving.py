"""PyTorch port, batched serving with the streams split over two processes
(``eval/sharded_serving.py``, ROADMAP M15) against the JAX package's
``ShardedBatchedPolicy`` on its 8-device CPU mesh, on the same bridged
deer_tiny weights (x-attn gates opened) and inputs: B = 8 streams, four a
rank over a two-process gloo group (children as in
tests/test_torch_parallel.py).

Exit layers must be equal for every stream and step, and the two ranks'
results equal bit for bit; actions within 2e-4 of JAX's
(tests/test_torch_scan_policy.py's tolerance) and of the single-process
``step_batch``.  The batched rollout's report over the sharded policy must
equal the single-process report (discrete, as tests/test_torch_batched.py
holds it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScan
from deer_vla_tpu.eval.sharded_serving import \
    ShardedBatchedPolicy as JaxSharded
from deer_vla_tpu.parallel.mesh import make_mesh as jax_mesh
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.eval.sharded_serving import ShardedBatchedPolicy
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.parallel.mesh import Mesh

from test_torch_batched import REPORT_KEYS, assert_same
from test_torch_parallel import run_ranks
from test_torch_policy import TH, make_params, obs

TOL = dict(rtol=2e-4, atol=2e-4)
B = 8
RESET = np.isin(np.arange(B), [0, 3])
FIRST, LAST = [1e8, 1e8], [-1.0, 1e8]
ROWS = [FIRST, LAST] * (B // 2)  # per-stream thresholds

# the serving script each side runs: (what, argument); "step" steps the
# obs of seed `argument`
SCRIPT = (("step", 0), ("step", 1), ("step", 2), ("reset", RESET),
          ("step", 3), ("rows", ROWS), ("step", 4), ("step", 5))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.deer_tiny()
    return jcfg, tconfig.deer_tiny(), make_params(jcfg)


# the drivers both sides run (the children take them as source)
DRIVERS = """
import numpy as np


def run_script(pol, script, inputs, set_rows, to_device=np.asarray):
    \"\"\"Drive ``pol`` through ``script``: [(actions, exits)] a step.\"\"\"
    out = []
    for what, arg in script:
        if what == "reset":
            pol.reset_streams(arg)
        elif what == "rows":
            set_rows(arg)
        else:
            acts, exits = pol.step_batch(*map(to_device, inputs[arg]))
            out.append((np.asarray(acts), np.asarray(exits)))
    return out


def rollout(pol, cfg, pipeline):
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval import batched_rollout, rollout as ro
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size,
                        max_length=cfg.text_len)
    envs = [ro.DebugEnv(img_hw=40, grip_hw=20) for _ in range(4)]
    return batched_rollout.evaluate_policy_batched(
        pol, envs, ro.make_debug_sequences(5, seed=2), {},
        ro.DebugTaskOracle(0.6), tok, text_len=cfg.text_len, ep_len=6,
        n_layers=cfg.n_layers, pipeline=pipeline)
"""
exec(DRIVERS)


def test_sharded_matches_jax_and_single_process(tiny, tmp_path):
    jcfg, tcfg, params = tiny
    inputs = {s: obs(tcfg, B, seed=s) for what, s in SCRIPT
              if what == "step"}
    jpol = JaxSharded(JaxScan(jax.tree.map(jnp.asarray, params), jcfg,
                              thresholds=list(TH)),
                      jax_mesh(dp=4, fsdp=2, tp=1))
    want = run_script(jpol, SCRIPT, inputs, jpol.inner.set_thresholds_batch,
                      jnp.asarray)
    single = ScanDeerPolicy(params, tcfg, thresholds=list(TH), device="cpu")
    one = run_script(single, SCRIPT, inputs, single.set_thresholds_batch)
    res = run_ranks(tmp_path, DRIVERS + """
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.eval.sharded_serving import ShardedBatchedPolicy
pol = ShardedBatchedPolicy(ScanDeerPolicy(
    inputs["params"], inputs["cfg"], thresholds=inputs["th"],
    device="cpu"))
assert pol.n_shards == 2 and pol.shard == rank
out = run_script(pol, inputs["script"], inputs["obs"],
                 pol.set_thresholds_batch)
result = {"out": out, "last": pol.last_exit_layer,
          "carry_rows": int(pol.inner.carry[0].shape[1])}
""", {"params": params, "cfg": tcfg, "th": list(TH), "obs": inputs,
      "script": SCRIPT})
    exits_seen = set()
    for r in res:
        assert r["carry_rows"] == B // 2  # each rank holds its streams' carry
        assert r["last"] == int(r["out"][-1][1].max())
        for (a, e), (aj, ej), (a1, e1) in zip(r["out"], want, one):
            np.testing.assert_array_equal(e, ej)
            np.testing.assert_array_equal(e, e1)
            np.testing.assert_allclose(a, aj, **TOL)
            np.testing.assert_allclose(a, a1, **TOL)
            exits_seen |= set(e.tolist())
    for (a0, e0), (a1, e1) in zip(res[0]["out"], res[1]["out"]):
        assert np.array_equal(a0, a1) and np.array_equal(e0, e1)
    assert exits_seen == set(tcfg.all_exit_ids())
    # the per-stream rows: first exit on even streams, last on odd ones
    assert (res[0]["out"][-1][1] == [1, 3] * (B // 2)).all()


def test_sharded_refusals(tiny):
    """JAX's refusals: B not divisible by the data shards (AssertionError
    'divisible'), window-folded models (NotImplementedError), another
    engine than the while-loop one."""
    _, tcfg, params = tiny
    pol = ShardedBatchedPolicy(ScanDeerPolicy(params, tcfg, thresholds=TH,
                                              device="cpu"), Mesh(2), rank=1)
    with pytest.raises(AssertionError, match="divisible"):
        pol.step_batch(*obs(tcfg, 3, seed=0))
    for change in ({"fusion_mode": "vit_concat"}, {"use_hist": True}):
        cfg = dataclasses.replace(tcfg, **change)
        p = tflamingo.init_deer(cfg, seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match="one frame per"):
            ShardedBatchedPolicy(ScanDeerPolicy(p, cfg, device="cpu"),
                                 Mesh(2), rank=0)
    with pytest.raises(AssertionError, match="while-loop engine"):
        ShardedBatchedPolicy(object(), Mesh(2), rank=0)
    with pytest.raises(ValueError, match="threshold rows"):
        pol.set_thresholds_batch([TH] * 4)
        pol.step_batch(*obs(tcfg, 2, seed=0))
    # no group: one shard, the wrapped engine's own step
    one = ShardedBatchedPolicy(ScanDeerPolicy(params, tcfg, thresholds=TH,
                                              device="cpu"))
    single = ScanDeerPolicy(params, tcfg, thresholds=TH, device="cpu")
    a, e = one.step_batch(*obs(tcfg, 3, seed=1))
    a1, e1 = single.step_batch(*obs(tcfg, 3, seed=1))
    assert np.array_equal(a, a1) and np.array_equal(e, e1)


def test_batched_rollout_over_the_sharded_policy(tiny, tmp_path):
    """Every rank runs the batched rollout over all four lanes, unchanged:
    its report is the single-process one, sequential lanes and two
    pipelined lane groups alike."""
    _, tcfg, params = tiny
    want = {p: rollout(ScanDeerPolicy(params, tcfg, thresholds=TH,
                                      device="cpu"), tcfg, p)
            for p in (1, 2)}
    res = run_ranks(tmp_path, DRIVERS + """
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.eval.sharded_serving import ShardedBatchedPolicy
result = {p: rollout(ShardedBatchedPolicy(ScanDeerPolicy(
              inputs["params"], inputs["cfg"], thresholds=inputs["th"],
              device="cpu")), inputs["cfg"], p) for p in (1, 2)}
""", {"params": params, "cfg": tcfg, "th": TH})
    for r in res:
        for p in (1, 2):
            assert_same(r[p], want[p])
    assert set(REPORT_KEYS) <= set(res[0][1])
