"""PyTorch port, data-parallel scale-out (ROADMAP M15): the mesh, the
placement rules and the batch split against the JAX package's
``parallel/`` on its 8-device CPU mesh, and the multi-process paths across
a real two-process gloo boundary: the gathers (``scripts/dryrun_2proc.py``
(b) in torch), calibration with ``all_gather``, the data-parallel train
step and two-process ``cli/train --coordinator``.

Each multi-process case runs two ``sys.executable`` children that join a
group through a ``file://`` store under ``tmp_path`` (no fixed port, so
xdist workers side by side do not collide), one thread each, with a
timeout.  Inputs go to the children and results come back as
``torch.save`` files.

Tolerances: the placements, the batch split, the gathers, the calibration
values across ranks and against one process, and the ranks' weights
against each other bit for bit; against JAX (fp32, other summation orders)
calibration values and thresholds within 1e-4 relative L2 (as
tests/test_torch_calibrate.py), the dp train step's loss within 1e-5
relative, its grad_norm within 1e-4 relative and each updated leaf within
1e-5 of its norm plus 1e-4 of its update's norm (as tests/
test_torch_train.py); two-process cli/train's first loss within 1e-5
relative of one process over the global batch.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.parallel import mesh as jmesh
from deer_vla_tpu.parallel import sharding as jsharding
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.ops import draws as tdraws
from deer_vla_tpu_torch.ops.layers import flat_key, tree_leaves_with_path
from deer_vla_tpu_torch.parallel import mesh as tmesh
from deer_vla_tpu_torch.parallel import multihost
from deer_vla_tpu_torch.parallel import sharding as tsharding

from test_torch_calibrate import (configs as calib_configs, debug_batches,
                                  jax_batch_draws, open_gates)
from test_torch_train import jax_flat, rel_l2, switch_layer_ids

REPO = Path(__file__).resolve().parents[1]
CALIB_REL_L2 = 1e-4
STEP_LOSS_REL = 1e-5
GRAD_NORM_REL = 1e-4
PARAM_REL_L2 = 1e-5
UPDATE_REL_L2 = 1e-4
CHILD_TIMEOUT_S = 120

CHILD_HEAD = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from deer_vla_tpu_torch.parallel import multihost
rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if {init!r}:
    multihost.initialize("file://" + tmp + "/store", n, rank, device="cpu")
inputs = torch.load(tmp + "/inputs.pt", weights_only=False)
"""
CHILD_TAIL = """
torch.save(result, f"{tmp}/rank{rank}.pt")
multihost.shutdown()
"""


def run_ranks(tmp_path, body: str, inputs=None, n: int = 2,
              init: bool = True):
    """Run ``body`` (with ``rank``, ``n``, ``inputs`` and ``tmp`` bound; it
    sets ``result``) in ``n`` child processes, of one gloo group unless
    ``init`` is False (the body joins one itself); their results in rank
    order."""
    torch.save(inputs, tmp_path / "inputs.pt")
    script = tmp_path / "child.py"
    script.write_text(CHILD_HEAD.format(repo=str(REPO), init=init)
                      + textwrap.dedent(body) + CHILD_TAIL)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# the mesh, the placement rules, the batch split
# ---------------------------------------------------------------------------


def test_mesh_shapes_match_jax():
    jm = jmesh.make_mesh(dp=2, fsdp=2, tp=2)
    tm = tmesh.make_mesh(dp=2, fsdp=2, tp=2, world=8)
    assert tm.shape == dict(jm.shape)
    assert tmesh.local_batch_size(16, tm) == jmesh.local_batch_size(16, jm)
    assert tmesh.make_mesh(fsdp=2, world=8).shape == \
        dict(jmesh.make_mesh(fsdp=2).shape)
    with pytest.raises(AssertionError):
        tmesh.make_mesh(dp=3, fsdp=3, tp=1, world=8)
    with pytest.raises(AssertionError):
        jmesh.make_mesh(dp=3, fsdp=3, tp=1)
    # rank -> (dp, fsdp, tp) as JAX's device array lays the devices out
    devs = np.asarray(jm.devices)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    for idx in np.ndindex(devs.shape):
        assert tm.coords(ids[devs[idx].id]) == idx
    assert tmesh.make_mesh().size == 1  # no group: one process


def jax_specs(tree, mesh, **kw):
    """{flat key: placement tuple} of JAX's param_shardings."""
    sh = jsharding.param_shardings(tree, mesh, **kw)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(
                sh, is_leaf=lambda x: hasattr(x, "spec"))[0]}


def port_specs(tree, mesh, **kw):
    placed = tsharding.param_placements(tree, mesh, **kw)
    leaves = dict(tree_leaves_with_path(tree))
    out = {}
    for path in leaves:
        node = placed
        for k in path:
            node = node[k]
        out[flat_key(path)] = node
    return out


def meta_tree(shapes):
    """JAX ShapeDtypeStructs -> the port's tree of meta tensors (the port
    keeps the JAX tree's structure and names, bridge.py)."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [meta_tree(v) for v in shapes]
    if shapes is None:
        return None
    return torch.empty(shapes.shape, device="meta")


@pytest.fixture(scope="module")
def tiny_trees():
    return (jax.eval_shape(lambda k: jflamingo.init_deer(
                k, jconfig.deer_tiny()), jax.random.PRNGKey(0)),
            tflamingo.init_deer(tconfig.deer_tiny(), seed=0, device="cpu"))


@pytest.mark.parametrize("model,layout,kw", [
    ("tiny", (2, 4, 1), dict(fsdp=True, min_size=1024)),
    ("tiny", (2, 2, 2), dict(fsdp=True, tp=True, min_size=256)),
    ("tiny", (1, 1, 8), dict(fsdp=False, tp=True)),
    ("9b", (2, 4, 1), dict(fsdp=True)),
    ("9b", (1, 2, 4), dict(fsdp=True, tp=True))])
def test_param_placements_match_jax(tiny_trees, model, layout, kw):
    """Leaf for leaf against JAX's PartitionSpecs: deer_tiny from the
    port's own init, the 9B topology (MPT-7B, x-attn every 4 layers) as
    shapes."""
    if model == "tiny":
        jtree, ttree = tiny_trees
    else:
        jcfg = jconfig.deer_9b()
        jtree = jax.eval_shape(lambda k: jflamingo.init_deer(k, jcfg),
                               jax.random.PRNGKey(0))
        ttree = meta_tree(jtree)
    dp, fsdp, tp = layout
    want = jax_specs(jtree, jmesh.make_mesh(dp, fsdp, tp), **kw)
    got = port_specs(ttree, tmesh.make_mesh(dp, fsdp, tp, world=8), **kw)
    assert got == want
    axes = {a for spec in got.values() for a in spec if a}
    assert axes == ({"fsdp"} if not kw.get("tp") else
                    {"tp"} if not kw.get("fsdp") else {"fsdp", "tp"})


def test_shard_batch_gives_each_rank_jaxs_shard():
    jm = jmesh.make_mesh(dp=2, fsdp=4, tp=1)
    tm = tmesh.make_mesh(dp=2, fsdp=4, tp=1, world=8)
    r = np.random.RandomState(0)
    batch = {"image": r.randn(16, 3, 4).astype(np.float32),
             "labels": r.randn(8, 2, 7).astype(np.float32),
             "odd": r.randn(6, 2).astype(np.float32),
             "scalar": np.float32(3.0)}
    jb = jsharding.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                               jm)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    for key in batch:
        for shard in jb[key].addressable_shards:
            got = tsharding.shard_batch(batch, tm, ids[shard.device.id])[key]
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(shard.data))
    t = tsharding.shard_batch({k: torch.as_tensor(v) for k, v in
                               batch.items() if k != "scalar"}, tm, 5)
    assert t["image"].shape == (2, 3, 4) and t["odd"].shape == (6, 2)


def test_batch_split_needs_dp_to_divide_the_trajectories():
    """(B*W, ...) frame rows and (B, W, 7) labels split together only when
    dp x fsdp divides B: B=6, W=2 over 4 shards would slice the 12 frame
    rows and keep the 6 labels whole."""
    m = tmesh.make_mesh(dp=2, fsdp=2, world=4)
    assert tsharding.check_batch_split(8, m) == 2
    batch = {"image": np.zeros((12, 3)), "labels": np.zeros((6, 2, 7))}
    with pytest.raises(ValueError, match="not divisible by the mesh's 4"):
        tsharding.shard_batch(batch, m, 0)
    got = tsharding.shard_batch({"image": np.zeros((16, 3)),
                                 "labels": np.zeros((8, 2, 7))}, m, 3)
    assert got["image"].shape == (4, 3) and got["labels"].shape == (2, 2, 7)


def test_row_shards_of_a_generator_are_the_global_draws():
    """Every shard's draws, side by side, are the one process's draws over
    the global batch; a scalar draw is the same on every shard."""
    def draws(src, n):
        return (tdraws.randint(src, 0, 7, (n, 3)), tdraws.randint(src, 1, 5,
                                                                  ()),
                tdraws.rand(src, (n, 2, 2)), tdraws.randn(src, (n,)))
    whole = draws(torch.Generator().manual_seed(3), 8)
    parts = [draws(tdraws.RowShard(torch.Generator().manual_seed(3), i, 4),
                   2) for i in range(4)]
    for j, w in enumerate(whole):
        if w.ndim == 0:
            assert all(torch.equal(p[j], w) for p in parts)
        else:
            assert torch.equal(torch.cat([p[j] for p in parts]), w)
    with pytest.raises(ValueError):
        tdraws.RowShard(torch.Generator(), 4, 4)


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------


def test_gathers_cross_two_processes_in_rank_order(tmp_path):
    res = run_ranks(tmp_path, """
        import numpy as np
        vals = np.full((3, 2 + rank), rank, np.float32) + np.arange(
            2 + rank, dtype=np.float32)
        result = {"count": multihost.process_count(),
                  "index": multihost.process_index(),
                  "values": multihost.all_gather_values(vals),
                  "objects": multihost.gather_objects(
                      {"rank": rank, "text": "x" * (5 + 100 * rank)})}
    """)
    want_vals = np.concatenate(
        [np.full((3, 2 + r), r, np.float32) + np.arange(2 + r) for r in
         range(2)], axis=1)
    for rank, r in enumerate(res):
        assert r["count"] == 2 and r["index"] == rank
        np.testing.assert_array_equal(r["values"], want_vals)
        assert r["objects"] == [{"rank": q, "text": "x" * (5 + 100 * q)}
                                for q in range(2)]
    # without a group both are the identity
    assert multihost.process_count() == 1
    assert multihost.gather_objects(7) == [7]
    v = np.ones((2, 3))
    assert multihost.all_gather_values(v) is not None
    np.testing.assert_array_equal(multihost.all_gather_values(v), v)


def test_calibrate_all_gather_two_ranks_equals_one_process_and_jax(
        tmp_path):
    """Two ranks, each calibrating on its half of the batches, join their
    values with all_gather_values: every rank solves the same thresholds
    on the concatenated values, which are one process's over all the
    batches, and JAX's."""
    jcfg, tcfg, tok = calib_configs()
    params = open_gates(jax.tree.map(np.asarray, jflamingo.init_deer(
        jax.random.PRNGKey(0), jcfg)), seed=7)
    batches = debug_batches(jcfg, tok, num=2, seed=8)
    draws = jax_batch_draws(jcfg, 2, False)
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, params), jcfg,
                                  batches, 0.5, max_batches=2)
    tp = to_torch(params, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the children's: the same summation order
    try:
        th_one, vals_one = tcal.calibrate(tp, tcfg, batches, 0.5,
                                          max_batches=2, draws=draws)
    finally:
        torch.set_num_threads(threads)
    res = run_ranks(tmp_path, """
        from deer_vla_tpu_torch.eval.calibrate import calibrate
        half = slice(rank, rank + 1)
        th, vals = calibrate(inputs["params"], inputs["cfg"],
                             inputs["batches"][half], 0.5,
                             draws=inputs["draws"][half],
                             all_gather=multihost.all_gather_values)
        result = {"th": th, "vals": vals}
    """, {"params": tp, "cfg": tcfg, "batches": batches, "draws": draws})
    for r in res:
        np.testing.assert_array_equal(r["vals"], vals_one)
        assert r["th"] == th_one
    assert rel_l2(vals_one, vals_j) <= CALIB_REL_L2
    np.testing.assert_allclose([th_one[e] for e in sorted(th_one)],
                               [th_j[e] for e in sorted(th_j)],
                               rtol=CALIB_REL_L2)


def sharding_test_batch(cfg, bs=8, seed=0):
    """tests/test_sharding.py::test_batch_sharding_train_step_equivalence's
    batch."""
    r = np.random.RandomState(seed)
    w, s = cfg.window_size, cfg.text_len
    ids = np.full((bs * w, s), 7, np.int32)
    ids[:, 0] = cfg.media_token_id
    return {"image": r.randn(bs * w, 1, 1, 3, 28, 28).astype(np.float32),
            "gripper": r.randn(bs * w, 1, 1, 3, 28, 28).astype(np.float32),
            "input_ids": ids,
            "attention_mask": np.ones((bs * w, s), np.int32),
            "labels": np.clip(r.randn(bs, w, 7), -1, 1).astype(np.float32)}


def layer_draws(jcfg, rng, bs):
    """forward_train's layer draws from its key (deer_tiny's heads drop
    nothing, so these are all its draws)."""
    assert jcfg.head.dropout == jcfg.head.lstm_dropout == 0.0
    rngs = jax.random.split(rng, 8)
    exit_ids = jnp.asarray(jcfg.all_exit_ids())
    lay1 = exit_ids[jax.random.randint(rngs[2], (bs, jcfg.window_size), 0,
                                       jcfg.num_exits)]
    return {"rand_layer_ids": torch.as_tensor(np.array(lay1)),
            "switch_layer_ids": torch.as_tensor(
                switch_layer_ids(jcfg, rng, bs))}


def test_dp_train_step_two_ranks_matches_jax_dp_sharded_step(tmp_path):
    """The JAX step with the batch dp-sharded over the 8-device mesh, and
    the port's step on two ranks of four trajectories each, from the same
    weights and the same layer draws: the global loss, grad_norm and every
    updated leaf."""
    jcfg = jconfig.deer_tiny()
    params = jax.tree.map(np.asarray, jflamingo.init_deer(
        jax.random.PRNGKey(0), jcfg))
    jp = jax.tree.map(jnp.asarray, params)
    mask = jflamingo.trainable_mask(jp, jcfg, "joint")
    opt = joptim.make_optimizer(jp, jcfg, phase="joint", learning_rate=1e-3,
                                warmup_steps=0, total_steps=10,
                                trainable=mask)
    # trainable=: grad_norm over the trainable gradients, as the trainer
    # reports it (without it JAX's norm takes in the frozen decoder's)
    step = jstep.make_train_step(jcfg, opt, donate=False, trainable=mask)
    batch = sharding_test_batch(jcfg)
    rng = jax.random.PRNGKey(2)
    draws = layer_draws(jcfg, rng, 8)
    sharded = jsharding.shard_batch({k: jnp.asarray(v) for k, v in
                                     batch.items()},
                                    jmesh.make_mesh(dp=8, fsdp=1, tp=1))
    js, jm = step(jstep.init_train_state(jp, opt), sharded, rng)
    res = run_ranks(tmp_path, """
        from deer_vla_tpu_torch.models.flamingo import trainable_mask
        from deer_vla_tpu_torch.ops.layers import flat_key
        from deer_vla_tpu_torch.ops.layers import tree_leaves_with_path
        from deer_vla_tpu_torch.train.optimizer import make_optimizer
        from deer_vla_tpu_torch.train.train_step import (init_train_state,
                                                         make_train_step)
        cfg, params = inputs["cfg"], inputs["params"]
        opt = make_optimizer(params, cfg, phase="joint", learning_rate=1e-3,
                             warmup_steps=0, total_steps=10,
                             trainable=trainable_mask(params, cfg, "joint"))
        step = make_train_step(cfg, opt)
        b, w = 4, cfg.window_size
        rows = {k: (v[rank * b:(rank + 1) * b] if k == "labels"
                    else v[rank * b * w:(rank + 1) * b * w])
                for k, v in inputs["batch"].items()}
        d = {k: v[rank * b:(rank + 1) * b] for k, v in
             inputs["draws"].items()}
        st, m = step(init_train_state(params, opt), rows, draws=[d])
        result = {"loss": float(m["loss"]),
                  "grad_norm": float(m["grad_norm"]),
                  "params": {flat_key(p): v for p, v in
                             tree_leaves_with_path(st.params)}}
    """, {"cfg": tconfig.deer_tiny(), "params": to_torch(params, "cpu"),
          "batch": {k: torch.as_tensor(v).long() if v.dtype == np.int32
                    else torch.as_tensor(v) for k, v in batch.items()},
          "draws": draws})
    want, before = jax_flat(js.params), jax_flat(params)
    for r in res:
        assert abs(r["loss"] - float(jm["loss"])) <= \
            STEP_LOSS_REL * abs(float(jm["loss"]))
        assert abs(r["grad_norm"] - float(jm["grad_norm"])) <= \
            GRAD_NORM_REL * float(jm["grad_norm"])
        for k, v in r["params"].items():
            v = v.numpy().astype(np.float64)
            err = np.linalg.norm(v - want[k])
            bound = (PARAM_REL_L2 * np.linalg.norm(want[k])
                     + UPDATE_REL_L2 * np.linalg.norm(
                         want[k].astype(np.float64) - before[k]))
            assert err <= bound, (k, err, bound)
    for k, v in res[0]["params"].items():
        assert torch.equal(v, res[1]["params"][k]), k


TRAIN_ARGV = ["--debug", "--model", "tiny", "--num_joint_epochs", "1",
              "--num_exit_epochs", "1", "--joint_warmup_steps", "1",
              "--exit_warmup_steps", "1", "--precision", "fp32",
              "--logging_steps", "1"]


def test_train_cli_two_processes_keep_the_ranks_equal(tmp_path, capsys):
    """Two-process cli/train --coordinator --debug, two trajectories a
    rank: every trainable leaf bit-equal across the ranks after both
    phases, rank 0 alone wrote the checkpoints, and the first step's loss
    is one process's over the same four trajectories."""
    run = tmp_path / "run"
    res = run_ranks(tmp_path, f"""
        import contextlib, io
        from deer_vla_tpu_torch.cli.train import main
        from deer_vla_tpu_torch.ops.layers import (flat_key,
                                                   tree_leaves_with_path)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tr = main({TRAIN_ARGV!r} + [
                "--batch_size_calvin", "2", "--run_name", {str(run)!r},
                "--coordinator", "file://" + tmp + "/store2",
                "--num_processes", "2", "--process_id", str(rank)],
                device="cpu")
        result = {{"stdout": out.getvalue(), "world": tr.world,
                   "params": {{flat_key(p): v for p, v in
                              tree_leaves_with_path(tr.params)}}}}
    """, init=False)
    assert [r["world"] for r in res] == [2, 2]
    for k, v in res[0]["params"].items():
        assert torch.equal(v, res[1]["params"][k]), k
    assert sorted(os.listdir(run)) == ["deer_0.ckpt", "deer_0.json",
                                       "deer_1.ckpt", "deer_1.json",
                                       "heartbeat.json"]
    assert res[1]["stdout"] == ""  # rank 0 logs
    logs = [json.loads(line) for line in res[0]["stdout"].splitlines()
            if line.startswith("{")]
    one = tmp_path / "one"
    train_cli.main(TRAIN_ARGV + ["--batch_size_calvin", "4", "--run_name",
                                 str(one), "--num_exit_epochs", "0"],
                   device="cpu")
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert abs(logs[0]["loss"] - want[0]["loss"]) <= \
        STEP_LOSS_REL * abs(want[0]["loss"])
    assert logs[0]["step"] == want[0]["step"] == 0


# two uneven LAION shards: 3 batches of 2 and 1 batch; whichever rank
# takes the short one, both ranks take one LAION step and stop together
UNEVEN_SHARDS = (6, 2)


@pytest.mark.parametrize("data", ["debug", "uneven_shards"])
def test_pretrain_cli_two_processes_keep_the_ranks_equal(tmp_path, data):
    """Two-process cli/pretrain --coordinator on deer_tiny: the ranks take
    the same steps and end bit-equal, rank 0 alone logs and writes the
    checkpoint.  ``debug``: rank 0 writes one LAION and one MMC4 shard a
    rank, the others wait for it (2 steps of each source a rank).
    ``uneven_shards``: the ranks' shards hold 3 and 1 batches, so every
    rank stops LAION after one step, where the short one runs out."""
    from deer_vla_tpu_torch.data.webdataset import \
        write_synthetic_laion_shard
    run = tmp_path / "run"
    argv = ["--model", "tiny", "--precision", "fp32", "--warmup_steps", "0",
            "--logging_steps", "1", "--batch_size_laion", "2",
            "--batch_size_mmc4", "2", "--max_tokens", "24", "--run_name",
            str(run)]
    if data == "debug":
        argv.append("--debug")
        want_steps = 4
    else:
        run.mkdir()
        for i, n in enumerate(UNEVEN_SHARDS):
            write_synthetic_laion_shard(str(run / f"laion-{i}.tar"), n=n,
                                        hw=28, seed=i)
        argv += ["--laion_shards", str(run / "laion-*.tar")]
        want_steps = 1
    res = run_ranks(tmp_path, f"""
        import contextlib, io
        from deer_vla_tpu_torch.cli.pretrain import main
        from deer_vla_tpu_torch.train.optimizer import flat_leaves
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            params, _ = main({argv!r} + [
                "--coordinator", "file://" + tmp + "/store2",
                "--num_processes", "2", "--process_id", str(rank)],
                device="cpu")
        result = {{"stdout": out.getvalue(),
                   "params": dict(flat_leaves(params))}}
    """, init=False)
    for k, v in res[0]["params"].items():
        assert torch.equal(v, res[1]["params"][k]), k
    assert res[1]["stdout"] == ""  # rank 0 logs
    logs = [json.loads(line) for line in res[0]["stdout"].splitlines()
            if line.startswith("{")]
    assert logs[-1] == {"final_steps": want_steps}
    written = sorted(p for p in os.listdir(run)
                     if not p.endswith(".tar"))
    assert written == ["pretrain_0.ckpt", "pretrain_0.json"]
    if data == "debug":
        assert sorted(p for p in os.listdir(run) if p.endswith(".tar")) == [
            f"debug-{kind}-{i:03d}.tar" for kind in ("laion", "mmc4")
            for i in range(2)]


def test_pick_backend_counts_the_cards_of_this_host(monkeypatch):
    """Two hosts of 4 cards and 8 processes: torchrun's LOCAL_RANK /
    LOCAL_WORLD_SIZE say 4 ranks run here, so NCCL, each rank on its own
    card; more local ranks than cards, or no card, take gloo.  Without
    the variables the whole group counts as local."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert multihost.local_ranks(8, 7) == (3, 4)
    assert multihost.pick_backend(4) == "nccl"
    assert multihost.pick_backend(4, device="cpu") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert multihost.pick_backend(multihost.local_ranks(8, 7)[1]) == "gloo"
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert multihost.local_ranks(8, 5) == (5, 8)
    assert multihost.local_ranks(4, 2) == (2, 4)
    assert multihost.pick_backend(4) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.pick_backend(1) == "gloo"


class RowDataset:
    """n numbered rows; a batch is their numbers."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    @staticmethod
    def collate(rows, text_fn):
        return np.asarray(rows)


@pytest.mark.parametrize("world", [2, 3])
def test_vl_loader_ranks_split_one_global_batch(world):
    """VLLoader's ranks, side by side, give one process's batches of
    ``world`` times the rows, rows in rank order; each epoch's order is
    the same on every rank."""
    ds, bs = RowDataset(23), 3
    from deer_vla_tpu_torch.data.vl_dataset import VLLoader
    one = VLLoader(ds, None, bs * world, seed=7)
    ranks = [VLLoader(ds, None, bs, seed=7, rank=r, world_size=world)
             for r in range(world)]
    for epoch in (0, 1):
        for ld in [one] + ranks:
            ld.set_epoch(epoch)
        got = [np.concatenate(parts) for parts in zip(*ranks)]
        want = list(one)
        assert len(got) == len(want) == 23 // (bs * world)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="rank 2 outside"):
        VLLoader(ds, None, bs, rank=2, world_size=2)
