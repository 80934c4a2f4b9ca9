"""PyTorch port, weight placement (ROADMAP M15b): ``shard_params`` /
``gather_params`` for fsdp and tensor parallel, the local layout of the
fused and quantized products, and the tensor-parallel model, engine and
train step across real gloo process boundaries, against the JAX package.

The 9B topology is kept and its widths cut, as tests/test_9b_sharded.py
does (cross-attention every 4 layers), with deer_tiny's vision tower and
head, gates opened (the init's zero gates would leave the cross-attention's
split untested), fp32.  The serving model has 12 decoder heads, so its
ALiBi slopes interleave, and MPT biases, so the column products' bias
slices and the row products' one bias after the sum both run.

The multi-process cases run ``sys.executable`` children as
``test_torch_parallel.run_ranks`` does (a ``file://`` store under
tmp_path, one thread each), while the JAX reference runs in this process;
several checks share one spawn.

Tolerances: the round trips, the head-grouped layout, the local slopes,
the repacked int4 shard and the engine's local quantized stacks bit for
bit; the w8a8 row-parallel product against JAX's ``linear`` on the whole
row within 1e-6 relative (its int32 sums are exact, its fp32 rescale the
same product); tp=4 ``forward_fixed_exit`` against JAX's on the replicated
tree within 2e-5 (tests/test_sharding.py's tolerance); the tp=4 engine
against JAX's ``ScanDeerPolicy``: exit layers equal, actions within 2e-4
(tests/test_torch_scan_policy.py's), every rank's exits equal; over
fsdp=2 x tp=2, ``ShardedBatchedPolicy.from_shards`` against JAX's engine
with the same tolerances, and the train step against JAX's
``make_train_step``: loss within
1e-5 relative, grad_norm within 1e-4 relative, each updated leaf within
1e-5 of its norm plus 1e-4 of its update's norm
(tests/test_torch_train_steps.py), frozen leaves bit-unchanged.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScanPolicy
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.ops import alibi as jalibi
from deer_vla_tpu.ops import layers as jlayers
from deer_vla_tpu.ops import quant as jquant
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.ops import alibi as talibi
from deer_vla_tpu_torch.ops import quant as tquant
from deer_vla_tpu_torch.ops.layers import (flat_key, tree_leaves_with_path,
                                           tree_map)
from deer_vla_tpu_torch.parallel import sharding as tsharding
from deer_vla_tpu_torch.parallel.mesh import Mesh
from deer_vla_tpu_torch.eval.scan_policy import stack_decoder_layers

from test_torch_9b import open_gates, port_config, shrink
from test_torch_parallel import (CHILD_HEAD, CHILD_TAIL, CHILD_TIMEOUT_S,
                                 REPO, layer_draws, sharding_test_batch)
from test_torch_scan_policy import obs
from torch_train_common import jax_flat

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(
    not (torch.distributed.is_available()
         and torch.distributed.is_gloo_available()),
    reason="torch.distributed with gloo is needed")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
ENGINE_TOL = dict(rtol=2e-4, atol=2e-4)
W8A8_REL = 1e-6
STEP_LOSS_REL = 1e-5
GRAD_NORM_REL = 1e-4
PARAM_REL_L2 = 1e-5
UPDATE_REL_L2 = 1e-4
MESHES = {"fsdp": Mesh(2, 2, 1), "tp": Mesh(1, 1, 4),
          "fsdp_tp": Mesh(1, 2, 2)}
# B=1 threshold rows (exits [3, 7]), and one row a stream at B=4: the
# first exit always, never, and two values between
ROWS = [[1e8, 1e8], [-1.0, 1e8], [3e-2, 1e8], [1e-1, 1e8]]


def serve_config():
    """deer_9b's topology at 8 layers (exits [3, 7], cross-attention on 3
    and 7), 12 heads of 32, MPT biases on."""
    cfg = shrink(jconfig.deer_9b(max_layer=8, exit_interval=4),
                 d_model=384, n_heads=12, n_layers=8)
    return dataclasses.replace(cfg, mpt=dataclasses.replace(cfg.mpt,
                                                            no_bias=False))


def draw_np(jcfg, seed):
    """Weights drawn by the port's init (the JAX package's tree layout; far
    quicker on the CPU than JAX's eager init) as numpy, gates opened."""
    tcfg = port_config(jcfg)
    params = tree_map(lambda t: t.numpy(),
                      tflam.init_deer(tcfg, seed=seed, device="cpu"))
    return tcfg, open_gates(params, seed + 100)


@pytest.fixture(scope="module")
def serve_model():
    jcfg = serve_config()
    return (jcfg,) + draw_np(jcfg, seed=3)


def torch_leaves(tree) -> dict:
    return {flat_key(p): v for p, v in tree_leaves_with_path(tree)}


def assert_trees_equal(got, want):
    got, want = torch_leaves(got), torch_leaves(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def spawn_ranks(tmp_path, body: str, inputs, n: int):
    """``test_torch_parallel.run_ranks`` in two halves, so that the JAX
    reference runs while the children do: starts ``n`` children of one
    gloo group and returns ``wait()``, which gives their results in rank
    order."""
    torch.save(inputs, tmp_path / "inputs.pt")
    script = tmp_path / "child.py"
    script.write_text(CHILD_HEAD.format(repo=str(REPO), init=True)
                      + textwrap.dedent(body) + CHILD_TAIL)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-4000:]
        return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
    return wait


# ---------------------------------------------------------------------------
# one process: the placement and the local layout
# ---------------------------------------------------------------------------


def quantized_stacks(params, tcfg, mode):
    """The serving engine's stacked tree, quantized whole (``mode``)."""
    return tquant.quantize_serving_stacked(
        stack_decoder_layers(params, tcfg, include_encoders=True), mode)


@pytest.mark.parametrize("tree", ["params", "int8", "int4"])
@pytest.mark.parametrize("layout", sorted(MESHES))
def test_gather_of_the_shards_is_the_tree_bit_for_bit(serve_model, layout,
                                                      tree):
    """Every rank's shards, gathered, give the tree back bit for bit: the
    parameter tree, and the engine's int8 and int4 stacks (codes placed as
    their weights, scales with their channels, int4 repacked).  Each rank
    holds 1 / (fsdp * tp) of a leaf split on both axes."""
    _, tcfg, params = serve_model
    whole = to_torch(params, "cpu")
    if tree != "params":
        whole = quantized_stacks(whole, tcfg, tree)
    mesh = MESHES[layout]
    kw = dict(fsdp=mesh.fsdp > 1, tp=mesh.tp > 1, min_size=1024)
    shards = [tsharding.shard_params(whole, mesh, r, **kw)[0]
              for r in range(mesh.size)]
    specs = tsharding.shard_placements(whole, mesh, **kw)
    assert_trees_equal(tsharding.gather_params(shards, specs, mesh), whole)
    split = [p for p, s in tsharding.placements_by_path(specs).items()
             if "tp" in s and "fsdp" in s]
    if layout == "fsdp_tp":
        assert split
        local, full = dict(tree_leaves_with_path(shards[3])), \
            dict(tree_leaves_with_path(whole))
        for p in split:
            assert local[p].numel() * 4 == full[p].numel(), p
    if tree == "params":  # the JAX package's placements, leaf for leaf
        assert specs == tsharding.param_placements(whole, mesh, **kw)


def test_fused_products_are_grouped_by_heads(serve_model):
    """Rank r's wqkv columns are the q, k and v columns of its heads, its
    to_kv columns the k and v of its heads; out_proj / to_out rows are its
    heads' rows."""
    jcfg, _, params = serve_model
    whole = to_torch(params, "cpu")
    mesh = Mesh(1, 1, 4)
    d, h = jcfg.mpt.d_model, jcfg.mpt.n_heads
    hd = d // h
    inner = jcfg.xattn_heads * jcfg.xattn_dim_head
    for r in range(4):
        local, _ = tsharding.shard_params(whole, mesh, r, fsdp=False,
                                          tp=True)
        mine = range(r * hd * h // 4, (r + 1) * hd * h // 4)
        w = whole["decoder"]["blocks"][0]["wqkv"]["w"]
        want = torch.cat([w[:, [c * d + j for j in mine]]
                          for c in range(3)], 1)
        assert torch.equal(local["decoder"]["blocks"][0]["wqkv"]["w"], want)
        assert torch.equal(local["decoder"]["blocks"][0]["out_proj"]["w"],
                           whole["decoder"]["blocks"][0]["out_proj"]["w"]
                           [list(mine)])
        xm = range(r * inner // 4, (r + 1) * inner // 4)
        kv = whole["decoder"]["xattn"][3]["to_kv"]["w"]
        assert torch.equal(local["decoder"]["xattn"][3]["to_kv"]["w"],
                           torch.cat([kv[:, [c * inner + j for j in xm]]
                                      for c in range(2)], 1))
        # biases stay whole (the JAX specs split 2-D leaves only)
        assert torch.equal(local["decoder"]["blocks"][0]["wqkv"]["b"],
                           whole["decoder"]["blocks"][0]["wqkv"]["b"])


def test_local_alibi_slopes_slice_the_whole_heads():
    """At H = 12 the slopes interleave (not a power of two): each of 4
    ranks takes its 3 of the whole H's slopes (JAX's), which are not
    ``alibi_slopes(3)``."""
    whole = np.asarray(jalibi.alibi_slopes(12))
    mask = torch.ones(1, 5, dtype=torch.int64)
    full = talibi.full_attn_bias(mask, 12, 5)
    for r in range(4):
        heads = range(3 * r, 3 * r + 3)
        bias = talibi.alibi_bias(12, 5, heads=heads)
        np.testing.assert_array_equal(
            bias[0, :, 0, 0].numpy(), -4.0 * whole[3 * r:3 * r + 3])
        assert torch.equal(talibi.full_attn_bias(mask, 12, 5, heads=heads),
                           full[:, 3 * r:3 * r + 3])
    assert not np.array_equal(whole[:3], talibi.alibi_slopes(3))


def test_int4_row_shard_is_the_sliced_codes_repacked():
    """JAX's whole int4 weight, split by K over tp=4: each rank's packed
    codes are ``pack_int4`` of its K rows of the unpacked codes (a K slice
    of q4 would pair the wrong rows), the scales whole."""
    r = np.random.RandomState(5)
    w = r.randn(3, 64, 32).astype(np.float32)
    q4, s4 = jquant.quantize_weight4(jnp.asarray(w))
    codes = torch.as_tensor(np.array(jquant.unpack_int4(q4)))
    tree = {"out_proj": {"q4": torch.as_tensor(np.array(q4)),
                         "s4": torch.as_tensor(np.array(s4))}}
    mesh = Mesh(1, 1, 4)
    for rank in range(4):
        local, _ = tsharding.shard_params(tree, mesh, rank, fsdp=False,
                                          tp=True)
        want = tquant.pack_int4(codes[:, 16 * rank:16 * (rank + 1)])
        assert torch.equal(local["out_proj"]["q4"], want)
        assert torch.equal(local["out_proj"]["s4"], tree["out_proj"]["s4"])
        assert not torch.equal(want, tree["out_proj"]["q4"]
                               [:, 8 * rank:8 * (rank + 1)])


# ---------------------------------------------------------------------------
# four ranks, tp=4: the forward, the engine, the quantized shards, w8a8
# ---------------------------------------------------------------------------


def jax_forward(jcfg, params, inputs):
    img, grip, ids, mask = (jnp.asarray(a) for a in inputs)
    fwd = jax.jit(lambda p: jflam.forward_fixed_exit(
        p, img, ids, mask, jcfg, exit_id=7, vision_gripper=grip)[0].actions)
    return np.asarray(fwd(jax.tree.map(jnp.asarray, params)))


def jax_engine(jcfg, params):
    """JAX's ScanDeerPolicy: 3 B=1 steps a threshold row, then 2 B=4
    steps with one row a stream: (actions, exit layers) of each."""
    pol = JaxScanPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                        indexed_mm=True)
    out = []
    for row in ROWS:
        pol.set_thresholds(row)
        pol.reset()
        for t in range(3):
            a = pol.step(*(jnp.asarray(x) for x in obs(jcfg, 1, seed=t)))
            out.append((np.asarray(a), [pol.last_exit_layer]))
    pol.set_thresholds_batch(ROWS)
    pol.reset()
    for t in range(2):
        a, e = pol.step_batch(*(jnp.asarray(x) for x in
                                obs(jcfg, 4, seed=10 + t)))
        out.append((np.asarray(a), np.asarray(e).tolist()))
    return out


def w8a8_case(seed=7):
    """A row-parallel product's whole x and weight, and JAX's ``linear``
    of each w8a8 mode on the whole row."""
    r = np.random.RandomState(seed)
    x = r.randn(6, 64).astype(np.float32)
    w = r.randn(64, 32).astype(np.float32)
    b = r.randn(32).astype(np.float32)
    want = {}
    for key in ("s8", "s48"):
        p = jquant.quantize_tree({"w": jnp.asarray(w)}, scale_key=key)
        p["b"] = jnp.asarray(b)
        want[key] = np.asarray(jlayers.linear(p, jnp.asarray(x)))
    return x, w, b, want


TP4_BODY = """
    import numpy as np
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.flamingo import forward_fixed_exit
    from deer_vla_tpu_torch.ops import quant
    from deer_vla_tpu_torch.ops.layers import (flat_key, row_parallel_linear,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.parallel.mesh import Mesh, axis_groups
    from deer_vla_tpu_torch.parallel.sharding import (shard_params,
                                                      split_dim)
    from deer_vla_tpu_torch.eval.scan_policy import stack_decoder_layers
    cfg, whole = inputs["cfg"], inputs["params"]
    mesh = Mesh(1, 1, 4)
    tp = axis_groups(mesh, rank)["tp"]
    local, _ = shard_params(whole, mesh, rank, fsdp=False, tp=True)
    result = {}
    img, grip, ids, mask = inputs["fwd"]
    with torch.no_grad():
        out, _ = forward_fixed_exit(local, img, ids, mask, cfg, 7,
                                    vision_gripper=grip, tp=tp)
    result["forward"] = out.actions
    pol = ScanDeerPolicy(local, cfg, indexed_mm=True, device="cpu", tp=tp,
                         check_tp_exits=True)
    steps = []
    for row in inputs["rows"]:
        pol.set_thresholds(row)
        pol.reset()
        for t in range(3):
            a = pol.step(*inputs["obs1"][t])
            steps.append((a, [pol.last_exit_layer]))
    pol.set_thresholds_batch(inputs["rows"])
    pol.reset()
    for t in range(2):
        a, e = pol.step_batch(*inputs["obs4"][t])
        steps.append((a, e.tolist()))
    result["engine"] = steps
    # the engine's local quantized stacks against the whole stacks split
    same = {}
    for mode in ("int8", "int4"):
        q = ScanDeerPolicy(local, cfg, indexed_mm=True, device="cpu",
                           tp=tp, quantize=mode)
        want, _ = shard_params(quant.quantize_serving_stacked(
            stack_decoder_layers(whole, cfg, include_encoders=True), mode),
            mesh, rank, fsdp=False, tp=True)
        want = {flat_key(p): v for p, v in tree_leaves_with_path(want)}
        got = {flat_key(p): v for p, v in tree_leaves_with_path(q.stacked)}
        keys = [k for k in got if k.split("/")[-1] in ("q", "q4", "s", "s4")]
        same[mode] = (len(keys), all(torch.equal(got[k], want[k])
                                     for k in keys))
    result["quantized"] = same
    x, w, b = inputs["w8a8"]
    rows = slice(16 * rank, 16 * (rank + 1))
    y = {}
    for key in ("s8", "s48"):
        p = quant.quantize_tree({"w": w}, key)
        p["b"] = b
        lp, _ = shard_params({"out_proj": p}, mesh, rank, fsdp=False,
                             tp=True)
        y[key] = row_parallel_linear(lp["out_proj"], x[:, rows], tp)
    result["w8a8"] = y
"""


@pytest.fixture(scope="module")
def tp4_run(serve_model, tmp_path_factory):
    jcfg, tcfg, params = serve_model
    fwd_in = obs(jcfg, 2, seed=20)
    x, w, b, want = w8a8_case()
    wait = spawn_ranks(tmp_path_factory.mktemp("tp4"), TP4_BODY, {
        "cfg": tcfg, "params": to_torch(params, "cpu"),
        "fwd": [torch.as_tensor(a).long() if a.dtype == np.int32
                else torch.as_tensor(a) for a in fwd_in],
        "rows": ROWS, "obs1": [obs(jcfg, 1, seed=t) for t in range(3)],
        "obs4": [obs(jcfg, 4, seed=10 + t) for t in range(2)],
        "w8a8": (torch.as_tensor(x), torch.as_tensor(w),
                 torch.as_tensor(b))}, n=4)
    out = {"forward": jax_forward(jcfg, params, fwd_in),
           "engine": jax_engine(jcfg, params), "w8a8": want}
    return dict(out, res=wait())


def test_tp4_forward_fixed_exit_matches_jax(tp4_run):
    for r in tp4_run["res"]:
        np.testing.assert_allclose(r["forward"].numpy(), tp4_run["forward"],
                                   **FWD_TOL)


def test_tp4_engine_matches_jax_scan_policy(tp4_run):
    """Equal exit layers, actions within 2e-4, the ranks' exits equal (the
    engine also checked them itself after every step)."""
    seen = set()
    for r in tp4_run["res"]:
        for (a, e), (wa, we) in zip(r["engine"], tp4_run["engine"]):
            assert list(e) == list(we)
            np.testing.assert_allclose(a, wa, **ENGINE_TOL)
            seen |= set(e)
    assert seen == {3, 7}
    exits = [[list(e) for _, e in r["engine"]] for r in tp4_run["res"]]
    assert all(x == exits[0] for x in exits)


def test_tp4_quantized_stacks_are_the_whole_stacks_split(tp4_run):
    """int8 and int4: each rank quantizes its local stacks (row-parallel
    abs-max over the group) to the codes and scales of the whole stacks
    quantized, then split."""
    for r in tp4_run["res"]:
        for mode, (n, same) in r["quantized"].items():
            assert n > 0 and same, mode


def test_tp4_w8a8_row_product_matches_jax_on_the_whole_row(tp4_run):
    for r in tp4_run["res"]:
        for key, want in tp4_run["w8a8"].items():
            got = r["w8a8"][key].numpy()
            assert np.abs(got - want).max() <= W8A8_REL * np.abs(want).max()


# ---------------------------------------------------------------------------
# four ranks, fsdp=2 x tp=2: the train step
# ---------------------------------------------------------------------------


def train_config():
    """deer_9b's topology at 4 layers (exits [1, 3], cross-attention on
    layer 3), d_model 128 and 4 heads."""
    return shrink(jconfig.deer_9b(max_layer=4, exit_interval=2),
                  d_model=128, n_heads=4, n_layers=4)


TRAIN_BODY = """
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.ops.layers import (flat_key, tree_leaves_with_path,
                                           tree_map)
    from deer_vla_tpu_torch.parallel.mesh import Mesh, axis_groups
    from deer_vla_tpu_torch.parallel.sharding import (
        Layout, gather_params, placements_by_path, shard_params)
    from deer_vla_tpu_torch.train.optimizer import make_optimizer
    from deer_vla_tpu_torch.train.train_step import (init_train_state,
                                                     make_train_step)
    from deer_vla_tpu_torch.eval.sharded_serving import ShardedBatchedPolicy
    cfg, whole = inputs["cfg"], inputs["params"]
    mesh = Mesh(1, 2, 2)
    groups = axis_groups(mesh, rank)
    local, specs = shard_params(whole, mesh, rank, fsdp=True, tp=True,
                                min_size=1024)
    layout = Layout(mesh, rank, specs, groups)
    # serving first: the train step updates the shards in place
    pol = ShardedBatchedPolicy.from_shards(local, layout, cfg, device="cpu",
                                           indexed_mm=True,
                                           check_tp_exits=True)
    pol.set_thresholds_batch(inputs["rows"])
    served = [pol.step_batch(*o) for o in inputs["obs"]]
    del pol
    opt = make_optimizer(local, cfg, phase="joint", learning_rate=1e-3,
                         warmup_steps=0, total_steps=10,
                         trainable=trainable_mask(local, cfg, "joint"))
    step = make_train_step(cfg, opt, layout=layout)
    i, b, w = mesh.data_index(rank), 2, cfg.window_size
    rows = {k: (v[i * b:(i + 1) * b] if k == "labels"
                else v[i * b * w:(i + 1) * b * w])
            for k, v in inputs["batch"].items()}
    d = {k: v[i * b:(i + 1) * b] for k, v in inputs["draws"].items()}
    st, m = step(init_train_state(local, opt), rows, draws=[d])
    full = gather_params(st.params, specs, mesh, groups)
    result = {"served": served,
              "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
              "params": {flat_key(p): v for p, v in
                         tree_leaves_with_path(full)},
              "moments": {k: (v.numel(), st.opt_state["nu"][k].numel())
                          for k, v in st.opt_state["mu"].items()},
              "specs": {flat_key(p): s for p, s in
                        placements_by_path(specs).items()}}
"""


SERVE_ROWS = [[1e8, 1e8], [-1.0, 1e8], [-1.0, 1e8], [1e8, 1e8]]


@pytest.fixture(scope="module")
def fsdp_tp_run(tmp_path_factory):
    """One spawn of four ranks, fsdp=2 x tp=2: each builds a sharded
    serving engine from its shards (``ShardedBatchedPolicy.from_shards``:
    the fsdp shards gathered once, tp on the rest) and steps B=4 streams,
    then takes one train step; JAX's engine and step meanwhile."""
    jcfg = train_config()
    tcfg, params = draw_np(jcfg, seed=4)
    batch = sharding_test_batch(jcfg, bs=4)
    rng = jax.random.PRNGKey(2)
    obs4 = [obs(jcfg, 4, seed=30 + t) for t in range(2)]
    wait = spawn_ranks(tmp_path_factory.mktemp("fsdp_tp"), TRAIN_BODY, {
        "cfg": tcfg, "params": to_torch(params, "cpu"),
        "batch": {k: torch.as_tensor(v).long() if v.dtype == np.int32
                  else torch.as_tensor(v) for k, v in batch.items()},
        "draws": layer_draws(jcfg, rng, 4), "rows": SERVE_ROWS,
        "obs": obs4}, n=4)
    jp = jax.tree.map(jnp.asarray, params)
    jpol = JaxScanPolicy(jp, jcfg, indexed_mm=True)
    jpol.set_thresholds_batch(SERVE_ROWS)
    served = [tuple(np.asarray(a) for a in jpol.step_batch(
        *(jnp.asarray(x) for x in o))) for o in obs4]
    mask = jflam.trainable_mask(jp, jcfg, "joint")
    opt = joptim.make_optimizer(jp, jcfg, phase="joint", learning_rate=1e-3,
                                warmup_steps=0, total_steps=10,
                                trainable=mask)
    step = jstep.make_train_step(jcfg, opt, donate=False, trainable=mask)
    js, jm = step(jstep.init_train_state(jp, opt),
                  {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return {"res": wait(), "params": params, "mask": mask, "state": js,
            "metrics": jm, "served": served}


def test_fsdp2_tp2_sharded_serving_matches_jax(fsdp_tp_run):
    """Every rank returns all 4 streams' actions and exits, equal to JAX's
    engine on the whole tree (exits equal, actions within 2e-4)."""
    for r in fsdp_tp_run["res"]:
        for (a, e), (wa, we) in zip(r["served"], fsdp_tp_run["served"]):
            np.testing.assert_array_equal(e, we)
            np.testing.assert_allclose(a, wa, **ENGINE_TOL)
    assert {1, 3} <= {int(x) for _, e in fsdp_tp_run["served"] for x in e}


def test_fsdp2_tp2_train_step_matches_jax(fsdp_tp_run):
    """JAX's step on the global batch of 4 trajectories, and the port's on
    four ranks (two data shards of 2 trajectories, each on a tp pair), from
    the same weights and layer draws: the global loss, grad_norm and every
    updated leaf; frozen leaves bit-unchanged; a rank's Adam moments of a
    leaf split on both axes a quarter of the leaf (ZeRO-3)."""
    res, jm = fsdp_tp_run["res"], fsdp_tp_run["metrics"]
    want = jax_flat(fsdp_tp_run["state"].params)
    before = jax_flat(fsdp_tp_run["params"])
    trained = {k for k, m in jax_flat(fsdp_tp_run["mask"]).items() if m}
    for r in res:
        assert abs(r["loss"] - float(jm["loss"])) <= \
            STEP_LOSS_REL * abs(float(jm["loss"]))
        assert abs(r["grad_norm"] - float(jm["grad_norm"])) <= \
            GRAD_NORM_REL * float(jm["grad_norm"])
        for k, v in r["params"].items():
            v = v.numpy()
            if k not in trained:
                np.testing.assert_array_equal(v, before[k])
                continue
            err = np.linalg.norm(v.astype(np.float64) - want[k])
            bound = (PARAM_REL_L2 * np.linalg.norm(want[k])
                     + UPDATE_REL_L2 * np.linalg.norm(
                         want[k].astype(np.float64) - before[k]))
            assert err <= bound, (k, err, bound)
        split = [k for k, s in r["specs"].items()
                 if "fsdp" in s and "tp" in s and k in r["moments"]]
        assert split
        for k in split:
            assert r["moments"][k][0] * 4 == before[k].size
            assert r["moments"][k][1] * 4 == before[k].size
