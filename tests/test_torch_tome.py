"""PyTorch port, ToMe token merging (``ops/tome.py``, ``models/vit.
vit_forward_tome``) against the JAX package's on the CPU, on the same
bridged weights and numpy-seeded inputs.

Tolerances: the merge in fp32 within 1e-5 (the size-weighted sums run in
another order); the merged sizes exactly (integers in fp32); the ViT tower
within 2e-5, as tests/test_torch_models.py holds the exact tower; the
serving step within 2e-4 with equal exit layers, as
tests/test_torch_scan_policy.py holds the exact step; the training forward
within 1e-4 relative L2, as tests/test_torch_calibrate.py holds it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxPolicy
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import vit as jvit
from deer_vla_tpu.ops import tome as jtome
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval import flops as tflops
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import vit as tvit
from deer_vla_tpu_torch.ops import tome as ttome

MERGE_TOL = dict(rtol=1e-5, atol=1e-5)
VIT_TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread keeps them
    from waiting on a pool the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("args", [(256, 24, 8), (4, 2, 1), (4, 2, 3),
                                  (16, 10, 5), (16, 3, 0), (257, 24, 20)])
def test_schedule_matches_jax_and_flops_use_it(args):
    assert ttome.tome_schedule(*args) == jtome.tome_schedule(*args)
    assert ttome.tome_schedule(16, 10, 5, min_keep=3) == \
        jtome.tome_schedule(16, 10, 5, min_keep=3)
    assert tflops.tome_schedule is ttome.tome_schedule


def merge_inputs(seed, b=3, n=12, d=8, dm=5, ties=False):
    r = np.random.RandomState(seed)
    tokens = r.randn(b, n, d).astype(np.float32)
    metric = r.randn(b, n, dm).astype(np.float32)
    sizes = r.randint(1, 4, (b, n)).astype(np.float32)
    if ties:
        # flat frames: runs of identical patches give equal scores (argmax
        # must take the first maximum) and equal node maxima (the sort must
        # keep index order)
        metric[:, 4:] = metric[:, 4:5]
        metric[1] = metric[1, :1]
        tokens[1] = tokens[1, :1]
    return tokens, metric, sizes


@pytest.mark.parametrize("r", [1, 3, 6])
@pytest.mark.parametrize("ties", [False, True])
def test_bipartite_merge_matches_jax(r, ties):
    tokens, metric, sizes = merge_inputs(r, ties=ties)
    jt, js = jtome.bipartite_merge(jnp.asarray(tokens), jnp.asarray(metric),
                                   jnp.asarray(sizes), r)
    tt, ts = ttome.bipartite_merge(torch.from_numpy(tokens),
                                   torch.from_numpy(metric),
                                   torch.from_numpy(sizes), r)
    assert tt.shape == (3, 12 - r, 8) and ts.shape == (3, 12 - r)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **MERGE_TOL)


def test_match_pairs_takes_first_maxima_in_index_order():
    """All-equal similarities: every A row's best match is B row 0 and the
    A rows merge in index order."""
    metric = torch.ones(1, 8, 4)
    src, unm, dst = ttome.match_pairs(metric, 3)
    assert src.tolist() == [[0, 1, 2]] and unm.tolist() == [[3]]
    assert dst.tolist() == [[0, 0, 0]]


def test_merge_r0_returns_inputs_and_refuses_too_many():
    t, s = torch.ones(1, 4, 2), torch.ones(1, 4)
    out_t, out_s = ttome.bipartite_merge(t, t, s, 0)
    assert out_t is t and out_s is s
    with pytest.raises(ValueError):
        ttome.bipartite_merge(t, t, s, 3)


def test_proportional_bias_matches_jax_and_is_a_stride0_view():
    sizes = np.array([[1.0, 2.0, 4.0], [3.0, 1.0, 1.0]], np.float32)
    want = jtome.proportional_attn_bias(jnp.asarray(sizes), 5)
    got = ttome.proportional_attn_bias(torch.from_numpy(sizes), 5)
    assert got.shape == (2, 1, 5, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    # one (B, sk) row in memory, read along sq and the heads at stride 0
    assert got.untyped_storage().nbytes() == sizes.nbytes
    assert got.stride(2) == 0 and got.expand(2, 4, 5, 3).stride(1) == 0


VIT = jconfig.ViTConfig(image_size=56, patch_size=14, width=32, layers=3,
                        heads=4)


@pytest.fixture(scope="module")
def vit():
    params = jvit.init_vit(jax.random.PRNGKey(0), VIT)
    x = np.random.RandomState(1).randn(2, 3, 56, 56).astype(np.float32)
    return params, to_torch(jax.tree.map(np.asarray, params), "cpu"), x


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("stacked", [False, True])
def test_vit_forward_tome_matches_jax(vit, r, stacked):
    jp, tp, x = vit
    jcfg = dataclasses.replace(VIT, tome_r=r)
    tcfg = tconfig.ViTConfig(**dataclasses.asdict(jcfg))
    cls_j, tok_j = jax.jit(lambda p, v: jvit.vit_forward_tome(p, v, jcfg))(
        jp, jnp.asarray(x))
    cls_t, tok_t = tvit.vit_forward_tome(
        tp, torch.from_numpy(x), tcfg,
        tvit.stack_vit_blocks(tp) if stacked else None)
    assert tok_t.shape == (2, 16 - sum(ttome.tome_schedule(16, 3, r)), 32)
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), **VIT_TOL)
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), **VIT_TOL)


def test_vit_forward_tome_r0_is_vit_forward_bit_for_bit(vit):
    _, tp, x = vit
    tcfg = tconfig.ViTConfig(**dataclasses.asdict(VIT))
    xt = torch.from_numpy(x)
    for a, b in zip(tvit.vit_forward(tp, xt, tcfg),
                    tvit.vit_forward_tome(tp, xt, tcfg)):
        assert torch.equal(a, b)


def tiny_tome(r=1, seed=0):
    """deer_tiny at 56 px (16 patches) with ToMe r, the JAX weights with
    open cross-attention gates, bridged."""
    jcfg, tcfg = (dataclasses.replace(c, vit=dataclasses.replace(
        c.vit, image_size=56, tome_r=r))
        for c in (jconfig.deer_tiny(), tconfig.deer_tiny()))
    params = jax.tree.map(np.asarray,
                          jflam.init_deer(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed + 100)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = rs.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = rs.uniform(-1, 1, (1,)).astype(np.float32)
    return jcfg, tcfg, params


def step_obs(cfg, b, seed):
    r = np.random.RandomState(seed)
    hw, s = cfg.vit.image_size, cfg.text_len
    img = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    ids = r.randint(0, cfg.media_token_id, size=(b, s)).astype(np.int32)
    ids[:, 0] = cfg.media_token_id
    return img, grip, ids, np.ones((b, s), np.int32)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_scan_policy_with_tome_matches_jax(quantize):
    jcfg, tcfg, params = tiny_tome()
    th = [4.2e-4, 1e8]  # these weights' first-exit deltas straddle it
    jpol = JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg, thresholds=th,
                     quantize=quantize)
    tpol = ScanDeerPolicy(params, tcfg, thresholds=th, indexed_mm=True,
                          quantize=quantize, device="cpu")
    seen = set()
    for t in range(3):
        img, grip, ids, mask = step_obs(tcfg, 1, seed=t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                        jnp.asarray(ids), jnp.asarray(mask))
        a_t = tpol.step(img, grip, ids, mask)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        seen.add(tpol.last_exit_layer)
        np.testing.assert_allclose(a_t, a_j, **STEP_TOL)
    acts_j, ex_j = jpol.step_batch(*(jnp.asarray(a) for a in
                                     step_obs(tcfg, 3, seed=9)))
    acts_t, ex_t = tpol.step_batch(*step_obs(tcfg, 3, seed=9))
    np.testing.assert_array_equal(ex_t, np.asarray(ex_j))
    np.testing.assert_allclose(acts_t, np.asarray(acts_j), **STEP_TOL)
    assert seen | set(ex_t.tolist()) == {1, 3}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_forward_train_with_tome_matches_jax():
    """The training forward (ViT under no_grad, merged tower) given JAX's
    layer draws."""
    jcfg, tcfg, params = tiny_tome(r=2, seed=3)
    w = jcfg.window_size
    img, grip, ids, mask = step_obs(tcfg, 2 * w, seed=5)
    rng = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, a, b, c, g: jflam.forward_train(
        p, a, b, c, jcfg, rng, vision_gripper=g, train=False))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(img),
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(grip))
    rngs = jax.random.split(rng, 8)
    prev_len = jax.random.randint(rngs[4], (), 1, w + 1)
    idx2 = jax.random.randint(rngs[5], (2, 2), 0, jcfg.num_exits)
    pick = jnp.where(jnp.arange(w)[None] < prev_len, idx2[:, :1],
                     idx2[:, 1:])
    switch = np.array(jnp.asarray(jcfg.all_exit_ids())[pick])
    got = tflam.forward_train(
        to_torch(params, "cpu"), torch.from_numpy(img),
        torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg,
        vision_gripper=torch.from_numpy(grip), train=False,
        rand_layer_ids=torch.as_tensor(np.array(want.rand_layer_ids)),
        switch_layer_ids=torch.as_tensor(switch))
    assert rel_l2(got.hidden_states, want.hidden_states) < 1e-4
    for part in ("final_output", "extra_output", "extra_output2"):
        assert rel_l2(getattr(got, part).actions,
                      getattr(want, part).actions) < 1e-4


def test_train_cli_vit_tome_r_matches_jax_config_and_trains(tmp_path):
    """cli/train --vit_tome_r: the config JAX's CLI builds from the same
    flags, and a tiny run whose checkpoint records the merged tower and
    serves it (--layerwise_exit_eval on the host-bucketed engine)."""
    import json
    import os

    from deer_vla_tpu.cli import train as jtrain
    from deer_vla_tpu_torch.cli import eval as eval_cli
    from deer_vla_tpu_torch.cli import train as train_cli
    flags = ["--model", "tiny", "--vit_tome_r", "1"]
    want = jtrain.make_model_config(jtrain.build_parser().parse_args(flags))
    got = train_cli.make_model_config(
        train_cli.build_parser().parse_args(flags))
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.vit.tome_r == 1
    run = str(tmp_path / "run")
    train_cli.main(["--debug", "--num_joint_epochs", "1", "--num_exit_epochs",
                    "0", "--batch_size_calvin", "2", "--run_name", run,
                    "--joint_warmup_steps", "1", "--precision", "fp32"]
                   + flags, device="cpu")
    side = json.load(open(os.path.join(run, "deer_0.json")))
    assert side["config"]["vit"]["tome_r"] == 1
    report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                            os.path.join(run, "deer_0.ckpt"),
                            "--precision", "fp32", "--num_sequences_override",
                            "1", "--calib_batches", "1",
                            "--layerwise_exit_eval"], device="cpu")
    assert np.isfinite(report["avg_seq_len"])
