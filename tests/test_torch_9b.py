"""PyTorch port, the 9B model (deer_9b: MPT-7B, cross-attention every 4
layers) and the model registry, against the JAX package on the CPU.

The 9B topology is kept and its widths cut, as tests/test_9b_sharded.py
does: ``deer_9b(max_layer=8, exit_interval=4)`` with a d_model-128 decoder
and deer_tiny's vision tower and head, so cross-attention runs on layers 3
and 7 only and the exits are [3, 7].  Weights are the JAX init bridged
(cross-attention gates opened so the vision path reaches the actions),
inputs numpy draws from a seed, fp32.

Exit layers must be equal; actions, gripper and carries within 2e-4 (the
tolerance tests/test_torch_scan_policy.py holds the serving step to), in
fp32 and int8 / int4; calibration values within 1e-4 relative L2
(tests/test_torch_calibrate.py) and thresholds within 1e-4 relative or
1e-7 absolute (``DELTA_ATOL``); a train step within the tolerances of
tests/test_torch_train_steps.py.  The presets' JSON and both CLIs' parse of
``--model mpt_9b`` / ``llama_9b`` are checked at full width (config only:
the full-width runs are ``chip_smoke.py``'s, on the card).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deer_vla_tpu.cli import eval as jeval_cli
from deer_vla_tpu.cli import train as jtrain_cli
from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeerPolicy
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScanPolicy
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu.models.value_net import ExitController as JaxController
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.models.value_net import ExitController
from deer_vla_tpu_torch.train import checkpoint as tckpt
from deer_vla_tpu_torch.train import optimizer as toptim
from deer_vla_tpu_torch.train import train_step as tstep
from test_torch_calibrate import (debug_batches, jax_batch_draws,
                                  make_media, make_text)
from test_torch_scan_policy import obs
from torch_train_common import (GRAD_REL_L2, PARAM_REL_L2, STEP_LOSS_REL,
                                UPDATE_REL_L2, capture_grads, jax_draws,
                                jax_flat, make_batch, port_draws, rel_l2,
                                torch_batch, torch_flat)

TOL = dict(rtol=2e-4, atol=2e-4)
REL_L2 = 1e-4
# a threshold is one calibration delta, the L2 difference of two actions of
# scale 0.1-1 whose fp32 errors it keeps: 1e-7 absolute (a few ulps of the
# actions) on deltas of about 1e-4
DELTA_ATOL = 1e-7
# B=1 thresholds: the first exit always, never, and at a value between
THRESHOLDS = [[1e8, 1e8], [-1.0, 1e8], [1e-3, 1e8]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops: one intra-op thread keeps them from waiting on a pool
    the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shrink(cfg, d_model=128, n_heads=4, n_layers=8):
    """A preset at test width: its topology (cross-attention layout, exit
    grid, decoder arch) kept, deer_tiny's vision tower, head and text,
    fp32."""
    tiny = jconfig.deer_tiny()
    return dataclasses.replace(
        cfg, vit=tiny.vit, perceiver=tiny.perceiver,
        mpt=dataclasses.replace(cfg.mpt, d_model=d_model, n_heads=n_heads,
                                n_layers=n_layers, vocab_size=128,
                                max_seq_len=64),
        head=dataclasses.replace(tiny.head, in_features=d_model),
        text_len=tiny.text_len, media_token_id=tiny.media_token_id,
        eoc_token_id=tiny.eoc_token_id, window_size=tiny.window_size,
        dtypes=jconfig.FP32)


def port_config(jcfg):
    return tconfig.DeerConfig.from_json(jcfg.to_json())


def open_gates(params, seed):
    r = np.random.RandomState(seed)
    for x in params["decoder"]["xattn"]:
        if x is not None:
            x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
            x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return params


def init_np(jcfg, seed=0):
    return open_gates(jax.tree.map(np.asarray, jflam.init_deer(
        jax.random.PRNGKey(seed), jcfg)), seed + 100)


def tree_sig(tree, path=()):
    """(path, shape, dtype) of every leaf, dict keys sorted (JAX's order);
    None leaves kept."""
    if tree is None:
        return [(path, None)]
    if isinstance(tree, dict):
        return sum((tree_sig(v, path + (k,)) for k, v in sorted(tree.items())),
                   [])
    if isinstance(tree, (list, tuple)):
        return sum((tree_sig(v, path + (i,)) for i, v in enumerate(tree)), [])
    return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def assert_masks_match_jax(jcfg, tcfg, params):
    """trainable_mask in both phases and checkpoint_mask, leaf for leaf."""
    jp = jax.tree.map(jnp.asarray, params)
    tp = to_torch(params, "cpu")
    for phase in ("joint", "exit_only"):
        want = jax.tree.map(bool, jflam.trainable_mask(jp, jcfg, phase))
        got = tflam.trainable_mask(tp, tcfg, phase)
        assert tree_sig_bool(got) == tree_sig_bool(want), phase
    assert tree_sig_bool(tflam.checkpoint_mask(tp, tcfg)) == tree_sig_bool(
        jax.tree.map(bool, jflam.checkpoint_mask(jp, jcfg)))


def tree_sig_bool(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return sum((tree_sig_bool(v, path + (k,))
                    for k, v in sorted(tree.items())), [])
    if isinstance(tree, (list, tuple)):
        return sum((tree_sig_bool(v, path + (i,))
                    for i, v in enumerate(tree)), [])
    return [(path, bool(tree))]


def controllers(cfg, th):
    out = []
    for cls in (JaxController, ExitController):
        c = cls(exit_id_list=list(cfg.all_exit_ids()),
                max_layer=cfg.n_layers)
        c.set_threshold_values(th)
        out.append(c)
    return out


def same_carry(ct, cj):
    for t, j in zip(ct, cj):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def step_both(jpol, tpol, cfg, seed, b=1):
    img, grip, ids, mask = obs(cfg, b, seed)
    a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip), jnp.asarray(ids),
                    jnp.asarray(mask))
    a_t = tpol.step(img, grip, ids, mask)
    assert tpol.last_exit_layer == jpol.last_exit_layer, seed
    np.testing.assert_allclose(a_t, a_j, **TOL)
    return tpol.last_exit_layer


def assert_train_steps_match(jcfg, tcfg, params, phase):
    """Two train steps: the loss, every gradient leaf (a trainable leaf the
    loss does not reach: None in the port, zero in JAX) and every param
    after the update (tests/torch_train_common.py's tolerances)."""
    jp = jax.tree.map(jnp.asarray, params)
    tp = to_torch(params, "cpu")
    kw = dict(phase=phase, learning_rate=1e-3, warmup_steps=0,
              total_steps=4, scheduler="linear", weight_decay=0.1,
              exit_lr_scale=2.0)
    jmask = jflam.trainable_mask(jp, jcfg, phase)
    jopt = optax.chain(capture_grads(), joptim.make_optimizer(
        jp, jcfg, trainable=jmask, **kw))
    topt = toptim.make_optimizer(
        tp, tcfg, trainable=tflam.trainable_mask(tp, tcfg, phase), **kw)
    jfn = jstep.make_train_step(jcfg, jopt, phase=phase, bin_coef=0.01,
                                donate=False, trainable=jmask)
    tfn = tstep.make_train_step(tcfg, topt, phase=phase, bin_coef=0.01)
    js = jstep.init_train_state(jp, jopt)
    ts = tstep.init_train_state(tp, topt)
    keys = topt.trainable_keys()
    for it in range(2):
        batch = make_batch(jcfg, 2, seed=10 + it)
        rng = jax.random.PRNGKey(20 + it)
        draws = jax_draws(jcfg, js.params, batch, rng, 1)
        tb = torch_batch(batch)
        _, _, grads = tstep.loss_and_grads(ts.params, keys, tb, tcfg,
                                           phase=phase,
                                           draws=port_draws(draws))
        before = jax_flat(js.params)
        js, jm = jfn(js, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        ts, tm = tfn(ts, tb, draws=port_draws(draws))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            STEP_LOSS_REL * abs(float(jm["loss"]))
        jg = jax_flat(js.opt_state[0])
        for k in keys:
            if grads[k] is None:
                assert not jg[k].any(), k
            else:
                assert rel_l2(grads[k], jg[k]) <= GRAD_REL_L2, (it, k)
        want = jax_flat(js.params)
        for k, v in torch_flat(ts.params).items():
            err = np.linalg.norm(v.numpy().astype(np.float64) - want[k])
            bound = (PARAM_REL_L2 * np.linalg.norm(want[k])
                     + UPDATE_REL_L2 * np.linalg.norm(
                         want[k].astype(np.float64) - before[k]))
            assert err <= bound, (it, k, err, bound)
    return keys


@pytest.fixture(scope="module")
def topo9b():
    jcfg = shrink(jconfig.deer_9b(max_layer=8, exit_interval=4))
    return jcfg, port_config(jcfg), init_np(jcfg)


# ---------------------------------------------------------------------------
# the presets and the registry
# ---------------------------------------------------------------------------


def test_registry_keys_match_jax():
    assert list(tconfig.MODEL_REGISTRY) == list(jconfig.MODEL_REGISTRY)


@pytest.mark.parametrize("name", list(jconfig.MODEL_REGISTRY))
def test_preset_json_matches_jax(name):
    assert tconfig.MODEL_REGISTRY[name]().to_json() == \
        jconfig.MODEL_REGISTRY[name]().to_json()


def test_deer_9b_preset():
    cfg = tconfig.deer_9b()
    assert (cfg.mpt.d_model, cfg.mpt.n_heads, cfg.mpt.head_dim) == \
        (4096, 32, 128)
    assert cfg.n_layers == 12 and cfg.cross_attn_every_n_layers == 4
    assert [i for i in range(12) if cfg.has_xattn(i)] == [3, 7, 11]
    assert cfg.all_exit_ids() == (3, 7, 11)
    assert tconfig.deer_9b(max_layer=8).to_json() == \
        jconfig.deer_9b(max_layer=8).to_json()


@pytest.mark.parametrize("q4", [None, False, True])
def test_indexed_matmul_plans_at_9b_products(q4):
    """K2 (q4 None), K3 and K4 at deer_9b's four products, 32-256 rows:
    wqkv at 256 rows one 256-row wgmma block a strip, no split (96 blocks);
    out_proj and mlp_down at 32 rows mma.sync blocks split 4 ways over K
    (256 blocks); a wgmma grid within one wave of the 132 SMs; shared
    memory within a block's."""
    from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm

    def plan(m, k, n):
        return (imm.indexed_matmul_plan(m, k, n) if q4 is None
                else imm.indexed_matmul_quant_plan(m, k, n, q4))

    p = plan(256, 4096, 12288)
    assert (p.config, p.splits, p.blocks) == (2, 1, 96)
    for k in (4096, 16384):
        p = plan(32, k, 4096)
        assert (p.config, p.splits, p.blocks) == (0, 4, 256)
    for k, n in ((4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096)):
        for m in (32, 64, 96, 128, 256):
            p = plan(m, k, n)
            assert p.smem <= imm.SMEM_PER_BLOCK
            assert p.k_slice * p.splits == k and p.k_slice % 64 == 0
            if p.instruction == "wgmma":
                assert p.blocks <= imm.H100_SMS, (m, k, n, p)


# ---------------------------------------------------------------------------
# the model at the 9B topology
# ---------------------------------------------------------------------------


def test_layout_and_init_tree_match_jax(topo9b):
    jcfg, tcfg, params = topo9b
    assert [x is not None for x in params["decoder"]["xattn"]] == \
        [False, False, False, True] * 2
    assert tcfg.all_exit_ids() == jcfg.all_exit_ids() == (3, 7)
    got = tflam.init_deer(tcfg, seed=0, device="cpu")
    assert tree_sig(got) == tree_sig(to_torch(params, "cpu"))


def test_decoder_forward_matches_jax(topo9b):
    jcfg, tcfg, params = topo9b
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params, "cpu")
    ids, mask = make_text(jcfg, 3, seed=9)
    media = make_media(jcfg, 3, seed=10)
    hs_j, x_j = jmpt.decoder_forward(jp["decoder"], jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(media),
                                     jcfg)
    hs_t, x_t = tmpt.decoder_forward(tp["decoder"],
                                     torch.as_tensor(ids).long(),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(media), tcfg)
    assert hs_t.shape == (8, 3, jcfg.text_len, 128)
    assert rel_l2(hs_t.numpy(), np.asarray(hs_j)) <= REL_L2
    assert rel_l2(x_t.numpy(), np.asarray(x_j)) <= REL_L2


@pytest.mark.parametrize("train_params", [-1, 140, 280])
def test_masks_match_jax(topo9b, train_params):
    """The x-attn layers that train under a train_params budget are the
    last of layers 3 and 7, as in JAX."""
    jcfg, _, params = topo9b
    jcfg = dataclasses.replace(jcfg, train_params=train_params)
    assert_masks_match_jax(jcfg, port_config(jcfg), params)


@pytest.fixture(scope="module")
def scan_pairs(topo9b):
    jcfg, tcfg, params = topo9b
    jp = jax.tree.map(jnp.asarray, params)
    return {(imm, q): (JaxScanPolicy(jp, jcfg, indexed_mm=imm, quantize=q),
                       ScanDeerPolicy(params, tcfg, indexed_mm=imm,
                                      quantize=q, device="cpu"))
            for imm in (False, True) for q in (None, "int8", "int4")}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
@pytest.mark.parametrize("indexed_mm", [False, True])
def test_scan_step_matches_jax(topo9b, scan_pairs, indexed_mm, quantize):
    _, tcfg, _ = topo9b
    jpol, tpol = scan_pairs[(indexed_mm, quantize)]
    seen = set()
    for th in THRESHOLDS:
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for t in range(3):
            seen.add(step_both(jpol, tpol, tcfg, seed=t))
            same_carry(tpol.carry, jpol.carry)
    assert seen == {3, 7}


@pytest.mark.parametrize("indexed_mm", [False, True])
def test_scan_step_batch_per_stream_rows_match_jax(topo9b, scan_pairs,
                                                   indexed_mm):
    _, tcfg, _ = topo9b
    jpol, tpol = scan_pairs[(indexed_mm, None)]
    rows = THRESHOLDS + [[1e-4, 1e8]]
    for p in (jpol, tpol):
        p.set_thresholds_batch(rows)
        p.reset()
    seen = set()
    for t in range(3):
        img, grip, ids, mask = obs(tcfg, 4, seed=10 + t)
        acts_j, ex_j = jpol.step_batch(jnp.asarray(img), jnp.asarray(grip),
                                       jnp.asarray(ids), jnp.asarray(mask))
        acts_t, ex_t = tpol.step_batch(img, grip, ids, mask)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
        same_carry(tpol.carry, jpol.carry)
        seen |= set(ex_t.tolist())
    assert seen == {3, 7}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_deer_policy_matches_jax(topo9b, quantize):
    """The host-bucketed engine: dynamic exits with the thresholds of each
    row of THRESHOLDS in turn, the carry threaded."""
    jcfg, tcfg, params = topo9b
    jc, tc = controllers(tcfg, THRESHOLDS[0])
    jpol = JaxDeerPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                         controller=jc, quantize=quantize)
    tpol = DeerPolicy(params, tcfg, controller=tc, quantize=quantize,
                      device="cpu")
    seen = set()
    for t, th in enumerate(THRESHOLDS * 2):
        jc.set_threshold_values(th)
        tc.set_threshold_values(th)
        for p in (jpol, tpol):
            p.set_timestep(t)
        seen.add(step_both(jpol, tpol, tcfg, seed=t))
        same_carry(tpol.carry, jpol.carry)
    assert seen == {3, 7}


@pytest.mark.parametrize("streamed", [False, True])
def test_calibrate_matches_jax(topo9b, streamed):
    """Calibration over exits [3, 7] under the mpt_9b target schedule (its
    first exit at probability 0, value_net.py:235-236)."""
    jcfg, tcfg, params = topo9b
    tok = HashTokenizer(vocab_size=128, max_length=8)
    jcfg, tcfg = (dataclasses.replace(c, media_token_id=tok.media_token_id)
                  for c in (jcfg, tcfg))
    batches = debug_batches(jcfg, tok, num=2, seed=8)
    ratio = 0.5
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, params), jcfg,
                                  batches, ratio, max_batches=2,
                                  streamed=streamed, model_name="mpt_9b")
    probs = (tcal.streamed_sample_probs(tcfg, ratio, None, "exp", "mpt_9b")
             if streamed else None)
    th_t, vals_t = tcal.calibrate(
        to_torch(params, "cpu"), tcfg, batches, ratio, max_batches=2,
        streamed=streamed, model_name="mpt_9b",
        draws=jax_batch_draws(jcfg, 2, streamed, probs))
    assert vals_t.shape == vals_j.shape and vals_t.shape[0] == 2
    assert rel_l2(vals_t, vals_j) <= REL_L2
    assert list(th_t) == list(th_j) == [3, 7]
    np.testing.assert_allclose([th_t[e] for e in th_t],
                               [th_j[e] for e in th_j], rtol=REL_L2,
                               atol=DELTA_ATOL)


@pytest.mark.parametrize("phase", ["joint", "exit_only"])
def test_train_steps_match_jax(topo9b, phase):
    jcfg, tcfg, params = topo9b
    keys = assert_train_steps_match(jcfg, tcfg, params, phase)
    xattn = {k.split("/")[2] for k in keys if k.startswith("decoder/xattn")}
    assert xattn == ({"3", "7"} if phase == "joint" else set())


# ---------------------------------------------------------------------------
# the CLIs and the checkpoint's backbone record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--max_layer", "8"],
                                  ["--precision", "fp32"]])
def test_eval_cli_resolves_mpt_9b_as_jax(argv):
    argv = ["--model", "mpt_9b"] + argv
    want = jeval_cli.build_parser().parse_args(argv)
    got = eval_cli.build_parser().parse_args(argv)
    factory = jconfig.MODEL_REGISTRY[want.model]
    jcfg = factory(max_layer=want.max_layer if want.max_layer > 0 else 12,
                   dtypes=jconfig.BF16 if want.precision == "bf16"
                   else jconfig.FP32)
    assert eval_cli.model_config(got).to_json() == jcfg.to_json()


@pytest.mark.parametrize("argv", [[], ["--max_layer", "32"]])
def test_eval_cli_resolves_llama_9b_at_its_depth(argv):
    """The JAX CLI hands bc_llama a max_layer it does not take (TypeError);
    the port hands the depth over as its n_layers, 12 unless given."""
    args = eval_cli.build_parser().parse_args(["--model", "llama_9b"] + argv)
    depth = int(argv[1]) if argv else 12
    assert eval_cli.model_config(args).to_json() == \
        jconfig.bc_llama(n_layers=depth).to_json()
    with pytest.raises(TypeError):
        jconfig.MODEL_REGISTRY["llama_9b"](max_layer=12)


def test_train_cli_resolves_both_models():
    base = ["--debug", "--window_size", "12"]
    for model in ("mpt_9b", "mpt_dolly_3b"):
        argv = ["--model", model] + base
        want = jtrain_cli.make_model_config(
            jtrain_cli.build_parser().parse_args(argv))
        got = train_cli.make_model_config(
            train_cli.build_parser().parse_args(argv))
        assert got.to_json() == want.to_json()
    got = train_cli.make_model_config(train_cli.build_parser().parse_args(
        ["--model", "llama_9b", "--max_layer", "8"] + base))
    assert got.to_json() == jconfig.bc_llama(n_layers=8).to_json()


def test_backbone_records_tell_the_models_apart():
    recs = {name: tckpt.init_record(0, "cpu", f())
            for name, f in tconfig.MODEL_REGISTRY.items()}
    assert len({json.dumps(r, sort_keys=True) for r in recs.values()}) == 4
    for a in recs.values():
        json.dumps(a)  # the sidecar stores it as JSON
        tckpt.check_init(a, dict(a), "same")
    with pytest.raises(ValueError, match="trained over the backbone"):
        tckpt.check_init(recs["mpt_9b"], recs["llama_9b"], "x")
    tome = dataclasses.replace(tconfig.deer_9b(), vit=dataclasses.replace(
        tconfig.deer_9b().vit, tome_r=8))
    assert tckpt.init_record(0, "cpu", tome) == recs["mpt_9b"]
