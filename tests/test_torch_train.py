"""PyTorch port, the training path: the multi-exit loss, the freeze masks,
the grouped AdamW against optax, head dropout, the train step in both
phases and with gradient accumulation, the trainer's behaviour and the
train CLI, each against the JAX package on the CPU where both have it.

Weights are deer_tiny in fp32, bridged from the JAX init (x-attn gates
opened so the vision path reaches the loss); inputs are numpy draws from a
seed.  The random draws the packages cannot share are taken from the JAX
side and handed to the port: the layer draws of forward_train and every
dropout keep mask, recorded in call order while JAX traces its forward.

CALVIN-format batches (200 px static, 84 px gripper frames of a synthetic
directory, also at ``dif_ws`` windows) go through both ``prepare_batch``es
with JAX's random shifts: frames within 2e-5 absolute (the cubic resize's
fp32 sums); ``--remat`` ('full' and 'dots') gradients within 1e-6 relative
L2 of no remat and 1e-4 of JAX's remat step.

Tolerances (fp32, both sides sum the same products in other orders):
loss and head outputs within 1e-6 absolute on values of unit scale; the
optimizer's params within 1e-6 absolute after three updates at lr 1e-2;
a train step's loss within 1e-5 relative, every gradient leaf within 1e-4
relative L2, and every param leaf after the update within 1e-5 of its norm
plus 1e-4 of the update's norm: Adam divides a gradient by its own size,
so the update carries the gradient's relative error (a zero-initialized
bias is all update after one step).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.train import trainer as jtrainer
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.train import losses as jlosses
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data import calvin as tcalvin
from deer_vla_tpu_torch.data.debug_data import (DebugBatcher,
                                                make_synthetic_calvin)
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.models import action_head as thead
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.ops import attention as tattn
from deer_vla_tpu_torch.ops import rand_shift as tshift
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.kernels.guard import check_no_grad
from deer_vla_tpu_torch.ops.layers import flat_key, keystr, \
    tree_leaves_with_path
from deer_vla_tpu_torch.train import losses as tlosses
from deer_vla_tpu_torch.train import optimizer as toptim
from deer_vla_tpu_torch.train import train_step as tstep
from deer_vla_tpu_torch.train.checkpoint import (backbone_record,
                                                 load_checkpoint)
from deer_vla_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              prepare_batch)

LOSS_ATOL = 1e-6
OPT_ATOL = 1e-6
STEP_LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
PARAM_REL_L2 = 1e-5
UPDATE_REL_L2 = GRAD_REL_L2
FRAME_ATOL = 2e-5
REMAT_REL_L2 = 1e-6


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def jax_flat(tree) -> dict:
    """{flat key: numpy leaf} of a JAX tree, keyed as checkpoints are."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_flat(tree) -> dict:
    return {flat_key(p): v for p, v in tree_leaves_with_path(tree)}


def configs(dropout=0.0, lstm_dropout=0.0, mode="layerwise", **kw):
    tok = HashTokenizer(vocab_size=128, max_length=8)
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.deer_tiny()
        cfg = dataclasses.replace(
            cfg, media_token_id=tok.media_token_id,
            head=dataclasses.replace(cfg.head, dropout=dropout,
                                     lstm_dropout=lstm_dropout,
                                     dropout_mode=mode), **kw)
        out.append(cfg)
    return out[0], out[1]


def open_gates(params, seed=7):
    r = np.random.RandomState(seed)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def tiny_np():
    jcfg, _ = configs()
    return open_gates(jax.tree.map(np.asarray, jflamingo.init_deer(
        jax.random.PRNGKey(0), jcfg)))


# ---------------------------------------------------------------------------
# the guard and the attention's detached max
# ---------------------------------------------------------------------------


def test_kernel_guard_refuses_grad_inputs_under_grad_mode():
    x = torch.ones(2, requires_grad=True)
    y = torch.ones(2)
    check_no_grad("flash_attention", y, None)
    with pytest.raises(RuntimeError, match="flash_attention: an input "
                                           "requires grad.*ROADMAP.md M11"):
        check_no_grad("flash_attention", y, x)
    with pytest.raises(RuntimeError, match="indexed_matmul_q8: .*unstacked"):
        check_no_grad("indexed_matmul_q8", x)
    with torch.no_grad():
        check_no_grad("flash_attention", x)
    with torch.inference_mode():
        check_no_grad("indexed_matmul", x)


def test_plain_attention_gradient_matches_jax():
    """The perceiver, decoder and x-attn train through plain_attention; its
    row max carries no gradient (JAX: stop_gradient on it)."""
    from deer_vla_tpu.ops.attention import _xla_attention
    from deer_vla_tpu_torch.ops.attention import plain_attention
    r = np.random.RandomState(0)
    q, k, v = (r.randn(2, 3, 5, 8).astype(np.float32) for _ in range(3))
    bias = r.randn(1, 1, 5, 5).astype(np.float32)
    gj = jax.grad(lambda a, b, c: (_xla_attention(a, b, c, jnp.asarray(bias),
                                                  0.3) ** 2).sum(),
                  argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (plain_attention(qt, kt, vt, torch.as_tensor(bias), 0.3) ** 2).sum() \
        .backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), gj):
        assert rel_l2(got, want) <= GRAD_REL_L2


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def head_outputs(r, b, w, k):
    out = []
    for i in range(4):
        act = np.tanh(r.randn(b, w, 6 * k)).astype(np.float32)
        glog = r.randn(b, w, k).astype(np.float32) * 2
        out.append((act, glog))

    def build(mod, flam, conv):
        ho = [mod.HeadOutput(conv(a), conv(1 / (1 + np.exp(-g))), conv(g))
              for a, g in out]
        return flam.TrainOutputs((ho[0],), ho[1], ho[2], ho[3], None, None,
                                 None)
    return (build(jhead, jflamingo, jnp.asarray),
            build(thead, tflamingo, torch.as_tensor))


@pytest.mark.parametrize("k,last_step_only", [(1, False), (1, True),
                                              (2, False)])
def test_multi_exit_loss_matches_jax(k, last_step_only):
    r = np.random.RandomState(k)
    b, w = 3, 4
    jout, tout = head_outputs(r, b, w, k)
    shape = (b, w, 7) if k == 1 else (b, w, k, 7)
    labels = np.clip(r.randn(*shape), -1, 1).astype(np.float32)
    labels[..., 6] = np.sign(labels[..., 6])
    want, wm = jlosses.multi_exit_loss(jout, jnp.asarray(labels), 0.05,
                                       last_step_only=last_step_only)
    got, gm = tlosses.multi_exit_loss(tout, torch.as_tensor(labels), 0.05,
                                      last_step_only=last_step_only)
    assert gm.keys() == wm.keys()
    for key in wm:
        np.testing.assert_allclose(gm[key].numpy(), np.asarray(wm[key]),
                                   atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(got), float(want), atol=LOSS_ATOL)


# ---------------------------------------------------------------------------
# the freeze masks
# ---------------------------------------------------------------------------


KNOBS = [("joint", {}), ("exit_only", {}),
         ("joint", {"freeze_embed": True}),
         ("joint", {"freeze_sampler": True}),
         ("joint", {"unfreeze_vit": True}),
         ("exit_only", {"unfreeze_vit": True}),
         ("joint", {"train_params": 280}), ("joint", {"train_params": 0}),
         ("joint", {"train_params": 140 * 7}),
         ("joint", {"share_exit": True}), ("exit_only", {"multi_exit": False})]


@pytest.mark.parametrize("phase,knobs", KNOBS)
def test_masks_and_bf16_cast_match_jax(phase, knobs):
    jcfg, tcfg = configs(**knobs)
    jp = jflamingo.init_deer(jax.random.PRNGKey(0), jcfg)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")

    def jax_bools(tree):
        return {jax.tree_util.keystr(p): bool(v) for p, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def torch_bools(tree):
        return {keystr(p): bool(v) for p, v in tree_leaves_with_path(tree)}

    jm = jflamingo.trainable_mask(jp, jcfg, phase)
    tm = tflamingo.trainable_mask(tp, tcfg, phase)
    assert torch_bools(tm) == jax_bools(jm)
    assert any(torch_bools(tm).values())
    assert torch_bools(tflamingo.checkpoint_mask(tp, tcfg)) == jax_bools(
        jflamingo.checkpoint_mask(jp, jcfg))
    jc = jflamingo.cast_frozen_to_bf16(jp, jm)
    tc = tflamingo.cast_frozen_to_bf16(tp, tm)
    jd = {jax.tree_util.keystr(p): str(v.dtype)
          for p, v in jax.tree_util.tree_flatten_with_path(jc)[0]}
    td = {keystr(p): str(v.dtype).replace("torch.", "")
          for p, v in tree_leaves_with_path(tc)}
    assert td == jd


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase,exit_decay,lr_scale,masked",
                         [("joint", False, 1.0, True),
                          ("joint", True, 2.0, True),
                          ("exit_only", False, 1.0, False),
                          ("joint", False, 3.0, False)])
def test_optimizer_labels_match_jax(tiny_np, phase, exit_decay, lr_scale,
                                    masked):
    """The port's groups against JAX's leaf_label rule on its own paths."""
    jcfg, tcfg = configs()
    tp = to_torch(tiny_np, "cpu")
    jmask = jflamingo.trainable_mask(tiny_np, jcfg, phase) if masked \
        else None
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(tiny_np)[0]:
        ps = joptim._path_str(path)
        head = joptim.is_head_path(ps)
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                       for k in path)
        trainable = jmask is None or _get(jmask, path)
        if (phase == "exit_only" and not head) or not trainable:
            want[key] = "frozen"
            continue
        decay = joptim.apply_decay_path(ps, exit_decay)
        scaled = head and phase == "joint" and lr_scale != 1.0
        want[key] = ("wd" if decay else "nowd") + ("_scaled" if scaled
                                                   else "")
    opt = toptim.make_optimizer(
        tp, tcfg, phase=phase, learning_rate=1e-3, warmup_steps=1,
        total_steps=4, exit_decay=exit_decay, exit_lr_scale=lr_scale,
        trainable=tflamingo.trainable_mask(tp, tcfg, phase) if masked
        else None)
    assert opt.labels == want
    assert len(set(want.values())) >= 2


def _get(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(kind, warmup):
    want = joptim.make_schedule(kind, 2e-3, warmup, 10)
    got = toptim.make_schedule(kind, 2e-3, warmup, 10)
    for step in range(14):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)
    if warmup:
        assert got(0) == 0.0  # optax: step 0 of a warmup has lr 0


@pytest.mark.parametrize("grad_scale,phase,lr_scale",
                         [(10.0, "joint", 2.0), (1e-3, "joint", 1.0),
                          (1e-3, "exit_only", 1.0)])
def test_grouped_adamw_matches_optax_chain(tiny_np, grad_scale, phase,
                                           lr_scale):
    """Three updates on the same gradients: clip active (global norm far
    above 1) and inactive, frozen leaves unchanged although JAX hands them
    nonzero gradients, heads lr-scaled."""
    jcfg, tcfg = configs()
    jp = jax.tree.map(jnp.asarray, tiny_np)
    tp = to_torch(tiny_np, "cpu")
    kw = dict(phase=phase, learning_rate=1e-2, warmup_steps=1,
              total_steps=6, scheduler="linear", weight_decay=0.1,
              exit_lr_scale=lr_scale, exit_decay=False)
    jopt = joptim.make_optimizer(
        jp, jcfg, trainable=jflamingo.trainable_mask(jp, jcfg, phase), **kw)
    topt = toptim.make_optimizer(
        tp, tcfg, trainable=tflamingo.trainable_mask(tp, tcfg, phase), **kw)
    jstate = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    tstate = topt.init(tp)
    r = np.random.RandomState(5)
    frozen_before = {k: v.clone() for k, v in torch_flat(tp).items()
                     if topt.labels[k] == "frozen"}
    keys = topt.trainable_keys()
    for it in range(3):
        grads = jax.tree.map(
            lambda x: (r.randn(*x.shape) * grad_scale).astype(np.float32),
            tiny_np)
        upd, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        flat_g = jax_flat(grads)
        gnorm = topt.update(tp, {k: torch.as_tensor(flat_g[k])
                                 for k in keys}, tstate)
        want = jax_flat(jp)
        for k, v in torch_flat(tp).items():
            np.testing.assert_allclose(v.numpy(), want[k], atol=OPT_ATOL,
                                       rtol=0, err_msg=f"{k} update {it}")
        trainable_norm = np.sqrt(sum(float((flat_g[k].astype(np.float64)
                                            ** 2).sum()) for k in keys))
        np.testing.assert_allclose(float(gnorm), trainable_norm, rtol=1e-5)
    assert (float(gnorm) > 1.0) == (grad_scale > 1.0)
    assert tstate["count"] == 3
    for k, v in frozen_before.items():
        assert torch.equal(torch_flat(tp)[k], v)


# ---------------------------------------------------------------------------
# dropout, with JAX's keep masks replayed
# ---------------------------------------------------------------------------


def with_masks(fn):
    """``fn`` jitted to return ``(its output, [keep masks])``: every mask
    ``jax.random.bernoulli`` draws while ``fn`` is traced, in call order,
    becomes an output of the compiled function."""
    def traced(*args):
        masks = []
        real = jax.random.bernoulli

        def rec(key, p, shape=None):
            masks.append(real(key, p, shape))
            return masks[-1]

        jax.random.bernoulli = rec
        try:
            out = fn(*args)
        finally:
            jax.random.bernoulli = real
        return out, masks
    return jax.jit(traced)


def recorded(fn, *args):
    out, masks = with_masks(fn)(*args)
    return out, [np.asarray(m) for m in masks]


@pytest.mark.parametrize("mode", ["layerwise", "last", "wo_last"])
def test_head_dropout_matches_jax_with_its_masks(mode):
    jcfg, tcfg = configs(dropout=0.4, lstm_dropout=0.3, mode=mode)
    p = jax.tree.map(np.asarray, jhead.init_head(jax.random.PRNGKey(4),
                                                 jcfg.head))
    feat = np.random.RandomState(5).randn(8, 6, 64).astype(np.float32)
    want, masks = recorded(lambda: jhead.head_forward(
        jax.tree.map(jnp.asarray, p), jnp.asarray(feat), jcfg.head,
        dropout_rng=jax.random.PRNGKey(9), train=True))
    n_mlp = {"layerwise": 3, "last": 1, "wo_last": 2}[mode]
    assert len(masks) == 1 + 2 * n_mlp  # one LSTM boundary, two MLPs
    got = thead.head_forward(to_torch(p, "cpu"), torch.as_tensor(feat),
                             tcfg.head, dropout=Dropout(masks=masks))
    inference = thead.head_forward(to_torch(p, "cpu"), torch.as_tensor(feat),
                                   tcfg.head)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOSS_ATOL,
                                   rtol=0)
    assert not torch.allclose(got.actions, inference.actions)


def test_dropout_from_a_generator_is_seeded_and_scaled():
    x = torch.ones(4000)
    a, b = (Dropout(torch.Generator().manual_seed(3))(x, 0.25)
            for _ in range(2))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.75))}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03


# ---------------------------------------------------------------------------
# the train step against make_train_step
# ---------------------------------------------------------------------------


def switch_layer_ids(jcfg, rng, bs):
    """forward_train's sampling-2 layers, recomputed from its key."""
    w, n_exit = jcfg.window_size, jcfg.num_exits
    rngs = jax.random.split(rng, 8)
    prev_len = jax.random.randint(rngs[4], (), 1, w + 1)
    idx2 = jax.random.randint(rngs[5], (bs, 2), 0, n_exit)
    pick = jnp.where(jnp.arange(w)[None] < prev_len, idx2[:, :1], idx2[:, 1:])
    return np.asarray(jnp.asarray(jcfg.all_exit_ids())[pick])


def make_batch(cfg, b, seed):
    r = np.random.RandomState(seed)
    w, s = cfg.window_size, cfg.text_len
    ids = r.randint(1, cfg.media_token_id, (b * w, s)).astype(np.int32)
    ids[:, 0] = cfg.media_token_id
    mask = np.ones_like(ids)
    mask[::3, -2:] = 0
    labels = np.clip(r.randn(b, w, 7) * 0.5, -1, 1).astype(np.float32)
    labels[..., 6] = np.sign(labels[..., 6])
    hw = cfg.vit.image_size
    return {"image": r.randn(b * w, 1, 1, 3, hw, hw).astype(np.float32),
            "gripper": r.randn(b * w, 1, 1, 3, hw, hw).astype(np.float32),
            "input_ids": ids, "attention_mask": mask, "labels": labels}


_DRAW_FNS = {}


def jax_draws(jcfg, params, batch, rng, grad_accum):
    """The layer draws and keep masks of each microbatch of a JAX train
    step: its forward_train run on the same microbatch and key (the
    compiled draw function is kept per config)."""
    if jcfg not in _DRAW_FNS:
        _DRAW_FNS[jcfg] = with_masks(
            lambda p, img, ids, mask, grip, key: jflamingo.forward_train(
                p, img, ids, mask, jcfg, key, vision_gripper=grip,
                train=True).rand_layer_ids)
    fn = _DRAW_FNS[jcfg]
    b = batch["labels"].shape[0]
    mb = b // grad_accum
    rngs = [rng] if grad_accum == 1 else list(jax.random.split(rng,
                                                               grad_accum))
    w = jcfg.window_size
    out = []
    for i, mrng in enumerate(rngs):
        part = {k: v[i * mb:(i + 1) * mb] if k == "labels"
                else v[i * mb * w:(i + 1) * mb * w] for k, v in batch.items()}
        lay1, masks = fn(params, *(jnp.asarray(part[k]) for k in (
            "image", "input_ids", "attention_mask", "gripper")), mrng)
        out.append({"rand_layer_ids": torch.as_tensor(np.asarray(lay1)),
                    "switch_layer_ids": torch.as_tensor(
                        switch_layer_ids(jcfg, mrng, mb)),
                    "masks": [np.asarray(m) for m in masks]})
    return out


def capture_grads():
    """An optax stage that keeps the raw gradients in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def torch_batch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    return out


def port_draws(draws):
    return [{"rand_layer_ids": d["rand_layer_ids"],
             "switch_layer_ids": d["switch_layer_ids"],
             "dropout": Dropout(masks=d["masks"])} for d in draws]


@pytest.mark.parametrize("phase,grad_accum,unfreeze_vit",
                         [("joint", 1, False), ("exit_only", 1, False),
                          ("joint", 2, False), ("joint", 1, True)])
def test_train_steps_match_jax(tiny_np, phase, grad_accum, unfreeze_vit):
    """Two consecutive steps with dropout on: loss, every gradient leaf and
    every param after the update."""
    jcfg, tcfg = configs(dropout=0.3, lstm_dropout=0.2,
                         unfreeze_vit=unfreeze_vit)
    dcfg, _ = configs(dropout=0.3, lstm_dropout=0.2)  # the draws' config
    jp = jax.tree.map(jnp.asarray, tiny_np)
    tp = to_torch(tiny_np, "cpu")
    kw = dict(phase=phase, learning_rate=1e-3, warmup_steps=0,
              total_steps=4, scheduler="linear", weight_decay=0.1,
              exit_lr_scale=2.0)
    jmask = jflamingo.trainable_mask(jp, jcfg, phase)
    jopt = optax.chain(capture_grads(), joptim.make_optimizer(
        jp, jcfg, trainable=jmask, **kw))
    topt = toptim.make_optimizer(
        tp, tcfg, trainable=tflamingo.trainable_mask(tp, tcfg, phase), **kw)
    jfn = jstep.make_train_step(jcfg, jopt, phase=phase, bin_coef=0.01,
                                donate=False, grad_accum=grad_accum,
                                trainable=jmask)
    tfn = tstep.make_train_step(tcfg, topt, phase=phase, bin_coef=0.01,
                                grad_accum=grad_accum)
    js = jstep.init_train_state(jp, jopt)
    ts = tstep.init_train_state(tp, topt)
    keys = topt.trainable_keys()
    assert any(k.startswith("vit/") for k in keys) == unfreeze_vit
    init = jax_flat(tiny_np)
    for it in range(2):
        batch = make_batch(jcfg, 2, seed=10 + it)
        rng = jax.random.PRNGKey(20 + it)
        draws = jax_draws(dcfg, js.params, batch, rng, grad_accum)
        tb = torch_batch(batch)
        _, _, grads = tstep.loss_and_grads(
            ts.params, keys, tb, tcfg, phase=phase, grad_accum=grad_accum,
            draws=port_draws(draws))
        before = jax_flat(js.params)
        js, jm = jfn(js, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        ts, tm = tfn(ts, tb, draws=port_draws(draws))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            STEP_LOSS_REL * abs(float(jm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        jg = jax_flat(js.opt_state[0])
        for k in keys:
            assert grads[k] is not None, k
            assert rel_l2(grads[k], jg[k]) <= GRAD_REL_L2, (it, k)
        want = jax_flat(js.params)
        moved = 0
        for k, v in torch_flat(ts.params).items():
            err = np.linalg.norm(v.numpy().astype(np.float64) - want[k])
            bound = (PARAM_REL_L2 * np.linalg.norm(want[k])
                     + UPDATE_REL_L2 * np.linalg.norm(
                         want[k].astype(np.float64) - before[k]))
            assert err <= bound, (it, k, err, bound)
            moved += int(not np.array_equal(v.numpy(), init[k]))
        assert moved > 0
    heads = {k for k in keys if k.split("/")[0] in ("lm_head", "extra_exit",
                                                    "lm_exits")}
    assert (set(keys) == heads) == (phase == "exit_only")


def test_vit_gets_no_gradient_unless_unfrozen(tiny_np):
    """Asked for every leaf, the ViT's gradient is None: it ran under
    no_grad.  With unfreeze_vit it is a tensor (its values are held
    against JAX in test_train_steps_match_jax)."""
    for unfreeze in (False, True):
        _, tcfg = configs(unfreeze_vit=unfreeze)
        tp = to_torch(tiny_np, "cpu")
        batch = torch_batch(make_batch(tcfg, 1, seed=3))
        keys = list(torch_flat(tp))
        _, _, grads = tstep.loss_and_grads(tp, keys, batch, tcfg,
                                           gen=torch.Generator().manual_seed(0))
        vit = [grads[k] for k in keys if k.startswith("vit/")]
        assert all((g is None) != unfreeze for g in vit)
        assert grads["decoder/xattn/0/to_q/w"] is not None
        assert not any(t.requires_grad for t in tp["vit"]["blocks"][0]
                       ["qkv"].values())


def test_exit_only_backbone_gets_no_gradient(tiny_np):
    _, tcfg = configs()
    tp = to_torch(tiny_np, "cpu")
    batch = torch_batch(make_batch(tcfg, 1, 4))
    keys = ["decoder/xattn/0/to_q/w", "perceiver/latents",
            "extra_exit/rnn/layers/0/wi"]
    _, _, grads = tstep.loss_and_grads(tp, keys, batch, tcfg,
                                       phase="exit_only",
                                       gen=torch.Generator().manual_seed(0))
    assert grads[keys[0]] is None and grads[keys[1]] is None
    assert float(grads[keys[2]].abs().max()) > 0


# ---------------------------------------------------------------------------
# CALVIN batches: prepare_batch and the train step from them
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calvin_root(tmp_path_factory):
    """A CALVIN-format directory at CALVIN's frame sizes (200 px static,
    84 px gripper): training/ and validation/."""
    root = str(tmp_path_factory.mktemp("calvin"))
    make_synthetic_calvin(root, n_episodes=2, ep_len=10, img_hw=200,
                          grip_hw=84, compressed_episodes={1})
    make_synthetic_calvin(root, n_episodes=2, ep_len=10, img_hw=200,
                          grip_hw=84, split="validation", seed=1)
    return root


def calvin_batch(root, cfg, dif_ws):
    """The first batch of 2 trajectories of a CalvinLoader epoch; with
    ``dif_ws`` windows drawn in [2, window] and padded to the window."""
    kw = (dict(dif_ws=True, var_min_window=2,
               var_max_window=cfg.window_size) if dif_ws else {})
    ds = tcalvin.DiskCalvinDataset(tcalvin.CalvinDataConfig(
        dataset_dir=f"{root}/training", window_size=cfg.window_size,
        seed=1, **kw), validation=False)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size,
                        max_length=cfg.text_len)
    loader = tcalvin.CalvinLoader(ds, tok, 2, seed=2, workers=1)
    return next(iter(loader))


def prepared_pair(monkeypatch, raw, jcfg, tcfg, key):
    """(JAX's prepare_batch as numpy, the port's with JAX's shifts)."""
    jb = jtrainer.prepare_batch(raw, jcfg, key, jtrainer.TrainConfig())
    n = raw["rgb_static"].shape[0] * raw["rgb_static"].shape[1]
    k1, k2 = jax.random.split(key)
    shifts = [torch.as_tensor(np.array(jax.random.randint(
        k, (n, 2), 1, 2 * pad + 1))) for k, pad in ((k1, 10), (k2, 4))]
    monkeypatch.setattr(tshift, "draw_shifts",
                        lambda gen, n, low, pad: shifts.pop(0))
    tb = prepare_batch(raw, tcfg, None, TrainConfig(), "cpu")
    assert not shifts  # both cameras took JAX's draws
    return {k: np.asarray(v) for k, v in jb.items()}, tb


@pytest.mark.parametrize("dif_ws", [False, True])
def test_prepare_batch_on_calvin_frames_matches_jax(monkeypatch,
                                                    calvin_root, dif_ws):
    jcfg, tcfg = configs()
    raw = calvin_batch(calvin_root, tcfg, dif_ws)
    assert raw["rgb_static"].shape[1:] == (tcfg.window_size, 200, 200, 3)
    assert raw["rgb_gripper"].shape[2:] == (84, 84, 3)
    jb, tb = prepared_pair(monkeypatch, raw, jcfg, tcfg,
                           jax.random.PRNGKey(3))
    for k in ("image", "gripper"):
        assert tb[k].shape == jb[k].shape == (
            2 * tcfg.window_size, 1, 1, 3, 28, 28)
        np.testing.assert_allclose(tb[k].numpy(), jb[k], rtol=0,
                                   atol=FRAME_ATOL, err_msg=k)
    for k in ("input_ids", "attention_mask", "labels"):
        np.testing.assert_array_equal(tb[k].numpy(), jb[k], err_msg=k)


@pytest.mark.parametrize("phase,dif_ws", [("joint", False),
                                          ("exit_only", False),
                                          ("joint", True),
                                          ("exit_only", True)])
def test_train_step_on_calvin_batch_matches_jax(monkeypatch, tiny_np,
                                                calvin_root, phase, dif_ws):
    """One step from a prepared CALVIN batch (dropout on, JAX's draws)."""
    jcfg, tcfg = configs(dropout=0.3, lstm_dropout=0.2)
    raw = calvin_batch(calvin_root, tcfg, dif_ws)
    jb, tb = prepared_pair(monkeypatch, raw, jcfg, tcfg,
                           jax.random.PRNGKey(4))
    jp = jax.tree.map(jnp.asarray, tiny_np)
    tp = to_torch(tiny_np, "cpu")
    kw = dict(phase=phase, learning_rate=1e-3, warmup_steps=0,
              total_steps=2, weight_decay=0.1)
    jmask = jflamingo.trainable_mask(jp, jcfg, phase)
    jopt = optax.chain(capture_grads(), joptim.make_optimizer(
        jp, jcfg, trainable=jmask, **kw))
    topt = toptim.make_optimizer(
        tp, tcfg, trainable=tflamingo.trainable_mask(tp, tcfg, phase), **kw)
    js = jstep.init_train_state(jp, jopt)
    rng = jax.random.PRNGKey(5)
    draws = jax_draws(jcfg, jp, jb, rng, 1)
    _, _, grads = tstep.loss_and_grads(tp, topt.trainable_keys(), tb, tcfg,
                                       phase=phase, draws=port_draws(draws))
    js, jm = jstep.make_train_step(jcfg, jopt, phase=phase, bin_coef=0.01,
                                   donate=False, trainable=jmask)(
        js, {k: jnp.asarray(v) for k, v in jb.items()}, rng)
    _, tm = tstep.make_train_step(tcfg, topt, phase=phase, bin_coef=0.01)(
        tstep.init_train_state(tp, topt), tb, draws=port_draws(draws))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        STEP_LOSS_REL * abs(float(jm["loss"]))
    jg = jax_flat(js.opt_state[0])
    for k in topt.trainable_keys():
        assert rel_l2(grads[k], jg[k]) <= GRAD_REL_L2, k


# ---------------------------------------------------------------------------
# --remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_match_no_remat_and_jax(monkeypatch, tiny_np,
                                                policy):
    """Every decoder layer recomputed in the backward (counted): the
    gradients equal no remat's within 1e-6 and JAX's remat step's within
    1e-4."""
    jcfg, tcfg = configs(remat_layers=True, remat_policy=policy)
    _, plain = configs()
    jp = jax.tree.map(jnp.asarray, tiny_np)
    tp = to_torch(tiny_np, "cpu")
    batch = make_batch(jcfg, 2, seed=31)
    rng = jax.random.PRNGKey(32)
    draws = jax_draws(jcfg, jp, batch, rng, 1)
    keys = toptim.make_optimizer(
        tp, tcfg, phase="joint", learning_rate=1e-3, warmup_steps=0,
        total_steps=1, trainable=tflamingo.trainable_mask(
            tp, tcfg, "joint")).trainable_keys()
    calls = []
    real = tmpt.ckpt.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(tmpt.ckpt, "checkpoint", counted)
    tb = torch_batch(batch)
    loss_r, _, g_remat = tstep.loss_and_grads(tp, keys, tb, tcfg,
                                              draws=port_draws(draws))
    assert len(calls) == tcfg.n_layers
    assert all(not c["use_reentrant"] for c in calls)
    assert all(("context_fn" in c) == (policy == "dots") for c in calls)
    loss_p, _, g_plain = tstep.loss_and_grads(tp, keys, tb, plain,
                                              draws=port_draws(draws))
    assert len(calls) == tcfg.n_layers
    assert float(loss_r) == pytest.approx(float(loss_p), rel=REMAT_REL_L2)
    for k in keys:
        assert rel_l2(g_remat[k], g_plain[k]) <= REMAT_REL_L2, k
    jmask = jflamingo.trainable_mask(jp, jcfg, "joint")
    jopt = optax.chain(capture_grads(), joptim.make_optimizer(
        jp, jcfg, phase="joint", learning_rate=1e-3, warmup_steps=0,
        total_steps=1, trainable=jmask))
    js, _ = jstep.make_train_step(jcfg, jopt, bin_coef=0.01, donate=False,
                                  trainable=jmask)(
        jstep.init_train_state(jp, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    jg = jax_flat(js.opt_state[0])
    for k in keys:
        assert rel_l2(g_remat[k], jg[k]) <= GRAD_REL_L2, k


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_keeps_the_kernel_guard_for_unfreeze_vit(monkeypatch, policy):
    """K1 stands outside every checkpointed region: with the kernel forced
    on the ViT's queries (as on the card, where they reach it) and its
    guard on, a remat step with a frozen ViT trains, and one with
    ``unfreeze_vit`` raises the guard's error."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_reference
    seen = []

    def kernel(q, k, v, bias=None, scale=None):
        check_no_grad("flash_attention", q, k, v, bias)
        seen.append(q.shape[2])
        return flash_attention_reference(q, k, v, bias, scale)

    monkeypatch.setattr(tattn, "flash_attention", kernel)
    base = tconfig.deer_tiny()
    # 56 px: 17 ViT tokens, the only queries of at least KERNEL_MIN_SQ
    monkeypatch.setattr(tattn, "KERNEL_MIN_SQ", 17)
    for unfreeze in (False, True):
        cfg = dataclasses.replace(
            base, vit=dataclasses.replace(base.vit, image_size=56),
            remat_layers=True, remat_policy=policy, unfreeze_vit=unfreeze)
        params = tflamingo.init_deer(cfg, seed=0, device="cpu")
        batch = torch_batch(make_batch(cfg, 1, seed=33))
        keys = toptim.make_optimizer(
            params, cfg, phase="joint", learning_rate=1e-3, warmup_steps=0,
            total_steps=1, trainable=tflamingo.trainable_mask(
                params, cfg, "joint")).trainable_keys()
        assert any(k.startswith("vit/") for k in keys) == unfreeze
        gen = torch.Generator().manual_seed(0)
        if unfreeze:
            with pytest.raises(RuntimeError, match="flash_attention: an "
                                                   "input requires grad"):
                tstep.loss_and_grads(params, keys, batch, cfg, gen=gen)
        else:
            loss, _, grads = tstep.loss_and_grads(params, keys, batch, cfg,
                                                  gen=gen)
            assert np.isfinite(float(loss))
            assert grads["decoder/xattn/0/to_q/w"] is not None
    assert seen and set(seen) == {17}


# ---------------------------------------------------------------------------
# the trainer (mirrors tests/test_train.py)
# ---------------------------------------------------------------------------


def trainer_setup(run_dir, batches=3, **kw):
    cfg = tconfig.deer_tiny()
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id,
                              eoc_token_id=tok.eoc_token_id)
    loader = DebugBatcher(cfg, tok, batch_size=2, num_batches=batches,
                          img_hw=cfg.vit.image_size,
                          grip_hw=cfg.vit.image_size)
    base = dict(run_dir=str(run_dir), num_joint_epochs=1, num_exit_epochs=1,
                joint_lr=1e-3, exit_lr=1e-3, joint_warmup_steps=0,
                exit_warmup_steps=0, rgb_pad=2, gripper_pad=2,
                logging_steps=1, batch_size=2)
    base.update(kw)
    return cfg, TrainConfig(**base), loader


def test_two_phases_freeze_and_checkpoint(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path)
    logs = []
    tr = Trainer(cfg, tcfg, loader, log_fn=logs.append, device="cpu")
    p0 = {k: v.clone() for k, v in torch_flat(tr.params).items()}
    metrics = tr.train()
    assert np.isfinite(metrics["loss"])
    assert {l["phase"] for l in logs} == {"joint", "exit_only"}
    p1 = torch_flat(tr.params)
    joint = torch_flat(tflamingo.trainable_mask(tr.params, cfg, "joint"))
    for k, v in p1.items():
        if not joint[k]:
            assert torch.equal(v, p0[k]), k  # frozen: untouched
    for k in ("extra_exit/rnn/layers/0/wi", "decoder/xattn/0/to_q/w",
              "decoder/wte/w"):
        assert not torch.equal(p1[k], p0[k]), k
    # the exit-only phase moved the heads only: deer_0 holds the joint end
    joint_end, _, side = load_checkpoint(str(tmp_path / "deer_0.ckpt"),
                                         tr.params)
    for k, v in torch_flat(joint_end).items():
        head = k.split("/")[0] in ("lm_head", "extra_exit", "lm_exits")
        assert torch.equal(v, p1[k]) != head, k
    assert side["meta"]["init"] == {"package": "deer_vla_tpu_torch",
                                    "seed": 42, "generator_device": "cpu",
                                    "backbone": backbone_record(cfg)}
    # resume: both epochs done
    tr2 = Trainer(cfg, tcfg, loader, device="cpu")
    assert tr2.maybe_resume() == 2
    assert torch.equal(torch_flat(tr2.params)["lm_head/rnn/layers/0/wi"],
                       p1["lm_head/rnn/layers/0/wi"])
    # the seed contract: the frozen backbone is init_deer(seed) on the device
    ref = tflamingo.init_deer(cfg, seed=tcfg.seed, device="cpu")
    assert torch.equal(tr2.params["vit"]["blocks"][0]["qkv"]["w"],
                       ref["vit"]["blocks"][0]["qkv"]["w"])


def test_resume_restores_optimizer_state(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, num_joint_epochs=2,
                                      num_exit_epochs=0)
    tr = Trainer(cfg, tcfg, loader, device="cpu")
    tr.train(num_epochs=1)  # 3 steps, deer_0 with the optimizer state
    tr2 = Trainer(cfg, tcfg, loader, device="cpu")
    assert tr2.maybe_resume() == 1
    tr2.train(num_epochs=2)
    assert tr2.state.opt_state["count"] == 6  # 3 restored + 3 new


@pytest.mark.parametrize("change", ["seed", "generator_device",
                                    "given_params"])
def test_resume_refuses_another_backbone(tmp_path, change):
    """A delta checkpoint overlays the backbone it was trained over: resuming
    with another seed, after a run whose backbone was drawn on another
    device, or over weights the caller gave, raises."""
    cfg, tcfg, loader = trainer_setup(tmp_path, batches=1,
                                      num_joint_epochs=2, num_exit_epochs=0)
    Trainer(cfg, tcfg, loader, device="cpu").train(num_epochs=1)
    params = None
    if change == "seed":
        tcfg = dataclasses.replace(tcfg, seed=tcfg.seed + 1)
    elif change == "generator_device":
        side = tmp_path / "deer_0.json"
        rec = json.loads(side.read_text())
        rec["meta"]["init"]["generator_device"] = "cuda"
        side.write_text(json.dumps(rec))
    else:
        params = tflamingo.init_deer(cfg, seed=tcfg.seed, device="cpu")
    tr = Trainer(cfg, tcfg, loader, params=params, device="cpu")
    with pytest.raises(ValueError, match="trained over the backbone"):
        tr.maybe_resume()


def test_mid_epoch_checkpoints_and_resume(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, num_exit_epochs=0,
                                      save_every_epoch=False,
                                      save_every_iter=2, logging_steps=100)
    Trainer(cfg, tcfg, loader, device="cpu").train()
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.endswith(".ckpt")) == ["deer_0_it2.ckpt"]
    tr = Trainer(cfg, dataclasses.replace(tcfg, num_joint_epochs=2), loader,
                 device="cpu")
    assert tr.maybe_resume() == 0  # re-run epoch 0, don't skip it
    tr.train()
    assert tr.state.opt_state["count"] == 2 + 2 * 3


def test_save_freq_skips_epochs(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, batches=1,
                                      num_joint_epochs=4, num_exit_epochs=0,
                                      save_freq=3, logging_steps=100)
    Trainer(cfg, tcfg, loader, device="cpu").train()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt")) \
        == ["deer_0.ckpt", "deer_3.ckpt"]


def test_ema_checkpoints(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, num_exit_epochs=0,
                                      ema_decay=0.95)
    tr = Trainer(cfg, tcfg, loader, device="cpu")
    tr.train()
    template = tflamingo.init_deer(cfg, seed=tcfg.seed, device="cpu")
    reg, _, _ = load_checkpoint(str(tmp_path / "deer_0.ckpt"), template)
    ema, _, side = load_checkpoint(str(tmp_path / "deer_0_ema.ckpt"),
                                   template)
    k = "extra_exit/rnn/layers/0/wi"
    assert not torch.allclose(torch_flat(reg)[k], torch_flat(ema)[k])
    assert torch.isfinite(torch_flat(ema)[k]).all()
    assert side["meta"]["ema_decay"] == 0.95
    from deer_vla_tpu_torch.train.checkpoint import find_latest_checkpoint
    assert find_latest_checkpoint(str(tmp_path)).endswith("deer_0.ckpt")


def test_loss_multiplier_scales_gradient_and_logged_loss(tmp_path):
    def run(mult):
        cfg, tcfg, loader = trainer_setup(
            tmp_path / str(mult), batches=1, num_exit_epochs=0,
            save_every_epoch=False, seed=7, loss_multiplier_calvin=mult)
        tr = Trainer(cfg, tcfg, loader, device="cpu")
        return tr.train(), torch_flat(tr.params)
    m1, p1 = run(1.0)
    m2, p2 = run(2.0)
    np.testing.assert_allclose(2.0 * m1["loss"], m2["loss"], rtol=1e-5)
    k = "extra_exit/rnn/layers/0/wi"
    assert not torch.equal(p1[k], p2[k])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_then_eval_from_checkpoint(tmp_path, capsys):
    run = str(tmp_path / "run")
    tr = train_cli.main(["--debug", "--model", "tiny", "--num_joint_epochs",
                         "1", "--num_exit_epochs", "1", "--batch_size_calvin",
                         "2", "--run_name", run, "--joint_warmup_steps", "1",
                         "--exit_warmup_steps", "1", "--precision", "fp32"],
                        device="cpu")
    assert sorted(f for f in os.listdir(run) if f.endswith(".ckpt")) == \
        ["deer_0.ckpt", "deer_1.ckpt"]
    side = json.load(open(os.path.join(run, "deer_1.json")))
    assert side["config"]["media_token_id"] == tr.cfg.media_token_id
    capsys.readouterr()
    report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                            os.path.join(run, "deer_1.ckpt"),
                            "--calib_batches", "1", "--precision", "fp32",
                            "--num_sequences_override", "2",
                            "--exit_ratio", "0.5"], device="cpu")
    out = capsys.readouterr().out
    n = len(tree_leaves_with_path(tflamingo.checkpoint_mask(tr.params,
                                                            tr.cfg)))
    n_true = sum(bool(m) for _, m in tree_leaves_with_path(
        tflamingo.checkpoint_mask(tr.params, tr.cfg)))
    assert n > n_true > 0
    assert f"loaded {n_true} param groups from ckpt" in out
    assert report["avg_seq_len"] >= 0


@pytest.mark.parametrize("flag,error,match", [
    (["--tokenizer_path", "x"], SystemExit, "ROADMAP.md M9"),
    (["--cotrain"], SystemExit, "--cotrain needs --coco_ann"),
    (["--cotrain", "--vl_weight", "0.5"], SystemExit, "--cotrain needs"),
    (["--cotrain", "--coco_image_dir", "d"], SystemExit, "--cotrain needs"),
    (["--cotrain", "--vqa_image_dir", "d", "--vqa_ann", "a.json"],
     SystemExit, "--cotrain needs"),
    (["--cotrain", "--cotrain_laion_shards", "/nonexistent/s-*.tar"],
     SystemExit, "matched no files"),
    (["--cotrain", "--coco_ann", "/nonexistent/ann.json"],
     FileNotFoundError, "ann.json"),
    (["--cotrain", "--vqa_questions", "/nonexistent/q.json"],
     FileNotFoundError, "q.json"),
    (["--tcp_rel", "--cotrain"], SystemExit, "--cotrain needs"),
    (["--batch_size_calvin", "3", "--gradient_accumulation_steps", "2"],
     SystemExit, "not divisible by --gradient_accumulation_steps 2"),
    (["--cotrain", "--cotrain_laion_shards", "s", "--vl_batch_size", "3",
      "--gradient_accumulation_steps", "2", "--batch_size_calvin", "2"],
     SystemExit, "the VL batch 3 is not divisible"),
    (["--process_id", "1"], SystemExit, "need --coordinator"),
    (["--num_processes", "2"], SystemExit, "need --coordinator"),
    (["--coordinator", "h:1", "--num_processes", "2", "--process_id", "2"],
     SystemExit, "--process_id 2 is not a rank of --num_processes 2"),
    (["--coordinator", "h:1", "--num_processes", "0"], SystemExit,
     "not a rank of --num_processes 0")])
def test_train_cli_unserved_flags_raise(flag, error, match):
    """The CLI's refusals: --tokenizer_path (unserved, M9); --cotrain
    without a VL source or with one that is not there (JAX
    cli/train.py:358-375); a batch the microbatch split does not divide;
    process flags without --coordinator or naming no rank of the
    group."""
    with pytest.raises(error, match=match):
        train_cli.main(["--debug", "--model", "tiny"] + flag, device="cpu")


def test_train_cli_without_debug_raises():
    """Without --debug the CLI trains on --calvin_dataset; with neither it
    refuses."""
    with pytest.raises(SystemExit, match="--calvin_dataset"):
        train_cli.main(["--model", "tiny"], device="cpu")


@pytest.mark.parametrize("variant", ["window", "dif_ws_remat"])
def test_train_cli_on_calvin_then_eval_from_checkpoint(tmp_path, capsys,
                                                       calvin_root, variant):
    """cli/train without --debug on a CALVIN-format directory: the loader
    gives every epoch (set_epoch) its len(loader) steps; cli/eval serves
    the checkpoint."""
    run = str(tmp_path / "run")
    argv = ["--model", "tiny", "--calvin_dataset", calvin_root,
            "--num_joint_epochs", "1", "--num_exit_epochs", "1",
            "--batch_size_calvin", "2", "--run_name", run,
            "--joint_warmup_steps", "1", "--exit_warmup_steps", "1",
            "--precision", "fp32", "--workers", "2", "--window_size", "4"]
    # 2 batches an epoch: 4 of the 12 windows, or of dif_ws' 16
    if variant == "dif_ws_remat":
        argv += ["--dif_ws", "--min_window_size", "2", "--max_window_size",
                 "4", "--remat", "--remat_policy", "dots", "--text_aug",
                 "--data_percent", "0.25"]
    else:
        argv += ["--data_percent", "0.34"]
    tr = train_cli.main(argv, device="cpu")
    loader = tr.loader
    assert isinstance(loader, tcalvin.CalvinLoader)
    assert loader.epoch == 1
    assert tr.state.opt_state["count"] == len(loader) == 2
    ds = loader.ds
    assert ds.cfg.dataset_dir == f"{calvin_root}/training"
    assert ds.cfg.dif_ws == (variant == "dif_ws_remat")
    assert tr.cfg.remat_layers == (variant == "dif_ws_remat")
    assert sorted(f for f in os.listdir(run) if f.endswith(".ckpt")) == \
        ["deer_0.ckpt", "deer_1.ckpt"]
    capsys.readouterr()
    report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                            os.path.join(run, "deer_1.ckpt"),
                            "--calib_batches", "1", "--precision", "fp32",
                            "--num_sequences_override", "2"], device="cpu")
    assert "param groups from ckpt" in capsys.readouterr().out
    assert report["avg_seq_len"] >= 0


def test_train_cli_on_calvin_with_state(tmp_path, calvin_root):
    """cli/train --use_state on the synthetic CALVIN tree: every gripper
    state is CALVIN's -1 or 1, so the host check passes each batch and the
    state rows reach the trained head."""
    from deer_vla_tpu_torch.data.preprocess import check_gripper_state
    tr = train_cli.main(["--model", "tiny", "--calvin_dataset", calvin_root,
                         "--use_state", "--num_joint_epochs", "1",
                         "--num_exit_epochs", "0", "--batch_size_calvin",
                         "2", "--run_name", str(tmp_path / "run"),
                         "--joint_warmup_steps", "1", "--precision", "fp32",
                         "--workers", "1", "--window_size", "4",
                         "--data_percent", "0.34"], device="cpu")
    assert tr.cfg.use_state and tr.cfg.head.use_state
    assert tr.state.opt_state["count"] == len(tr.loader) > 0
    for i in range(len(tr.loader.ds)):
        grip = tr.loader.ds[i]["robot_obs"][:, -1]
        assert set(np.unique(grip)) <= {-1.0, 1.0}
        check_gripper_state(tr.loader.ds[i]["robot_obs"], tr.cfg)


def test_train_cli_refuses_dif_ws_off_the_max_window(calvin_root, tmp_path):
    with pytest.raises(SystemExit, match="--max_window_size"):
        train_cli.main(["--model", "tiny", "--calvin_dataset", calvin_root,
                        "--dif_ws", "--window_size", "4",
                        "--max_window_size", "6", "--run_name",
                        str(tmp_path)], device="cpu")
