"""PyTorch port, the training path's parts and its train step against the
JAX package on the CPU: the multi-exit loss, the freeze masks, the grouped
AdamW against optax, head dropout, and the train step in both phases and
with gradient accumulation.

Weights are deer_tiny in fp32, bridged from the JAX init (x-attn gates
opened so the vision path reaches the loss); inputs are numpy draws from a
seed.  The random draws the packages cannot share are taken from the JAX
side and handed to the port: the layer draws of forward_train and every
dropout keep mask, recorded in call order while JAX traces its forward.

Tolerances (fp32, both sides sum the same products in other orders):
loss and head outputs within 1e-6 absolute on values of unit scale; the
optimizer's params within 1e-6 absolute after three updates at lr 1e-2;
a train step's loss within 1e-5 relative, every gradient leaf within 1e-4
relative L2, and every param leaf after the update within 1e-5 of its norm
plus 1e-4 of the update's norm: Adam divides a gradient by its own size,
so the update carries the gradient's relative error (a zero-initialized
bias is all update after one step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.train import losses as jlosses
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.models import action_head as thead
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.kernels.guard import check_no_grad
from deer_vla_tpu_torch.ops.layers import keystr, tree_leaves_with_path
from deer_vla_tpu_torch.train import losses as tlosses
from deer_vla_tpu_torch.train import optimizer as toptim
from deer_vla_tpu_torch.train import train_step as tstep

from torch_train_common import (GRAD_REL_L2, LOSS_ATOL, OPT_ATOL,
                                PARAM_REL_L2, STEP_LOSS_REL, UPDATE_REL_L2,
                                capture_grads, configs, jax_draws, jax_flat,
                                make_batch, port_draws, recorded, rel_l2,
                                tiny_np, torch_batch, torch_flat)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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
