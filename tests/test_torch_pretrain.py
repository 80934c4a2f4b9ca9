"""PyTorch port, VL pretraining and co-training (``train/pretrain.py``,
``train/train_step.make_cotrain_step``; ROADMAP M16b) against the JAX
package on the CPU, on the same
bridged deer_tiny weights (x-attn gates opened, so the images reach the
loss) and inputs.

The weights are the port's deer_tiny draw, handed to JAX.  The CLIs are
held to JAX's in tests/test_torch_pretrain_cli.py.

Tolerances (fp32, other summation orders): losses and accuracies within
1e-5 relative, ``grad_norm`` within 1e-4 relative and every gradient leaf
the optimizer takes within 1e-4 relative L2 (as
tests/test_torch_train_steps.py; the grouped AdamW itself is held to optax
there).  The updated weights are
not compared: the LM loss gives some embedding entries gradients near
Adam's epsilon (1e-8), where the first update amplifies fp32 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import pretrain as jpretrain
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.ops.layers import tree_map
from deer_vla_tpu_torch.train import optimizer as toptim
from deer_vla_tpu_torch.train import pretrain as tpretrain
from deer_vla_tpu_torch.train import train_step as tstep

from torch_train_common import (capture_grads, jax_draws, jax_flat,
                                open_gates, port_draws, rel_l2, torch_batch,
                                torch_flat)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_REL = 1e-5
GRAD_NORM_REL = 1e-4
GRAD_REL_L2 = 1e-4
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=4,
           weight_decay=0.1)


def configs():
    tok = HashTokenizer(vocab_size=128, max_length=16)
    return tuple(dataclasses.replace(m.deer_tiny(),
                                     media_token_id=tok.media_token_id,
                                     eoc_token_id=tok.eoc_token_id)
                 for m in (jconfig, tconfig)) + (tok,)


def tiny_params():
    """The port's deer_tiny draw as numpy (its vocab is the CLIs'
    tokenizer's), gates open."""
    return open_gates(tree_map(lambda t: t.numpy(), tflamingo.init_deer(
        tconfig.deer_tiny(), seed=0, device="cpu")))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, tok = configs()
    return jcfg, tcfg, tok, tiny_params()


def vl_batch(cfg, b, t, seed, answer=False):
    """b rows of t images and interleaved text: media tokens, padding at
    the end of every other row."""
    r = np.random.RandomState(seed)
    hw, s = cfg.vit.image_size, cfg.text_len
    ids = r.randint(1, cfg.media_token_id - 2, (b, s)).astype(np.int32)
    for k in range(t):
        ids[:, k * (s // t)] = cfg.media_token_id
    mask = np.ones((b, s), np.int32)
    mask[::2, -3:] = 0
    out = {"image": r.randn(b, t, 1, 3, hw, hw).astype(np.float32),
           "input_ids": ids, "attention_mask": mask}
    if answer:
        am = np.zeros((b, s), np.int32)
        am[:, s // 2:] = 1
        out["answer_mask"] = am
    return out


def assert_rel(got, want, tol):
    assert abs(float(got) - float(want)) <= tol * max(abs(float(want)),
                                                      1e-30), (got, want)


def recording(opt):
    """``opt`` whose updates keep the gradients they were given."""
    seen = []
    update = opt.update

    def record(params, grads, state):
        seen.append({k: g.clone() for k, g in grads.items()})
        return update(params, grads, state)

    opt.update = record
    return seen


def assert_grads(got: dict, want: dict):
    assert got.keys() <= want.keys()
    for k, g in got.items():
        assert rel_l2(g.numpy(), want[k]) <= GRAD_REL_L2, k


@pytest.mark.parametrize("t,answer", [(3, True)])
def test_pretrain_step_matches_jax(tiny, t, answer):
    """Two steps on three images a row with an answer mask: the LM loss,
    accuracy and token count (``lm_loss``), grad_norm over the trainable
    leaves' gradients (JAX's counts the frozen decoder's too: its norm is
    taken here over JAX's gradients of the same leaves) and every gradient
    the optimizer takes; the frozen leaves bit-unchanged, the trainable
    ones moved."""
    jcfg, tcfg, _, params = tiny
    jp = jax.tree.map(jnp.asarray, params)
    mask = jflamingo.trainable_mask(jp, jcfg, "joint")
    jopt = optax.chain(capture_grads(), joptim.make_optimizer(
        jp, jcfg, phase="joint", trainable=mask, **OPT))
    jfn = jpretrain.make_pretrain_step(jcfg, jopt, donate=False)
    tp = to_torch(params, "cpu")
    topt = toptim.make_optimizer(
        tp, tcfg, phase="joint",
        trainable=tflamingo.trainable_mask(tp, tcfg, "joint"), **OPT)
    seen = recording(topt)
    tfn = tpretrain.make_pretrain_step(tcfg, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    trained = torch_flat(tflamingo.trainable_mask(tp, tcfg, "joint"))
    for it in range(2):
        b = vl_batch(jcfg, 2, t, seed=10 + it, answer=answer)
        init = {k: v.clone() for k, v in torch_flat(tp).items()}
        jp, js, jm = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tfn(tp, ts, torch_batch(b))
        for k in ("lm_loss", "lm_acc", "tokens"):
            assert_rel(tm[k], jm[k], LOSS_REL)
        assert int(tm["tokens"]) > 0
        jg = jax_flat(js[0])
        want = np.sqrt(sum(float(np.sum(np.square(jg[k], dtype=np.float64)))
                           for k in trained if trained[k]))
        assert_rel(tm["grad_norm"], want, GRAD_NORM_REL)
        assert set(seen[-1]) == set(topt.trainable_keys())
        assert_grads(seen[-1], jg)
        for k, v in torch_flat(tp).items():
            assert torch.equal(v, init[k]) != (trained[k] and k in seen[-1]
                                               and bool(seen[-1][k].any())), k
        # the next step from JAX's weights, so both differentiate alike
        tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")


def cotrain_batch(cfg, b, seed):
    r = np.random.RandomState(seed)
    w, s, hw = cfg.window_size, cfg.text_len, cfg.vit.image_size
    ids = r.randint(1, cfg.media_token_id - 2, (b * w, s)).astype(np.int32)
    ids[:, 0] = cfg.media_token_id
    return {"image": r.randn(b * w, 1, 1, 3, hw, hw).astype(np.float32),
            "gripper": r.randn(b * w, 1, 1, 3, hw, hw).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones_like(ids),
            "labels": np.clip(r.randn(b, w, 7), -1, 1).astype(np.float32)}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_cotrain_step_matches_jax(tiny, grad_accum):
    """make_cotrain_step (vl_weight 0.5, calvin_multiplier 2): the combined
    loss, the LM metrics, grad_norm and every gradient, with JAX's layer
    draws."""
    jcfg, tcfg, _, params = tiny
    jp = jax.tree.map(jnp.asarray, params)
    mask = jflamingo.trainable_mask(jp, jcfg, "joint")
    jopt = optax.chain(capture_grads(), joptim.make_optimizer(
        jp, jcfg, phase="joint", trainable=mask, **OPT))
    kw = dict(phase="joint", vl_weight=0.5, calvin_multiplier=2.0,
              grad_accum=grad_accum)
    jfn = jstep.make_cotrain_step(jcfg, jopt, donate=False, trainable=mask,
                                  **kw)
    tp = to_torch(params, "cpu")
    topt = toptim.make_optimizer(
        tp, tcfg, phase="joint",
        trainable=tflamingo.trainable_mask(tp, tcfg, "joint"), **OPT)
    tfn = tstep.make_cotrain_step(tcfg, topt, **kw)
    batch = cotrain_batch(jcfg, 2, seed=3)
    vb = vl_batch(jcfg, 2, 1, seed=4, answer=True)
    rng = jax.random.PRNGKey(5)
    draws = jax_draws(jcfg, jp, batch, rng, grad_accum)
    seen = recording(topt)
    js, jm = jfn(jstep.init_train_state(jp, jopt),
                 {k: jnp.asarray(v) for k, v in batch.items()},
                 {k: jnp.asarray(v) for k, v in vb.items()}, rng)
    ts, tm = tfn(tstep.init_train_state(tp, topt), torch_batch(batch),
                 torch_batch(vb), draws=port_draws(draws))
    for k in ("loss", "lm_loss", "lm_acc", "mse", "bce", "tokens"):
        assert_rel(tm[k], jm[k], LOSS_REL)
    assert_rel(tm["grad_norm"], jm["grad_norm"], GRAD_NORM_REL)
    assert_grads(seen[0], jax_flat(js.opt_state[0]))
    assert set(seen[0]) == set(topt.trainable_keys())
    if grad_accum == 2:  # the split must divide the VL batch too
        with pytest.raises(ValueError, match="vl batch 3"):
            tfn(ts, torch_batch(batch), torch_batch(vl_batch(jcfg, 3, 1, 4)),
                draws=port_draws(draws))
