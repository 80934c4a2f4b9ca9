"""PyTorch port, training from CALVIN batches and with ``--remat``,
against the JAX package on the CPU.

CALVIN-format batches (200 px static, 84 px gripper frames of a synthetic
directory, also at ``dif_ws`` windows) go through both ``prepare_batch``es
with JAX's random shifts: frames within 2e-5 absolute (the cubic resize's
fp32 sums), and the train step on them is held to JAX's as in
tests/test_torch_train_steps.py; ``--remat`` ('full' and 'dots')
gradients within 1e-6 relative L2 of no remat and 1e-4 of JAX's remat
step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deer_vla_tpu.train import trainer as jtrainer
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu.train import train_step as jstep
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.ops import attention as tattn
from deer_vla_tpu_torch.ops import rand_shift as tshift
from deer_vla_tpu_torch.ops.kernels.guard import check_no_grad
from deer_vla_tpu_torch.train import optimizer as toptim
from deer_vla_tpu_torch.train import train_step as tstep
from deer_vla_tpu_torch.train.trainer import TrainConfig, prepare_batch

from torch_train_common import (FRAME_ATOL, GRAD_REL_L2, REMAT_REL_L2,
                                STEP_LOSS_REL, calvin_batch, calvin_root,
                                capture_grads, configs, jax_draws, jax_flat,
                                make_batch, port_draws, rel_l2, tiny_np,
                                torch_batch)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# CALVIN batches: prepare_batch and the train step from them
# ---------------------------------------------------------------------------


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
