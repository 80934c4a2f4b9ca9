"""Shared helpers of the PyTorch port's training tests
(tests/test_torch_train_*.py): the deer_tiny configurations of both
packages, the bridged weights with the x-attn gates opened, the batches
and the random draws JAX takes and hands the port, the CALVIN-format
directory, and the tolerances (their reasons are in
tests/test_torch_train_steps.py's docstring).
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
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data import calvin as tcalvin
from deer_vla_tpu_torch.data.debug_data import (DebugBatcher,
                                                make_synthetic_calvin)
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.ops.layers import flat_key, tree_leaves_with_path
from deer_vla_tpu_torch.train.trainer import TrainConfig

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
