"""PyTorch port, the vision variants against the JAX package on the CPU:
the camera fusions 'post', 'pre', 'two_way' and 'vit_concat', each with a
second resampler (``sep_resampler``), per-frame embeddings (``use_hist``),
a proprio token (``use_state``) and a gripper camera at its native size
(``gripper_res``), and the training forward and its gradients.

The weights are one JAX init of deer_tiny with every variant leaf
(``perceiver_gripper``, ``state_fc``, ``frame_embs``, the heads'
``embed_*``), bridged; a variant takes the leaves its tree has.  The
cross-attention gates are opened so that vision reaches the actions.
Inputs are numpy draws from a seed, fp32.

Tolerances: the position-table resize within 1e-6, the vision path within
2e-5 (max abs), the training forward's loss within 1e-5 relative and the
gradient within 1e-4 relative L2 (tests/test_torch_train_steps.py's), both the
whole trainable gradient and each leaf.  A leaf's error is taken relative
to its own norm or to a thousandth of the largest leaf's norm, whichever is
larger: a gate's gradient can be a sum that cancels to 3e-7 from terms a
thousand times larger, and keeps their fp32 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import vit as jvit
from deer_vla_tpu.train import losses as jloss
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import vit as tvit
from deer_vla_tpu_torch.ops.layers import flat_key, tree_leaves_with_path
from deer_vla_tpu_torch.train import train_step as tstep

VISION_ATOL = 2e-5
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
# a leaf's error relative to at least this share of the largest leaf norm
GRAD_FLOOR = 1e-3

# name -> DeerConfig changes; use_state sets the head's too (one flag in
# both CLIs), "k" is head.multi_step_action
VARIANTS = {
    "post": {},
    "post_state": {"use_state": True},
    "pre": {"fusion_mode": "pre"},
    "two_way": {"fusion_mode": "two_way"},
    "sep": {"sep_resampler": True},
    "gripper": {"gripper_res": 14},
    "hist": {"use_hist": True},
    "vit_concat": {"fusion_mode": "vit_concat"},
    "vit_concat_sep_state": {"fusion_mode": "vit_concat",
                             "sep_resampler": True, "use_state": True},
    "k3": {"k": 3},
}
# the superset the shared JAX init draws (every variant leaf)
SUPERSET = {"use_state": True, "sep_resampler": True, "use_hist": True}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(mod, changes=None, window=4, **more):
    """deer_tiny of ``mod`` (the JAX or the port's config module) at
    ``window`` with ``changes``."""
    changes = dict(changes or {}, **more)
    cfg = mod.deer_tiny(window_size=window)
    head = {}
    if changes.get("use_state"):
        head["use_state"] = True
    if "k" in changes:
        head["multi_step_action"] = changes.pop("k")
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, **head), **changes)


def pair(changes=None, window=4, **more):
    return (make_cfg(jconfig, changes, window, **more),
            make_cfg(tconfig, changes, window, **more))


def open_gates(params, seed=7):
    r = np.random.RandomState(seed)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return params


_FULL = {}


def full_params():
    """The JAX init of the superset config as numpy, drawn once a process
    (the other variant test files share it)."""
    if "p" not in _FULL:
        _FULL["p"] = open_gates(jax.tree.map(np.asarray, jflam.init_deer(
            jax.random.PRNGKey(0), make_cfg(jconfig, SUPERSET))))
    return _FULL["p"]


def variant_params(jcfg):
    """The superset's leaves that ``jcfg``'s tree has (the variant leaves
    drawn last, so the rest is the plain model's); a head of another width
    (multi_step_action) is drawn by the JAX head init."""
    full = full_params()
    p = {k: v for k, v in full.items()
         if k not in ("perceiver_gripper", "state_fc", "frame_embs")}
    for key, on in (("perceiver_gripper", jcfg.sep_resampler),
                    ("state_fc", jcfg.use_state),
                    ("frame_embs", jcfg.use_hist)):
        if on:
            p[key] = full[key]
    if jcfg.use_hist:
        p["frame_embs"] = full["frame_embs"][:jcfg.window_size]

    def head(h, i):
        if jcfg.head.multi_step_action != 1:
            return jax.tree.map(np.asarray, jhead.init_head(
                jax.random.PRNGKey(50 + i), jcfg.head))
        if jcfg.head.use_state:
            return h
        return {k: v for k, v in h.items() if not k.startswith("embed_")}

    p["lm_head"] = head(full["lm_head"], 0)
    p["extra_exit"] = head(full["extra_exit"], 1)
    p["lm_exits"] = {k: head(v, 2 + i)
                     for i, (k, v) in enumerate(full["lm_exits"].items())}
    return p


def frames(cfg, b, seed, state=True):
    """(image, gripper, state) numpy draws: b frame rows, the gripper at
    ``cfg.gripper_res`` when set, state rows (b, 1, 1, state_dim) whose
    last entry (the gripper) is +-1."""
    r = np.random.RandomState(seed)
    hw = cfg.vit.image_size
    ghw = cfg.gripper_res or hw
    img = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(b, 1, 1, 3, ghw, ghw).astype(np.float32)
    st = r.randn(b, 1, 1, cfg.state_dim).astype(np.float32)
    st[..., -1] = np.sign(st[..., -1]) + (st[..., -1] == 0)
    return img, grip, (st if state else None)


def text(cfg, b, seed, media_at=0):
    r = np.random.RandomState(seed)
    ids = r.randint(1, cfg.media_token_id, (b, cfg.text_len)).astype(np.int32)
    ids[:, media_at] = cfg.media_token_id
    mask = np.ones_like(ids)
    mask[::3, -2:] = 0
    return ids, mask


def jx(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def tt(*arrays):
    return tuple(None if a is None else torch.as_tensor(a) for a in arrays)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def shape_sig(tree):
    return sorted((flat_key(p), tuple(x.shape)) for p, x in
                  tree_leaves_with_path(tree))


# ---------------------------------------------------------------------------
# the ViT at another resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [6, 8, 20])
def test_resize_pos_embed_matches_jax(grid):
    """The 16 x 16 CLIP grid to ``grid``: JAX's linear resize antialiases
    when it shrinks, the port's bilinear interpolate with antialias."""
    pos = np.random.RandomState(grid).randn(257, 32).astype(np.float32)
    want = np.asarray(jvit.resize_pos_embed(jnp.asarray(pos), grid * grid))
    got = tvit.resize_pos_embed(torch.as_tensor(pos), grid * grid).numpy()
    assert got.shape == (grid * grid + 1, 32)
    np.testing.assert_array_equal(got[0], pos[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_flops_match_jax_for_each_variant(name):
    """The analytic FLOPs of deer_3b's variant: media tokens a fusion mode
    reads (the state token too), the gripper tower at its native size."""
    from deer_vla_tpu.eval import flops as jflops
    from deer_vla_tpu_torch.eval import flops as tflops
    changes = dict(VARIANTS[name])
    if "gripper_res" in changes:
        changes["gripper_res"] = 84
    jc, tc = (dataclasses.replace(mod.deer_3b(), **{
        k: v for k, v in changes.items() if k != "k"})
              for mod in (jconfig, tconfig))
    assert tc.num_media_tokens == jc.num_media_tokens
    assert tflops.llm_flops_per_exit(tc) == jflops.llm_flops_per_exit(jc)
    for fn in ("vision_flops", "head_flops", "train_step_flops"):
        assert getattr(tflops, fn)(tc) == getattr(jflops, fn)(jc)
    assert tflops.full_step_flops(tc, 11) == jflops.full_step_flops(jc, 11)


# ---------------------------------------------------------------------------
# the parameter trees and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_tree_matches_jax_and_crosses_the_bridge(name):
    """The port's init draws the JAX tree of the variant (every leaf, its
    shape); the JAX tree goes across the bridge leaf for leaf; the variant
    leaves leave the backbone of the plain model's seed unchanged."""
    jcfg, tcfg = pair(VARIANTS[name])
    want = jax.eval_shape(lambda: jflam.init_deer(jax.random.PRNGKey(0),
                                                  jcfg))
    got = tflam.init_deer(tcfg, seed=0, device="cpu")
    assert shape_sig(got) == shape_sig(want)
    p = variant_params(jcfg)
    bridged = dict(tree_leaves_with_path(to_torch(p, "cpu")))
    for path, leaf in tree_leaves_with_path(p):
        np.testing.assert_array_equal(bridged[path].numpy(), leaf)
    plain = tflam.init_deer(tconfig.deer_tiny(), seed=0, device="cpu")
    for key in ("vit", "perceiver", "decoder"):
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(got[key]),
                                    tree_leaves_with_path(plain[key])):
            assert pa == pb and torch.equal(a, b)


@pytest.mark.parametrize("phase", ["joint", "exit_only"])
@pytest.mark.parametrize("knobs", [{}, {"freeze_sampler": True},
                                   {"train_params": 140}])
def test_variant_masks_match_jax(phase, knobs):
    jcfg, tcfg = pair(SUPERSET, **knobs)
    p = variant_params(jcfg)
    want = dict(tree_leaves_with_path(jax.tree.map(
        bool, jflam.trainable_mask(jax.tree.map(jnp.asarray, p), jcfg,
                                   phase))))
    got = tree_leaves_with_path(tflam.trainable_mask(to_torch(p, "cpu"),
                                                     tcfg, phase))
    assert {path: bool(m) for path, m in got} == want
    assert any(path[0] in ("state_fc", "frame_embs", "perceiver_gripper")
               for path, m in got if m) == (phase == "joint")


# ---------------------------------------------------------------------------
# the vision path
# ---------------------------------------------------------------------------

OPTIONS = {"none": {}, "hist": {"use_hist": True},
           "state": {"use_state": True}, "sep": {"sep_resampler": True},
           "gripper": {"gripper_res": 14}}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("mode", ["post", "pre", "two_way", "vit_concat"])
def test_encode_vision_matches_jax(mode, option):
    """dual_camera_tokens, fuse_vision_tokens on the port's tokens, and
    encode_vision, on two trajectories of W frames (the training
    forward's rows)."""
    jcfg, tcfg = pair(OPTIONS[option], fusion_mode=mode)
    p = variant_params(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p, "cpu")
    w = jcfg.window_size
    img, grip, st = frames(jcfg, 2 * w, seed=3)
    tok_j = jflam.dual_camera_tokens(jp, *jx(img, grip), jcfg)
    tok_t = tflam.dual_camera_tokens(tp, *tt(img, grip), tcfg)
    assert (tok_t[1] is None) == (tok_j[1] is None) == (mode == "two_way")
    for a, b in zip(tok_t, tok_j):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=VISION_ATOL)
    want = jflam.encode_vision(jp, *jx(img, grip), jcfg, jnp.asarray(st),
                               window_size=w)
    got = tflam.encode_vision(tp, *tt(img, grip), tcfg, torch.as_tensor(st),
                              window_size=w)
    fused = tflam.fuse_vision_tokens(tp, *tok_t, tcfg, torch.as_tensor(st),
                                     window_size=w)
    n = jcfg.perceiver.num_latents
    rows, tokens = {"post": (2 * w, 2 * n), "pre": (2 * w, n),
                    "two_way": (2 * w, n),
                    "vit_concat": (2, 2 * n * w)}[mode]
    assert got.shape == (rows, 1, tokens + jcfg.use_state, jcfg.vis_dim)
    assert tokens + jcfg.use_state == jcfg.num_media_tokens
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=VISION_ATOL)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


def test_tome_runs_the_exact_tower_on_a_native_gripper():
    """ToMe merges the static camera only: the native-size gripper's tokens
    are the exact tower's (the JAX rule, flamingo.py:184-192; ToMe itself
    is held to JAX in tests/test_torch_tome.py)."""
    _, tcfg = pair(gripper_res=14)
    tcfg = dataclasses.replace(tcfg, vit=dataclasses.replace(tcfg.vit,
                                                             tome_r=1))
    tp = to_torch(variant_params(make_cfg(jconfig, gripper_res=14)), "cpu")
    img, grip, _ = frames(tcfg, 3, seed=4)
    tok_rgb, tok_grip = tflam.dual_camera_tokens(tp, *tt(img, grip), tcfg)
    _, merged = tvit.vit_forward_tome(tp["vit"], tt(img)[0].flatten(0, 2),
                                      tcfg.vit)
    _, exact = tvit.vit_forward(tp["vit"], tt(grip)[0].flatten(0, 2),
                                tcfg.vit)
    assert merged.shape[1] < tcfg.vit.num_patches and exact.shape[1] == 1
    assert torch.equal(tok_rgb.flatten(0, 2), merged)
    assert torch.equal(tok_grip.flatten(0, 2), exact)


# ---------------------------------------------------------------------------
# the training forward and its gradients
# ---------------------------------------------------------------------------

# one training config a fusion mode, each with the options its mode reads;
# a window of 2 frames keeps JAX's compile of the gradient short
TRAIN_WINDOW = 2
TRAIN_CASES = {
    "post_state_sep_gripper": {"use_state": True, "sep_resampler": True,
                               "gripper_res": 14},
    "pre_hist_k2": {"fusion_mode": "pre", "use_hist": True, "k": 2},
    "two_way_state": {"fusion_mode": "two_way", "use_state": True},
    "vit_concat_sep_state": VARIANTS["vit_concat_sep_state"],
}


def train_inputs(jcfg, seed):
    """A batch of 2 trajectories: frames and state per frame, text per
    frame (per window under 'vit_concat'), labels (B, W[, k], 7)."""
    w, b = jcfg.window_size, 2
    img, grip, st = frames(jcfg, b * w, seed)
    folded = jcfg.fusion_mode == "vit_concat"
    ids, mask = text(jcfg, b if folded else b * w, seed + 1)
    k = jcfg.head.multi_step_action
    r = np.random.RandomState(seed + 2)
    labels = np.clip(r.randn(b, w, *((k,) if k > 1 else ()), 7) * 0.5,
                     -1, 1).astype(np.float32)
    labels[..., 6] = np.sign(labels[..., 6])
    return {"image": img, "gripper": grip, "state": st, "input_ids": ids,
            "attention_mask": mask, "labels": labels}


def jax_loss_and_grads(jcfg, params, batch, rng):
    """The JAX training forward's loss, gradients and layer draws."""
    last = jcfg.use_hist or jcfg.fusion_mode == "vit_concat"

    def loss_fn(p, image, gripper, state, ids, mask, labels):
        out = jflam.forward_train(p, image, ids, mask, jcfg, rng,
                                  vision_gripper=gripper, state_tensor=state,
                                  train=True)
        loss, _ = jloss.multi_exit_loss(out, labels, 0.01,
                                        last_step_only=last)
        return loss, (out.rand_layer_ids, out.final_output.actions)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (lay1, final)), grads = fn(
        jax.tree.map(jnp.asarray, params),
        *jx(*(batch[k] for k in ("image", "gripper", "state", "input_ids",
                                 "attention_mask", "labels"))))
    return float(loss), grads, np.asarray(lay1), np.asarray(final)


def switch_ids(jcfg, rng, bs):
    """forward_train's sampling-2 layers, recomputed from its key."""
    w = 1 if jcfg.fusion_mode == "vit_concat" else jcfg.window_size
    rngs = jax.random.split(rng, 8)
    prev_len = jax.random.randint(rngs[4], (), 1, w + 1)
    idx2 = jax.random.randint(rngs[5], (bs, 2), 0, jcfg.num_exits)
    pick = jnp.where(jnp.arange(w)[None] < prev_len, idx2[:, :1], idx2[:, 1:])
    return np.asarray(jnp.asarray(jcfg.all_exit_ids())[pick])


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_forward_train_and_gradients_match_jax(case):
    """The joint phase's loss and the gradient of every trainable leaf
    (the state projection, the second resampler, the frame embeddings and
    the heads' state embeddings among them), given JAX's layer draws."""
    jcfg, tcfg = pair(TRAIN_CASES[case], window=TRAIN_WINDOW)
    params = variant_params(jcfg)
    batch = train_inputs(jcfg, seed=11)
    rng = jax.random.PRNGKey(5)
    loss_j, grads_j, lay1, final_j = jax_loss_and_grads(jcfg, params, batch,
                                                        rng)
    tp = to_torch(params, "cpu")
    mask = tflam.trainable_mask(tp, tcfg, "joint")
    keys = [flat_key(p) for p, m in tree_leaves_with_path(mask) if m]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    draws = [{"rand_layer_ids": torch.as_tensor(lay1),
              "switch_layer_ids": torch.as_tensor(switch_ids(jcfg, rng, 2))}]
    loss_t, _, grads_t = tstep.loss_and_grads(tp, keys, tb, tcfg,
                                              draws=draws)
    assert abs(float(loss_t) - loss_j) <= LOSS_REL * abs(loss_j)
    flat_j = {flat_key(p): np.asarray(g)
              for p, g in tree_leaves_with_path(jax.tree.map(np.asarray,
                                                             grads_j))}
    assert any(k.startswith(("state_fc", "perceiver_gripper", "frame_embs"))
               for k in keys)
    got = {k: (np.zeros_like(flat_j[k]) if grads_t[k] is None
               else grads_t[k].numpy()) for k in keys}
    assert rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                  np.concatenate([flat_j[k].ravel() for k in keys])) \
        <= GRAD_REL_L2
    floor = GRAD_FLOOR * max(np.linalg.norm(flat_j[k]) for k in keys)
    for k in keys:
        if grads_t[k] is None:
            assert not flat_j[k].any(), k
        err = np.linalg.norm(got[k].astype(np.float64) - flat_j[k])
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(flat_j[k]), floor), k
    out = tflam.forward_train(tp, tb["image"], tb["input_ids"],
                              tb["attention_mask"], tcfg,
                              vision_gripper=tb["gripper"],
                              state_tensor=tb["state"], train=False,
                              rand_layer_ids=draws[0]["rand_layer_ids"],
                              switch_layer_ids=draws[0]["switch_layer_ids"])
    w = 1 if jcfg.fusion_mode == "vit_concat" else jcfg.window_size
    k = jcfg.head.multi_step_action
    assert out.final_output.actions.shape == (2, w, 6 * k)
    np.testing.assert_allclose(out.final_output.actions.detach().numpy(),
                               final_j, rtol=0, atol=VISION_ATOL)
