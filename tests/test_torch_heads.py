"""PyTorch port, the fc and gpt action heads against the JAX package on the
CPU: the heads themselves (with JAX's dropout masks), the gpt head's
streamed history with per-stream counts, the routing and its refusals, the
scan engine and ``DeerPolicy`` at B=1 and B=4 with per-stream thresholds,
calibration, the train step, and the CLIs (their refusals, the M9b
labels, and cli/train then cli/eval on one checkpoint per family).

Weights: the shared JAX init of tests/test_torch_fusion.py's backbone with
heads of the family drawn by the JAX head inits, bridged.  The fc head is
served under 'vit_concat' (the window folded into the media) and trained
under ``use_hist``, the gpt head under 'post'.  Tolerances: the heads
within 1e-5; the engines' exit layers equal, actions and carries within
2e-4; calibration values within 1e-4 relative L2; a train step's loss
within 1e-5 relative and each gradient leaf within 1e-4 relative L2
(tests/test_torch_train.py's).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.cli import train as jtrain_cli
from deer_vla_tpu.eval import batched_policy as jbatched
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.eval import scan_policy as jscan
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeerPolicy
from deer_vla_tpu.models import alt_heads as jalt
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import heads as jheads
from deer_vla_tpu.train import losses as jloss
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.data.debug_data import DebugBatcher
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.eval import scan_policy as tscan
from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.models import alt_heads as talt
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import heads as theads
from deer_vla_tpu_torch.ops.dropout import Dropout
from deer_vla_tpu_torch.train import train_step as tstep
from test_torch_folded import window_obs
from test_torch_fusion import (frames, full_params, jx, pair, rel_l2,
                               shape_sig, text)
from test_torch_state import calib_draws, controllers, same_carry
from test_torch_train import (jax_flat, make_batch, recorded,
                              switch_layer_ids, torch_batch, torch_flat)

HEAD_ATOL = 1e-5
TOL = dict(rtol=2e-4, atol=2e-4)
CALIB_REL_L2 = 1e-4
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
# a leaf's gradient error relative to at least this share of the largest
# leaf's norm (tests/test_torch_fusion.py's GRAD_FLOOR)
GRAD_FLOOR = 1e-3
# the model of each served family
SERVED = {"gpt": {"head_type": "gpt"},
          "fc": {"head_type": "fc", "fusion_mode": "vit_concat"}}
# per-exit threshold rows: the first exit always, never (the last), and
# two in between
ROWS = [[1e8, 1e8], [-1.0, 1e8], [3e-2, 1e8], [1e-1, 1e8]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(changes, **more):
    tok = HashTokenizer(vocab_size=128, max_length=8)
    return tuple(dataclasses.replace(c, media_token_id=tok.media_token_id)
                 for c in pair(changes, **more))


def alt_params(jcfg, seed=60):
    """The shared backbone (and frame embeddings under use_hist) with every
    head drawn by the JAX head init of ``jcfg``'s family."""
    full = full_params()
    p = {k: v for k, v in full.items()
         if k in ("vit", "perceiver", "decoder")}
    if jcfg.use_hist:
        p["frame_embs"] = full["frame_embs"][:jcfg.window_size]

    def head(i):
        return jax.tree.map(np.asarray, jheads.init_any_head(
            jax.random.PRNGKey(seed + i), jcfg))

    p["lm_head"], p["extra_exit"] = head(0), head(1)
    p["lm_exits"] = {k: head(2 + i) for i, k in enumerate(full["lm_exits"])}
    return p


# ---------------------------------------------------------------------------
# routing, refusals, trees
# ---------------------------------------------------------------------------

REFUSED = {
    "fc_per_frame": {"head_type": "fc"},
    "gpt_state": {"head_type": "gpt", "use_state": True},
    "diffusion_history_past_window": {"head_type": "diffusion",
                                      "n_obs_steps": 5, "diff_horizon": 8},
    "diffusion_no_history_row": {"head_type": "diffusion", "n_obs_steps": 0},
    "diffusion_short_horizon": {"head_type": "diffusion", "n_obs_steps": 2,
                                "diff_horizon": 3},
    "diffusion_multi_step": {"head_type": "diffusion", "n_obs_steps": 2,
                             "diff_horizon": 4, "k": 2},
    "diffusion_hist": {"head_type": "diffusion", "n_obs_steps": 2,
                       "diff_horizon": 4, "use_hist": True},
    "diffusion_vit_concat": {"head_type": "diffusion", "n_obs_steps": 2,
                             "diff_horizon": 4, "fusion_mode": "vit_concat"},
    "unknown": {"head_type": "lstm"},
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_check_head_type_refusals_match_jax(case):
    """Each JAX refusal with its exception and message, from
    ``check_head_type`` and from ``init_deer``."""
    jcfg, tcfg = configs(REFUSED[case])
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jheads.check_head_type(jcfg)
    with pytest.raises(type(want.value)) as got:
        theads.check_head_type(tcfg)
    assert str(got.value) == str(want.value)
    with pytest.raises(type(want.value)):
        tflam.init_deer(tcfg, device="cpu")


@pytest.mark.parametrize("changes", [
    {"head_type": "gpt"}, {"head_type": "fc", "use_hist": True},
    {"head_type": "gpt", "gpt_hidden_size": 48}])
def test_alt_head_trees_widths_and_carries_match_jax(changes):
    """The port's init draws JAX's tree (a projection ``fc`` when the gpt
    width differs), the bridge carries a JAX tree unchanged (the ``blocks``
    list, ``wpe``), the criterion's width and the zero carry's layout
    agree, and the masks train every head leaf."""
    jcfg, tcfg = configs(changes)
    want = jax.eval_shape(lambda: jflam.init_deer(jax.random.PRNGKey(0),
                                                  jcfg))
    tp = tflam.init_deer(tcfg, seed=0, device="cpu")
    jsig = sorted(("/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                            for k in path), tuple(leaf.shape))
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(want)[0])
    assert shape_sig(tp) == jsig
    assert shape_sig(to_torch(alt_params(jcfg), "cpu")) == shape_sig(
        {k: tp[k] for k in ("vit", "perceiver", "decoder", "lm_head",
                            "extra_exit", "lm_exits", "frame_embs")
         if k in tp})
    assert ("fc" in tp["lm_head"]) == bool(tcfg.gpt_hidden_size)
    assert theads.head_action_width(tcfg) == jheads.head_action_width(jcfg)
    tc = theads.any_zero_carry(tcfg, 3)
    jc = jheads.any_zero_carry(jcfg, 3)
    assert len(tc) == len(jc)
    for t, j in zip(tc, jc):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    mask = tflam.trainable_mask(tp, tcfg, "exit_only")
    assert all(m for k, m in torch_flat(mask).items()
               if k.startswith(("lm_head", "extra_exit", "lm_exits")))


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------


def head_cfgs(**changes):
    jcfg, tcfg = configs({})
    return (dataclasses.replace(jcfg.head, **changes),
            dataclasses.replace(tcfg.head, **changes))


@pytest.mark.parametrize("use_state", [False, True])
def test_fc_decoder_matches_jax(use_state):
    """Inference, and training with JAX's keep masks (before fc1, before
    fc2, then the two MLPs); with state JAX's working fc_state path."""
    jh, th = head_cfgs(dropout=0.3, use_state=use_state)
    p = jax.tree.map(np.asarray, jalt.init_fc_decoder(jax.random.PRNGKey(3),
                                                      jh))
    r = np.random.RandomState(4)
    w = jh.window_size
    feat = r.randn(2 * w, 8, jh.in_features).astype(np.float32)
    st = r.randn(2 * w, 7).astype(np.float32) if use_state else None
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p, "cpu")
    want = jalt.fc_decoder_forward(jp, *jx(feat), jh, window=w,
                                   state=jx(st)[0])
    got = talt.fc_decoder_forward(tp, torch.as_tensor(feat), th, window=w,
                                  state=None if st is None
                                  else torch.as_tensor(st))
    assert got.actions.shape == (2, w, 6)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=HEAD_ATOL)
    want, masks = recorded(lambda: jalt.fc_decoder_forward(
        jp, *jx(feat), jh, window=w, state=jx(st)[0],
        dropout_rng=jax.random.PRNGKey(9), train=True))
    assert len(masks) == 2 + 2 * 3  # fc1, fc2, two layerwise MLPs
    got = talt.fc_decoder_forward(tp, torch.as_tensor(feat), th, window=w,
                                  state=None if st is None
                                  else torch.as_tensor(st),
                                  dropout=Dropout(masks=masks))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=HEAD_ATOL)


@pytest.mark.parametrize("hidden", [48])
def test_gpt_decoder_window_matches_jax(hidden):
    """The window forward, every step and the last, in inference and with
    the backbone's dropout masks (embedding, attention output, the
    projection's residual and the MLP's, per block); a width other than the
    features' adds the input projection."""
    jh, th = head_cfgs()
    jg = jalt.GPTDecoderConfig(head=jh, hidden_size=hidden)
    tg = talt.GPTDecoderConfig(head=th, hidden_size=hidden)
    p = jax.tree.map(np.asarray, jalt.init_gpt_decoder(
        jax.random.PRNGKey(5), jg))
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p, "cpu")
    w = jh.window_size
    feat = np.random.RandomState(6).randn(3 * w, 8, jh.in_features).astype(
        np.float32)
    for last in (False, True):
        want = jalt.gpt_decoder_forward(jp, *jx(feat), jg, window=w,
                                        last_action=last)
        got = talt.gpt_decoder_forward(tp, torch.as_tensor(feat), tg,
                                       window=w, last_action=last)
        assert got.actions.shape == (3, 1 if last else w, 6)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                       atol=HEAD_ATOL)
    want, masks = recorded(lambda: jalt.gpt_decoder_forward(
        jp, *jx(feat), jg, window=w, dropout_rng=jax.random.PRNGKey(2),
        train=True))
    assert len(masks) == 1 + 3 * jg.n_layer
    got = talt.gpt_decoder_forward(tp, torch.as_tensor(feat), tg, window=w,
                                   dropout=Dropout(masks=masks))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=HEAD_ATOL)


def test_gpt_streamed_steps_match_jax():
    """Three streamed steps of two streams from another count each: one
    filling its buffer from slot 0, one a frame short of full that then
    rolls; outputs and the (history, count) carry within 1e-5."""
    jh, th = head_cfgs()
    jg, tg = (m.GPTDecoderConfig(head=h) for m, h in ((jalt, jh),
                                                      (talt, th)))
    p = jax.tree.map(np.asarray, jalt.init_gpt_decoder(
        jax.random.PRNGKey(7), jg))
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p, "cpu")
    r = np.random.RandomState(8)
    hist = r.randn(2, jg.hist, jg.dim).astype(np.float32)
    count = np.array([0, jg.hist - 1], np.int32)
    jc = jalt.GPTCarry(jnp.asarray(hist), jnp.asarray(count))
    tc = talt.GPTCarry(torch.as_tensor(hist), torch.as_tensor(count))
    for t in range(3):
        feat = r.randn(2, 8, jh.in_features).astype(np.float32)
        jo, jc = jalt.gpt_decoder_step(jp, jnp.asarray(feat), jc, jg)
        to, tc = talt.gpt_decoder_step(tp, torch.as_tensor(feat), tc, tg)
        for g, j in zip(to, jo):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                       atol=HEAD_ATOL)
        np.testing.assert_array_equal(tc.count.numpy(), np.asarray(jc.count))
        np.testing.assert_allclose(tc.history.numpy(),
                                   np.asarray(jc.history), rtol=0,
                                   atol=HEAD_ATOL)
    np.testing.assert_array_equal(tc.count.numpy(), [3, jg.hist])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """{family: (jcfg, tcfg, params, JAX scan engine, port scan engine)}."""
    out = {}
    for name, changes in SERVED.items():
        jcfg, tcfg = configs(changes)
        p = alt_params(jcfg)
        out[name] = (jcfg, tcfg, p,
                     jscan.ScanDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg),
                     tscan.ScanDeerPolicy(p, tcfg, device="cpu"))
    return out


def obs(cfg, streams, seed):
    """A step's inputs: a frame a stream, or a W-frame window a stream
    under 'vit_concat'."""
    if cfg.fusion_mode == "vit_concat":
        return window_obs(cfg, streams, seed)[:4]
    img, grip, _ = frames(cfg, streams, seed, state=False)
    ids, mask = text(cfg, streams, seed + 50, media_at=2)
    return img, grip, ids, mask


@pytest.mark.parametrize("name", list(SERVED))
def test_alt_head_scan_step_matches_jax(served, name):
    """B=1, each threshold row for three threaded steps: exits, actions
    and the carry (the gpt head's history and count)."""
    jcfg, _, _, jpol, tpol = served[name]
    seen = set()
    for th in ROWS:
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for t in range(3):
            args = obs(jcfg, 1, seed=t)
            a_j = jpol.step(*jx(*args))
            a_t = tpol.step(*args)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(a_t, np.asarray(a_j), **TOL)
            same_carry(tpol.carry, jpol.carry)
            seen.add(tpol.last_exit_layer)
    assert seen == set(jcfg.all_exit_ids())


@pytest.mark.parametrize("name", list(SERVED))
def test_alt_head_scan_step_batch_matches_jax(served, name):
    """B=4 with a threshold row a stream, three steps, then a lane-local
    reset: the carry's layout (none for fc, the gpt buffer and count)."""
    jcfg, _, _, jpol, tpol = served[name]
    for p in (jpol, tpol):
        p.set_thresholds_batch(ROWS)
        p.reset()
    for t in range(3):
        args = obs(jcfg, 4, seed=10 + t)
        acts_j, ex_j = jpol.step_batch(*jx(*args))
        acts_t, ex_t = tpol.step_batch(*args)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_array_equal(ex_t[:2], jcfg.all_exit_ids())
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
        same_carry(tpol.carry, jpol.carry)
        if t == 1:
            reset = np.array([True, False, False, True])
            jpol.reset_streams(reset)
            tpol.reset_streams(reset)
            same_carry(tpol.carry, jpol.carry)
    if name == "gpt":
        np.testing.assert_array_equal(tpol.carry.count.numpy(), [1, 3, 3, 1])
    else:
        assert tpol.carry == ()


@pytest.mark.parametrize("name", list(SERVED))
def test_alt_head_deer_policy_matches_jax(served, name):
    """The host-bucketed engine: each row of ROWS in turn, the carry
    threaded; exits, actions and carries as JAX's."""
    jcfg, tcfg, p, _, _ = served[name]
    jc, tc = controllers(tcfg, ROWS[0])
    jpol = JaxDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg, controller=jc)
    tpol = DeerPolicy(p, tcfg, controller=tc, device="cpu")
    seen = set()
    for t, th in enumerate(ROWS * 2):
        jc.set_threshold_values(th)
        tc.set_threshold_values(th)
        for pol in (jpol, tpol):
            pol.set_timestep(t)
        args = obs(jcfg, 1, seed=30 + t)
        a_j = jpol.step(*jx(*args))
        a_t = tpol.step(*args)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        np.testing.assert_allclose(a_t, np.asarray(a_j), **TOL)
        same_carry(tpol.carry, jpol.carry)
        seen.add(tpol.last_exit_layer)
    assert seen == set(jcfg.all_exit_ids())


def test_only_the_routing_engines_serve_alt_heads(served):
    """BatchedDeerPolicy serves the LSTM head only and refuses the others
    with JAX's message; the scan engine and DeerPolicy take them."""
    jcfg, tcfg, p, _, _ = served["gpt"]
    with pytest.raises(NotImplementedError) as want:
        jbatched.BatchedDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg,
                                   batch=2)
    with pytest.raises(NotImplementedError) as got:
        BatchedDeerPolicy(p, tcfg, batch=2, device="cpu")
    assert str(got.value) == str(want.value)
    tscan.check_serving_supported(tcfg, allow_any_head=True)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["gpt_streamed", "fc_vit_concat_warm"])
def test_alt_head_calibration_matches_jax(served, case):
    """``calibrate`` end to end on DebugBatcher batches with JAX's draws:
    the gpt head in the streamed regime (its history buffer carried through
    the window, the committed exit's per step), the fc head under
    'vit_concat' with --calib_warm's prefix (the folded regime's window
    forward)."""
    name = case.split("_")[0]
    streamed = case == "gpt_streamed"
    # the streamed regime steps the head twice a frame over two passes:
    # a window of 2 keeps JAX's compile of it short
    jcfg, tcfg = configs(SERVED[name], window=2 if streamed else 4)
    p = served[name][2]
    warm = 2 if name == "fc" else 0
    tok = HashTokenizer(vocab_size=128, max_length=8)
    hw = jcfg.vit.image_size
    batches = list(DebugBatcher(jcfg, tok, batch_size=2, num_batches=1,
                                img_hw=hw, grip_hw=hw, seed=8))
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, p), jcfg,
                                  batches, 0.5, max_batches=1,
                                  streamed=streamed, warm_prefix=warm)
    probs = (tcal.streamed_sample_probs(tcfg, 0.5, None, "exp",
                                        "mpt_dolly_3b") if streamed else None)
    th_t, vals_t = tcal.calibrate(
        to_torch(p, "cpu"), tcfg, batches, 0.5, max_batches=1,
        streamed=streamed, warm_prefix=warm,
        draws=calib_draws(jcfg, 1, streamed, warm, probs))
    assert vals_t.shape == vals_j.shape
    assert rel_l2(vals_t, vals_j) <= CALIB_REL_L2
    np.testing.assert_allclose([th_t[e] for e in sorted(th_t)],
                               [th_j[e] for e in sorted(th_j)],
                               rtol=CALIB_REL_L2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the gpt model of the train step: single-exit (the final head and the
# extra exit twice) with 2 GPT blocks instead of 8, as JAX compiles each
# head call of the step anew, every block forward and backward (a block is
# a block; the 8-block stack runs in every other test here)
TRAINED = {"gpt_single_exit_2_blocks": ({"head_type": "gpt",
                                         "multi_exit": False}, {}),
           "fc_hist_dropout": ({"head_type": "fc", "use_hist": True},
                               {"dropout": 0.3})}


def with_given_masks(fn, *args, seed=0):
    """``jax.jit(fn)(*args)`` with every keep mask ``jax.random.bernoulli``
    would draw taken from a seeded numpy stream instead, in call order:
    (output, [masks]).  The masks enter the program as constants, which
    spares the compile of JAX's random bits (a third of it for the gpt
    heads)."""
    r = np.random.RandomState(seed)
    masks = []
    real = jax.random.bernoulli

    def given(key, p, shape=None):
        masks.append(r.uniform(size=shape) < p)
        return jnp.asarray(masks[-1])

    jax.random.bernoulli = given
    try:
        out = jax.jit(fn)(*args)
    finally:
        jax.random.bernoulli = real
    return out, masks


def jax_loss_and_grads(jcfg, params, batch, rng):
    """The JAX train step's loss and gradients (the diffusion head's DDPM
    loss from ``fold_in(rng, 99)``, as make_train_step draws it), the
    sampling-1 layers and the dropout keep masks, from one compile."""
    last = jcfg.use_hist or jcfg.fusion_mode == "vit_concat"

    def loss_fn(p, image, gripper, ids, mask, labels):
        out = jflam.forward_train(p, image, ids, mask, jcfg, rng,
                                  vision_gripper=gripper, train=True)
        if jcfg.head_type == "diffusion":
            loss, _ = jloss.multi_exit_diffusion_loss(
                out, labels, p["diffusion"], jcfg, jax.random.fold_in(rng,
                                                                      99))
        else:
            loss, _ = jloss.multi_exit_loss(out, labels, 0.01,
                                            last_step_only=last)
        return loss, out.rand_layer_ids

    ((loss, lay1), grads), masks = with_given_masks(
        jax.value_and_grad(loss_fn, has_aux=True),
        jax.tree.map(jnp.asarray, params),
        *jx(*(batch[k] for k in ("image", "gripper", "input_ids",
                                 "attention_mask", "labels"))))
    return (float(loss), jax_flat(grads),
            {"rand_layer_ids": torch.as_tensor(np.array(lay1)),
             "switch_layer_ids": torch.as_tensor(switch_layer_ids(
                 jcfg, rng, batch["labels"].shape[0])),
             "dropout": Dropout(masks=masks)})


def check_grads(tcfg, params, batch, want_loss, want_grads, draws):
    """The port's joint-phase loss and the gradient of every trainable
    leaf against JAX's: the whole gradient within GRAD_REL_L2, and each
    leaf relative to its own norm or a thousandth of the largest leaf's,
    whichever is larger (tests/test_torch_fusion.py's rule: a gate's
    gradient can cancel to far below the terms it sums)."""
    tp = to_torch(params, "cpu")
    mask = tflam.trainable_mask(tp, tcfg, "joint")
    keys = [k for k, m in torch_flat(mask).items() if m]
    loss, _, grads = tstep.loss_and_grads(tp, keys, torch_batch(batch), tcfg,
                                          draws=[draws])
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    got = {k: (np.zeros_like(want_grads[k]) if grads[k] is None
               else grads[k].numpy()) for k in keys}
    assert rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                  np.concatenate([want_grads[k].ravel() for k in keys])) \
        <= GRAD_REL_L2
    floor = GRAD_FLOOR * max(np.linalg.norm(want_grads[k]) for k in keys)
    for k in keys:
        err = np.linalg.norm(got[k].astype(np.float64) - want_grads[k])
        assert err <= GRAD_REL_L2 * max(np.linalg.norm(want_grads[k]),
                                        floor), k
    return keys, grads


@pytest.mark.parametrize("name", list(TRAINED))
def test_alt_head_train_step_matches_jax(name, monkeypatch):
    """A joint step's loss and gradients with JAX's layer draws and keep
    masks: the gpt backbone's 0.1 dropout is always on in training, the fc
    head's at the head's rate; fc under use_hist scores the last step."""
    for mod, gmod in ((jheads, jalt), (theads, talt)):
        monkeypatch.setattr(mod, "gpt_head_config",
                            lambda cfg, g=gmod: g.GPTDecoderConfig(
                                head=cfg.head, hidden_size=cfg.gpt_hidden_size,
                                n_layer=2))
    changes, head = TRAINED[name]
    jcfg, tcfg = (dataclasses.replace(c, head=dataclasses.replace(c.head,
                                                                  **head))
                  for c in configs(changes))
    p = alt_params(jcfg, seed=70)
    if not jcfg.multi_exit:
        p["lm_exits"] = {}
    batch = make_batch(jcfg, 2, seed=12)
    loss, grads, draws = jax_loss_and_grads(jcfg, p, batch,
                                            jax.random.PRNGKey(21))
    assert draws["dropout"].masks is not None
    keys, got = check_grads(tcfg, p, batch, loss, grads, draws)
    assert all(got[k] is not None for k in keys
               if k.startswith(("lm_head", "extra_exit", "lm_exits")))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

CLI_HEADS = {"gpt": ["--head_type", "gpt"],
             "fc": ["--head_type", "fc", "--fusion_mode", "vit_concat"]}


@pytest.mark.parametrize("name", list(CLI_HEADS))
def test_train_cli_then_eval_per_head(tmp_path, capsys, name):
    """cli/train --head_type builds JAX's config from the same flags and
    trains both phases; cli/eval serves the checkpoint (its sidecar gives
    the family) and ends with the parse contract."""
    run = str(tmp_path / "run")
    argv = ["--debug", "--model", "tiny", "--num_joint_epochs", "1",
            "--num_exit_epochs", "1", "--batch_size_calvin", "2",
            "--run_name", run, "--joint_warmup_steps", "1",
            "--exit_warmup_steps", "1", "--precision", "fp32",
            "--hidden_size", "48"] + CLI_HEADS[name]
    want = jtrain_cli.make_model_config(jtrain_cli.build_parser().parse_args(
        argv))
    trainer = train_cli.main(argv, device="cpu")
    cfg = trainer.cfg
    for field in ("head_type", "gpt_hidden_size", "fusion_mode",
                  "diff_timesteps", "n_obs_steps", "diff_horizon"):
        assert getattr(cfg, field) == getattr(want, field), field
    with open(f"{run}/deer_1.json") as f:
        assert json.load(f)["config"]["head_type"] == name
    capsys.readouterr()
    report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                            f"{run}/deer_1.ckpt", "--calib_batches", "1",
                            "--num_sequences_override", "2", "--exit_ratio",
                            "0.5"] + (["--calib_warm", "2"] if name == "fc"
                                      else []), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert abs(float(lines[-2]) - report["avg_seq_len"]) < 1e-6
    assert report["avg_exit_layer"] >= 2.0
    with pytest.raises(SystemExit, match="holds a"):
        eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                       f"{run}/deer_1.ckpt", "--head_type", "deterministic"],
                      device="cpu")


EVAL_ARGV = ["--debug", "--model", "tiny", "--thresholds", "0.1", "1e8",
             "--num_sequences_override", "1"]


@pytest.mark.parametrize("flags,error,match", [
    (["--head_type", "diffusion", "--action_cache_tau", "0.03"], SystemExit,
     "--action_cache_tau does not compose"),
    (["--head_type", "diffusion", "--multi_execution", "2"], SystemExit,
     "--multi_execution has no effect"),
    (["--head_type", "gpt", "--vision_cache_tau", "0.05"], SystemExit,
     "--vision_cache_tau currently serves"),
    (["--head_type", "diffusion", "--engine", "bucketed",
      "--use_action_ensemble"], NotImplementedError, "ensembling"),
    (["--head_type", "fc"], NotImplementedError, "requires --use_hist")])
def test_eval_cli_head_refusals(flags, error, match):
    """JAX's refusals for the other heads (cli/eval.py:361-376, the
    ensemble's in DeerPolicy, the fc head's in check_head_type)."""
    with pytest.raises(error, match=match):
        eval_cli.main(EVAL_ARGV + flags, device="cpu")


@pytest.mark.parametrize("flag", [["--tcp_rel"], ["--visualize", "gifs"],
                                  ["--diverse_inst"],
                                  ["--annotation_cache", "a.json"]])
def test_eval_cli_download_free_flags_name_m9b(flag):
    """The rollout options that need no download wait for M9b, not the
    dropped CALVIN env item."""
    with pytest.raises(SystemExit, match=r"\(ROADMAP\.md M9b \("):
        eval_cli.main(EVAL_ARGV + flag, device="cpu")


def test_eval_cli_head_type_builds_the_train_cli_config():
    """--head_type on a seeded model takes cli/train's head fields at
    their defaults (the diffusion history clamped to the window)."""
    args = eval_cli.build_parser().parse_args(
        ["--model", "tiny", "--head_type", "diffusion"])
    cfg, params = eval_cli.load_model(args, torch.device("cpu"))
    want = jtrain_cli.make_model_config(jtrain_cli.build_parser().parse_args(
        ["--model", "tiny", "--head_type", "diffusion"]))
    for field in ("head_type", "gpt_hidden_size", "diff_timesteps",
                  "n_obs_steps", "diff_horizon"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.n_obs_steps == 4 and "diffusion" in params


@pytest.mark.parametrize("head", ["gpt", "diffusion"])
def test_eval_cli_heads_run_on_the_card_unless_told(monkeypatch, head):
    """``main(argv)`` without a device serves on the card: on a host
    without one it raises instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--debug", "--model", "tiny", "--head_type", head,
                       "--diff_steps", "10"])
