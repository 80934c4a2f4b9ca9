"""PyTorch port, the calibration path: preprocessing, the full-window head,
the all-layer decoder, the training forward, the calibration deltas in both
regimes, the threshold solver and the sidecar, each against the JAX
package on the CPU with the same (bridged) deer_tiny weights and inputs.

Random draws the two packages cannot share (the sampling-1 layer ids, the
warm-prefix permutations, the streamed regime's committed exits) are taken
from the JAX side, recomputed here from its keys, and handed to the port.

Tolerances (fp32): relative L2 1e-4 on tensors from the model (as
tests/test_torch_scan_policy.py), 2e-5 absolute on normalized pixels (unit
scale; both sides sum the same few fp32 products in another order); the
host-side numpy code (solver, controller, batches, sidecar) bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.data import debug_data as jdebug
from deer_vla_tpu.data import preprocess as jprep
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu.models import value_net as jvn
from deer_vla_tpu.ops import lstm as jlstm
from deer_vla_tpu.ops import rand_shift as jshift
from deer_vla_tpu.train import checkpoint as jckpt
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data import debug_data as tdebug
from deer_vla_tpu_torch.data import preprocess as tprep
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.models import action_head as thead
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.models import value_net as tvn
from deer_vla_tpu_torch.ops import lstm as tlstm
from deer_vla_tpu_torch.ops import rand_shift as tshift
from deer_vla_tpu_torch.train import checkpoint as tckpt

REL_L2 = 1e-4
PIXEL_ATOL = 2e-5


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def assert_close(got, want, tol=REL_L2):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == np.shape(want)
    assert rel_l2(got, want) <= tol, rel_l2(got, want)


def open_gates(params, seed):
    """Non-zero x-attn gates, so the vision path reaches the actions and the
    deltas spread (the init leaves the gates at zero)."""
    r = np.random.RandomState(seed)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return params


def configs(window=4):
    tok = HashTokenizer(vocab_size=128, max_length=8)
    jcfg, tcfg = (dataclasses.replace(c, media_token_id=tok.media_token_id)
                  for c in (jconfig.deer_tiny(window_size=window),
                            tconfig.deer_tiny(window_size=window)))
    return jcfg, tcfg, tok


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, tok = configs()
    params = open_gates(jax.tree.map(np.asarray, jflamingo.init_deer(
        jax.random.PRNGKey(0), jcfg)), seed=7)
    return (jcfg, tcfg, tok, jax.tree.map(jnp.asarray, params),
            to_torch(params, "cpu"))


def debug_batches(jcfg, tok, num=2, seed=0):
    hw = jcfg.vit.image_size
    return list(jdebug.DebugBatcher(jcfg, tok, batch_size=2, num_batches=num,
                                    img_hw=hw, grip_hw=hw, seed=seed))


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [200, 84, 256, 224])
def test_clip_preprocess_matches_jax_cubic_resize(src):
    """200 -> 224 and 84 -> 224 upsample (CALVIN's static and wrist
    frames), 256 -> 224 downsamples with the antialiased kernel, 224 is the
    identity."""
    r = np.random.RandomState(src)
    u8 = r.randint(0, 256, (2, src, src, 3)).astype(np.uint8)
    want = np.asarray(jprep.clip_preprocess(jnp.asarray(u8), 224))
    got = tprep.clip_preprocess(torch.as_tensor(u8), 224)
    assert got.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)


def test_torch_bicubic_is_not_the_jax_resize():
    """Why the weights are built by hand: torch's bicubic (a = -0.75, no
    antialias) is far from the JAX resize when downsampling."""
    u8 = np.random.RandomState(0).randint(0, 256, (1, 256, 256, 3)).astype(
        np.uint8)
    want = np.asarray(jprep.clip_preprocess(jnp.asarray(u8), 224))
    x = torch.as_tensor(u8).float().permute(0, 3, 1, 2) / 255.0
    bicubic = torch.nn.functional.interpolate(x, size=(224, 224),
                                              mode="bicubic",
                                              align_corners=False)
    mean = torch.tensor(tprep.CLIP_MEAN)[:, None, None]
    std = torch.tensor(tprep.CLIP_STD)[:, None, None]
    assert np.abs(((bicubic - mean) / std).numpy() - want).max() > 0.1


@pytest.mark.parametrize("traj", [False, True])
def test_random_shift_matches_jax_given_its_shifts(traj):
    key = jax.random.PRNGKey(3)
    pad = 4
    r = np.random.RandomState(1)
    if traj:
        x = r.randn(2, 3, 3, 16, 16).astype(np.float32)
        want = jshift.random_shift_traj(key, jnp.asarray(x), pad)
        shifts = jax.random.randint(key, (6, 2), 1, 2 * pad + 1)
        got = tshift.random_shift_traj(None, torch.as_tensor(x), pad,
                                       torch.as_tensor(np.array(shifts)))
    else:
        x = r.randn(5, 3, 16, 16).astype(np.float32)
        want = jshift.random_shift(key, jnp.asarray(x), pad)
        shifts = jax.random.randint(key, (5, 2), 0, 2 * pad + 1)
        got = tshift.random_shift(None, torch.as_tensor(x), pad,
                                  torch.as_tensor(np.array(shifts)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_preprocess_train_frames_draws_from_the_generator():
    """Shifts from a seeded generator: in range, the same for the same seed,
    and the frames come back as (B*W, 1, 1, 3, size, size)."""
    u8 = torch.randint(0, 256, (4, 20, 20, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
    outs = [tprep.preprocess_train_frames(
        torch.Generator().manual_seed(5), u8, u8, window=2, size=28,
        rgb_pad=3, gripper_pad=2) for _ in range(2)]
    assert outs[0][0].shape == (4, 1, 1, 3, 28, 28)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    s = tshift.draw_shifts(torch.Generator().manual_seed(1), 1000, 1, 3)
    assert int(s.min()) == 1 and int(s.max()) == 6


def test_debug_batcher_matches_jax():
    """The same draws as JAX's DebugBatcher; the port puts robot_obs's last
    entry, the gripper state a state head looks up, at the sign of JAX's
    draw (-1 or 1, as CALVIN's)."""
    jcfg, tcfg, tok = configs()
    jtok = JaxTokenizer(vocab_size=128, max_length=8)
    jb = jdebug.DebugBatcher(jcfg, jtok, num_batches=2, seed=3)
    tb = tdebug.DebugBatcher(tcfg, tok, num_batches=2, seed=3)
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            if k == "robot_obs":
                np.testing.assert_array_equal(b[k][..., :-1], a[k][..., :-1])
                np.testing.assert_array_equal(
                    b[k][..., -1], np.where(a[k][..., -1] >= 0, 1.0, -1.0))
            else:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# full-window head, decoder, training forward
# ---------------------------------------------------------------------------


def test_lstm_forward_matches_jax():
    p = jax.tree.map(np.asarray, jlstm.init_lstm(jax.random.PRNGKey(1), 12,
                                                 16, 3, use_layernorm=True))
    r = np.random.RandomState(2)
    x = r.randn(3, 5, 12).astype(np.float32)
    carry = (r.randn(3, 3, 16).astype(np.float32),
             r.randn(3, 3, 16).astype(np.float32))
    for c in (None, carry):
        y_j, (h_j, c_j) = jlstm.lstm_forward(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x),
            None if c is None else tuple(map(jnp.asarray, c)))
        y_t, (h_t, c_t) = tlstm.lstm_forward(
            to_torch(p, "cpu"), torch.as_tensor(x),
            None if c is None else tuple(map(torch.as_tensor, c)))
        for got, want in ((y_t, y_j), (h_t, h_j), (c_t, c_j)):
            assert_close(got, np.asarray(want))


@pytest.mark.parametrize("last_action", [False, True])
def test_head_forward_matches_jax(last_action):
    jcfg, tcfg, _ = configs()
    p = jax.tree.map(np.asarray, jhead.init_head(jax.random.PRNGKey(4),
                                                 jcfg.head))
    feat = np.random.RandomState(5).randn(8, 6, 64).astype(np.float32)
    want = jhead.head_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(feat),
                              jcfg.head, last_action=last_action)
    got = thead.head_forward(to_torch(p, "cpu"), torch.as_tensor(feat),
                             tcfg.head, last_action=last_action)
    assert got.actions.shape == (2, 1 if last_action else 4, 6)
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w))


def make_media(cfg, b, seed):
    return np.random.RandomState(seed).randn(
        b, 1, cfg.num_media_tokens, cfg.vis_dim).astype(np.float32)


def make_text(cfg, b, seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, cfg.media_token_id, (b, cfg.text_len)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    mask = np.ones_like(ids)
    mask[1:, -2:] = 0
    return ids, mask


def test_decoder_forward_matches_jax(tiny):
    jcfg, tcfg, _, jp, tp = tiny
    ids, mask = make_text(jcfg, 3, seed=9)
    media = make_media(jcfg, 3, seed=10)
    hs_j, x_j = jmpt.decoder_forward(jp["decoder"], jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(media),
                                     jcfg)
    hs_t, x_t = tmpt.decoder_forward(tp["decoder"],
                                     torch.as_tensor(ids).long(),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(media), tcfg)
    assert hs_t.shape == (jcfg.n_layers, 3, jcfg.text_len, 64)
    assert_close(hs_t, np.asarray(hs_j))
    assert_close(x_t, np.asarray(x_j))


def jax_inputs(jcfg, batch):
    """The JAX calibration's frame preprocessing and text layout."""
    w = jcfg.window_size
    stat = batch["rgb_static"].reshape(-1, *batch["rgb_static"].shape[2:])
    grip = batch["rgb_gripper"].reshape(-1, *batch["rgb_gripper"].shape[2:])
    img, gri = jprep.preprocess_train_frames(
        jax.random.PRNGKey(0), jnp.asarray(stat), jnp.asarray(grip),
        rgb_pad=0, gripper_pad=0, window=w, size=jcfg.vit.image_size)
    s = batch["input_ids"].shape[-1]
    ids = np.repeat(batch["input_ids"][:, None], w, 1).reshape(-1, s)
    mask = np.repeat(batch["attention_mask"][:, None], w, 1).reshape(-1, s)
    from deer_vla_tpu.data.text import fixed_length
    ids, mask = fixed_length(ids, mask, jcfg.text_len, 0)
    return img, gri, jnp.asarray(ids), jnp.asarray(mask)


def switch_layer_ids(jcfg, rng, bs):
    """forward_train's sampling-2 layers, recomputed from its key."""
    w, n_exit = jcfg.window_size, jcfg.num_exits
    rngs = jax.random.split(rng, 8)
    prev_len = jax.random.randint(rngs[4], (), 1, w + 1)
    idx2 = jax.random.randint(rngs[5], (bs, 2), 0, n_exit)
    pick = jnp.where(jnp.arange(w)[None] < prev_len, idx2[:, :1], idx2[:, 1:])
    return np.asarray(jnp.asarray(jcfg.all_exit_ids())[pick])


@pytest.mark.parametrize("only_extra_exit", [True, False])
def test_forward_train_matches_jax_given_its_layer_draws(tiny,
                                                         only_extra_exit):
    jcfg, tcfg, tok, jp, tp = tiny
    batch = debug_batches(jcfg, tok, num=1, seed=4)[0]
    img, gri, ids, mask = jax_inputs(jcfg, batch)
    img_t, gri_t, ids_t, mask_t = tcal.batch_inputs(batch, tcfg,
                                                    torch.device("cpu"))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img),
                               atol=PIXEL_ATOL, rtol=0)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids))
    rng = jax.random.PRNGKey(11)
    fwd = jax.jit(lambda p, a, b, c, g: jflamingo.forward_train(
        p, a, b, c, jcfg, rng, vision_gripper=g,
        only_extra_exit=only_extra_exit, train=False))
    want = fwd(jp, img, ids, mask, gri)
    lay1 = np.array(want.rand_layer_ids)
    got = tflamingo.forward_train(
        tp, img_t, ids_t, mask_t, tcfg, vision_gripper=gri_t,
        only_extra_exit=only_extra_exit, train=False,
        rand_layer_ids=torch.as_tensor(lay1),
        switch_layer_ids=torch.as_tensor(switch_layer_ids(jcfg, rng, 2)))
    np.testing.assert_array_equal(got.rand_layer_ids.numpy(), lay1)
    assert_close(got.hidden_states, np.asarray(want.hidden_states))
    assert_close(got.rand_layer_feat, np.asarray(want.rand_layer_feat))
    for part in ("final_output", "extra_output", "extra_output2"):
        for g, w in zip(getattr(got, part), getattr(want, part)):
            assert_close(g, np.asarray(w))
    assert len(got.exit_outputs) == len(want.exit_outputs)
    for go, wo in zip(got.exit_outputs, want.exit_outputs):
        assert_close(go.actions, np.asarray(wo.actions))


def test_forward_train_draws_layers_from_the_generator(tiny):
    """Without caller draws the layers come from the generator: reproducible
    for a seed, always exit layers."""
    jcfg, tcfg, tok, _, tp = tiny
    batch = debug_batches(jcfg, tok, num=1)[0]
    inputs = tcal.batch_inputs(batch, tcfg, torch.device("cpu"))
    outs = [tflamingo.forward_train(tp, inputs[0], inputs[2], inputs[3], tcfg,
                                    torch.Generator().manual_seed(3),
                                    vision_gripper=inputs[1],
                                    only_extra_exit=True, train=False)
            for _ in range(2)]
    lay = outs[0].rand_layer_ids
    assert lay.shape == (2, tcfg.window_size)
    assert torch.equal(lay, outs[1].rand_layer_ids)
    assert set(lay.flatten().tolist()) <= set(tcfg.all_exit_ids())


# ---------------------------------------------------------------------------
# calibration deltas
# ---------------------------------------------------------------------------


def features(cfg, bsw, seed):
    r = np.random.RandomState(seed)
    hidden = r.randn(cfg.n_layers, bsw, cfg.text_len, 64).astype(np.float32)
    rand = r.randn(bsw, cfg.text_len, 64).astype(np.float32)
    return hidden, rand


def head_params(seed):
    _, tcfg, _ = configs()
    return jax.tree.map(np.asarray, jhead.init_head(jax.random.PRNGKey(seed),
                                                    tcfg.head))


@pytest.mark.parametrize("threshold_type", ["L2", "max", "cosine"])
def test_generate_exit_deltas_matches_jax(threshold_type):
    jcfg, tcfg, _ = configs()
    p = head_params(12)
    hidden, rand = features(jcfg, 3 * jcfg.window_size, seed=13)
    exits = list(jcfg.all_exit_ids())
    want = jvn.generate_exit_deltas(
        jax.tree.map(jnp.asarray, p), jnp.asarray(hidden), jnp.asarray(rand),
        jcfg, exits, threshold_type)
    got = tvn.generate_exit_deltas(to_torch(p, "cpu"), torch.as_tensor(hidden),
                                   torch.as_tensor(rand), tcfg, exits,
                                   threshold_type)
    assert got.shape == (len(exits), 3 * 2)  # positions W//2-1 .. W-2
    if threshold_type == "cosine":
        # 1 - cos of nearly parallel actions: a difference of numbers near
        # 1, so the tolerance is absolute, a few fp32 ulps of 1.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    else:
        assert_close(got, np.asarray(want))


def test_generate_exit_deltas_warm_prefix_matches_jax_given_its_perms():
    jcfg, tcfg, _ = configs(window=1)
    p = head_params(14)
    hidden, rand = features(jcfg, 5, seed=15)
    exits = list(jcfg.all_exit_ids())
    rng = jax.random.PRNGKey(16)
    want = jvn.generate_exit_deltas(
        jax.tree.map(jnp.asarray, p), jnp.asarray(hidden), jnp.asarray(rand),
        jcfg, exits, warm_prefix=3, rng=rng)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(rng, k), 5)) for k in range(3)], axis=1)
    got = tvn.generate_exit_deltas(to_torch(p, "cpu"), torch.as_tensor(hidden),
                                   torch.as_tensor(rand), tcfg, exits,
                                   warm_prefix=3,
                                   warm_perms=torch.as_tensor(perms))
    assert_close(got, np.asarray(want))
    cold = jvn.generate_exit_deltas(
        jax.tree.map(jnp.asarray, p), jnp.asarray(hidden), jnp.asarray(rand),
        jcfg, exits)
    assert rel_l2(np.asarray(want), np.asarray(cold)) > 1e-2  # warm matters


def jax_commit_exits(rng, n_exit, probs, n):
    """generate_streamed_exit_deltas' committed exits, from its keys."""
    probs = np.asarray(probs, np.float64)
    p = jnp.asarray(probs / probs.sum(), jnp.float32)
    return [int(jax.random.choice(jax.random.fold_in(rng, i), n_exit, p=p))
            for i in range(n)]


@pytest.mark.parametrize("probs", [None, [0.5, 0.25]])
def test_generate_streamed_exit_deltas_matches_jax_given_its_commits(probs):
    jcfg, tcfg, _ = configs()
    p = head_params(17)
    hidden, _ = features(jcfg, 2 * jcfg.window_size, seed=18)
    exits = list(jcfg.all_exit_ids())
    rng = jax.random.PRNGKey(19)
    want = jvn.generate_streamed_exit_deltas(
        jax.tree.map(jnp.asarray, p), jnp.asarray(hidden), jcfg, exits,
        rng=rng, exit_sample_probs=probs)
    commits = jax_commit_exits(rng, len(exits), tvn.streamed_probs(
        len(exits), probs), 2 * jcfg.window_size)
    got = tvn.generate_streamed_exit_deltas(
        to_torch(p, "cpu"), torch.as_tensor(hidden), tcfg, exits,
        exit_sample_probs=probs, commit_exits=commits)
    # positions W//2-1 .. W-1 of the scored pass
    assert got.shape == (len(exits), 2 * 3)
    assert_close(got, np.asarray(want))


def test_streamed_commits_from_the_generator_are_reproducible():
    _, tcfg, _ = configs()
    p = to_torch(head_params(20), "cpu")
    hidden = torch.as_tensor(features(tcfg, 8, seed=21)[0])
    exits = list(tcfg.all_exit_ids())
    a, b = (tvn.generate_streamed_exit_deltas(
        p, hidden, tcfg, exits, gen=torch.Generator().manual_seed(4))
        for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="committed exits"):
        tvn.generate_streamed_exit_deltas(p, hidden, tcfg, exits,
                                          commit_exits=[0, 1])


# ---------------------------------------------------------------------------
# solver, controller (numpy copies: bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio,dist,model", [
    (1.0, "exp", "mpt_dolly_3b"), (0.5, "exp", "mpt_dolly_3b"),
    (0.8, "gauss", "mpt_dolly_3b"), (1.5, "gamma", "mpt_dolly_3b"),
    (0.7, "exp", "mpt_9b")])
def test_solve_thresholds_and_exit_probs_bit_for_bit(ratio, dist, model):
    vals = np.random.RandomState(22).rand(6, 97)
    exits = [1, 3, 5, 7, 9, 11]
    for max_layer in (11, 6):
        for leq in (True, False):
            th_j, pr_j = jvn.solve_thresholds(vals, ratio, exits, max_layer,
                                              dist, leq, model)
            th_t, pr_t = tvn.solve_thresholds(vals, ratio, exits, max_layer,
                                              dist, leq, model)
            assert th_t == th_j
            np.testing.assert_array_equal(pr_t, pr_j)
    np.testing.assert_array_equal(tvn.exit_probs(4, ratio, dist, model),
                                  jvn.exit_probs(4, ratio, dist, model))


def test_exit_controller_matches_jax():
    ctrls = [m.ExitController(exit_id_list=[1, 3, 5], steps_per_stage=2,
                              max_layer=6) for m in (jvn, tvn)]
    arms = np.random.RandomState(23).randn(3, 6)
    trace = []
    for c in ctrls:
        c.set_threshold_values([0.1, 0.2, 0.3])
        out = [c.effective_max, dict(c.thresholds)]
        for t, (e, d) in enumerate([(1, 0.2), (3, 0.1), (5, 9.0), (2, 0.0)]):
            c.set_timestep(t)
            out += [c.reuse_stage_exit(), c.should_exit(e, d), c.cur_exit_id]
        for a in arms:
            c.record_action((a, a[:1]))
        ens = c.get_ensemble_action()
        out += [c.prev_action.tolist(), ens[0].tolist(), ens[1].tolist()]
        c.reset_episode()
        out += [c.cur_exit_id, c.prev_action, c.action_list]
        trace.append(out)
    assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# calibrate end to end, the sidecar
# ---------------------------------------------------------------------------


def jax_batch_draws(jcfg, num_batches, streamed, probs=None):
    """Each batch's draws in jax calibrate: the key chain of
    generate_calibration_values (rng -> rng, prep, fwd) and forward_train's
    split of fwd."""
    rng = jax.random.PRNGKey(0)
    exit_ids = jnp.asarray(jcfg.all_exit_ids())
    w, n_exit = jcfg.window_size, jcfg.num_exits
    draws = []
    for _ in range(num_batches):
        rng, _, fwd = jax.random.split(rng, 3)
        rngs = jax.random.split(fwd, 8)
        lay1 = exit_ids[jax.random.randint(rngs[2], (2, w), 0, n_exit)]
        d = {"rand_layer_ids": torch.as_tensor(np.array(lay1))}
        if streamed:
            d["commit_exits"] = jax_commit_exits(
                fwd, n_exit, tvn.streamed_probs(n_exit, probs), 2 * w)
        draws.append(d)
    return draws


@pytest.mark.parametrize("streamed", [False, True])
def test_calibrate_matches_jax(tiny, streamed):
    jcfg, tcfg, tok, jp, tp = tiny
    batches = debug_batches(jcfg, tok, num=2, seed=8)
    ratio = 0.5
    th_j, vals_j = jcal.calibrate(jp, jcfg, batches, ratio, max_batches=2,
                                  streamed=streamed)
    probs = (tcal.streamed_sample_probs(tcfg, ratio, None, "exp",
                                        "mpt_dolly_3b") if streamed else None)
    th_t, vals_t = tcal.calibrate(tp, tcfg, batches, ratio, max_batches=2,
                                  streamed=streamed,
                                  draws=jax_batch_draws(jcfg, 2, streamed,
                                                        probs))
    assert vals_t.dtype == np.float32 and vals_t.shape == vals_j.shape
    assert rel_l2(vals_t, vals_j) <= REL_L2
    assert th_t.keys() == th_j.keys()
    np.testing.assert_allclose([th_t[e] for e in th_t],
                               [th_j[e] for e in th_j], rtol=REL_L2)


def test_calibration_sidecar_round_trips_across_packages(tmp_path):
    vals = np.random.RandomState(24).rand(2, 9).astype(np.float32)
    info = {"exit_ratio": 0.5, "calib_warm": 0, "calib_streamed": True}
    path = str(tmp_path / "run.ckpt")
    assert tckpt.load_calibration_values(path) is None
    assert tckpt.load_calibration_info(path) == {}
    tckpt.save_calibration_values(path, vals.astype(np.float64), info)
    for mod in (tckpt, jckpt):
        got = mod.load_calibration_values(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, vals)
        assert mod.load_calibration_info(path) == info
    other = str(tmp_path / "jax_side")
    jckpt.save_calibration_values(other, vals, {"exit_ratio": 1.0})
    np.testing.assert_array_equal(tckpt.load_calibration_values(other), vals)
    assert tckpt.load_calibration_info(other) == {"exit_ratio": 1.0}


def test_delta_fn_runs_under_inference_mode(tiny):
    """No autograd graph is kept for the calibration pass."""
    jcfg, tcfg, tok, _, tp = tiny
    batch = debug_batches(jcfg, tok, num=1)[0]
    fn = tcal.make_delta_fn(tcfg)
    d = fn(tp, *tcal.batch_inputs(batch, tcfg, torch.device("cpu")),
           torch.Generator().manual_seed(0))
    assert d.shape == (tcfg.num_exits, 2 * 2) and not d.requires_grad
    assert bool(torch.isfinite(d).all())
