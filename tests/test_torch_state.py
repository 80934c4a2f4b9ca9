"""PyTorch port, the proprio-state and multi-step variants against the JAX
package on the CPU: the heads' state embedding (``embed_state``,
``head_forward`` / ``head_step`` / ``head_feature_step`` with state), the
calibration deltas and ``calibrate`` with state (the folded, the streamed
and the window-folded warm-prefix regimes), and serving per-frame
variants through ``ScanDeerPolicy`` (B=1, B=4 with per-stream threshold
rows, int8), ``DeerPolicy`` and ``BatchedDeerPolicy``.

Weights: the shared JAX init of tests/test_torch_fusion.py, bridged.
Exit layers must be equal; actions and carries within 2e-4
(tests/test_torch_scan_policy.py's), head outputs within 1e-5, calibration
values within 1e-4 relative L2 and thresholds within 1e-4 relative
(tests/test_torch_calibrate.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.data.debug_data import DebugBatcher
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.eval.batched_policy import \
    BatchedDeerPolicy as JaxBatchedPolicy
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeerPolicy
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScanPolicy
from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.models import value_net as jvn
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models import action_head as thead
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import value_net as tvn
from deer_vla_tpu_torch.models.value_net import ExitController
from test_torch_calibrate import jax_commit_exits
from test_torch_fusion import (frames, jx, pair, rel_l2, text, tt,
                               variant_params)

TOL = dict(rtol=2e-4, atol=2e-4)
HEAD_TOL = dict(rtol=1e-5, atol=1e-5)
REL_L2 = 1e-4
# B=1 thresholds: the first exit always, never, and at a value between
THRESHOLDS = [[1e8, 1e8], [-1.0, 1e8], [1e-3, 1e8]]
# the serving variant of the per-frame paths: a proprio token and head
# embedding, a second resampler and the gripper camera at its native size
SERVE = {"use_state": True, "sep_resampler": True, "gripper_res": 14}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def head_inputs(r, b, w, cfg):
    feat = r.randn(b * w, cfg.text_len, cfg.head.in_features).astype(
        np.float32)
    st = r.randn(b * w, 1, 1, cfg.state_dim).astype(np.float32)
    st[..., -1] = np.sign(st[..., -1])
    return feat, st


# ---------------------------------------------------------------------------
# the state head
# ---------------------------------------------------------------------------


def test_state_heads_match_jax():
    """embed_state, the full-window head (every step and the last), the
    streamed step and the streamed LSTM features, with state; a gripper
    state whose index falls outside the embedding gives NaN as jnp.take
    does, one just below it counts from the end."""
    jcfg, tcfg = pair({"use_state": True, "k": 2})
    hp = variant_params(jcfg)["extra_exit"]
    jh, th = jax.tree.map(jnp.asarray, hp), to_torch(hp, "cpu")
    r = np.random.RandomState(3)
    w = jcfg.window_size
    feat, st = head_inputs(r, 2, w, jcfg)
    for last in (False, True):
        got = thead.head_forward(th, *tt(feat), tcfg.head,
                                 torch.as_tensor(st), last_action=last)
        want = jhead.head_forward(jh, jnp.asarray(feat), jcfg.head,
                                  jnp.asarray(st), last_action=last)
        assert got.actions.shape == (2, 1 if last else w, 12)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **HEAD_TOL)
    step_st = st[:2]
    got, gc = thead.head_step(th, *tt(feat[:2]), None, tcfg.head,
                              torch.as_tensor(step_st))
    want, jc = jhead.head_step(jh, jnp.asarray(feat[:2]), None, jcfg.head,
                               jnp.asarray(step_st))
    for a, b in zip(list(got) + list(gc), list(want) + list(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **HEAD_TOL)
    y_t, _ = thead.head_feature_step(th, *tt(feat[:2]), gc, tcfg.head,
                                     torch.as_tensor(step_st))
    y_j, _ = jhead.head_feature_step(jh, jnp.asarray(feat[:2]), jc,
                                     jcfg.head, jnp.asarray(step_st))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **HEAD_TOL)
    edge = np.zeros((4, 15), np.float32)
    edge[:, -1] = [-2.0, -3.5, 3.0, 0.9]  # indices 0, -1, 2, 0
    e_t = thead.embed_state(th, torch.as_tensor(edge)).numpy()
    e_j = np.asarray(jhead.embed_state(jh, jnp.asarray(edge), jcfg.head))
    np.testing.assert_array_equal(np.isnan(e_t), np.isnan(e_j))
    assert np.isnan(e_t[2]).all() and not np.isnan(e_t[[0, 1, 3]]).any()
    np.testing.assert_allclose(e_t[[0, 1, 3]], e_j[[0, 1, 3]], **HEAD_TOL)


# ---------------------------------------------------------------------------
# calibration deltas with state
# ---------------------------------------------------------------------------


def features(cfg, b, seed):
    """(hidden (L, B*W, S, D), sampling-1 features (B*W, S, D), state)."""
    r = np.random.RandomState(seed)
    w = 1 if cfg.fusion_mode == "vit_concat" else cfg.window_size
    shape = (b * w, cfg.text_len, cfg.head.in_features)
    hidden = r.randn(cfg.n_layers, *shape).astype(np.float32)
    rand = r.randn(*shape).astype(np.float32)
    _, st = head_inputs(r, b, cfg.window_size, cfg)
    return hidden, rand, st


@pytest.mark.parametrize("regime", ["folded", "streamed", "vit_concat_warm"])
def test_exit_deltas_with_state_match_jax(regime):
    """Each regime's deltas with the state head: per frame, the streamed
    step's state, and under 'vit_concat' each trajectory's last row, the
    warm prefix with the same permutations (JAX's)."""
    mode = "vit_concat" if regime == "vit_concat_warm" else "post"
    jcfg, tcfg = pair({"use_state": True}, fusion_mode=mode)
    hp = variant_params(jcfg)["extra_exit"]
    jh, th = jax.tree.map(jnp.asarray, hp), to_torch(hp, "cpu")
    hidden, rand, st = features(jcfg, 3, seed=5)
    exits = list(jcfg.all_exit_ids())
    rng = jax.random.PRNGKey(9)
    if regime == "streamed":
        probs = tvn.streamed_probs(len(exits))
        want = jvn.generate_streamed_exit_deltas(
            jh, *jx(hidden), jcfg, exits, rng=rng, state=jnp.asarray(st))
        got = tvn.generate_streamed_exit_deltas(
            th, *tt(hidden), tcfg, exits, state=torch.as_tensor(st),
            commit_exits=jax_commit_exits(rng, len(exits), probs,
                                          2 * jcfg.window_size))
    else:
        warm = 3 if regime == "vit_concat_warm" else 0
        want = jvn.generate_exit_deltas(jh, *jx(hidden, rand), jcfg, exits,
                                        warm_prefix=warm, rng=rng,
                                        state=jnp.asarray(st))
        perms = None
        if warm:
            perms = torch.as_tensor(np.stack([np.asarray(
                jax.random.permutation(jax.random.fold_in(rng, k), 3))
                for k in range(warm)], axis=1))
        got = tvn.generate_exit_deltas(
            th, *tt(hidden, rand), tcfg, exits, warm_prefix=warm,
            state=torch.as_tensor(st), warm_perms=perms)
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), np.asarray(want)) <= REL_L2


def calib_draws(jcfg, num_batches, streamed, warm, probs=None):
    """Each batch's draws in JAX's calibrate (its key chain): the
    sampling-1 layers, the streamed commits, the warm-prefix
    permutations."""
    rng = jax.random.PRNGKey(0)
    exit_ids = jnp.asarray(jcfg.all_exit_ids())
    w = 1 if jcfg.fusion_mode == "vit_concat" else jcfg.window_size
    n_exit = jcfg.num_exits
    draws = []
    for _ in range(num_batches):
        rng, _, fwd = jax.random.split(rng, 3)
        rngs = jax.random.split(fwd, 8)
        lay1 = exit_ids[jax.random.randint(rngs[2], (2, w), 0, n_exit)]
        d = {"rand_layer_ids": torch.as_tensor(np.array(lay1))}
        if streamed:
            d["commit_exits"] = jax_commit_exits(
                fwd, n_exit, tvn.streamed_probs(n_exit, probs),
                2 * jcfg.window_size)
        if warm:
            d["warm_perms"] = torch.as_tensor(np.stack([np.asarray(
                jax.random.permutation(jax.random.fold_in(fwd, k), 2))
                for k in range(warm)], axis=1))
        draws.append(d)
    return draws


@pytest.mark.parametrize("case", ["post_state_streamed",
                                  "vit_concat_state_warm"])
def test_calibrate_with_state_matches_jax(case):
    """``calibrate`` end to end on DebugBatcher batches with robot_obs:
    state rows (clipped to arm + gripper), per-window text under
    'vit_concat', and --calib_warm's warm prefix."""
    streamed = case == "post_state_streamed"
    warm = 0 if streamed else 2
    mode = "post" if streamed else "vit_concat"
    tok = HashTokenizer(vocab_size=128, max_length=8)
    jcfg, tcfg = (dataclasses.replace(c, media_token_id=tok.media_token_id)
                  for c in pair({"use_state": True}, fusion_mode=mode,
                                clip_state=True, state_dim=7))
    params = variant_params(dataclasses.replace(jcfg, state_dim=15))
    params["state_fc"] = {"w": params["state_fc"]["w"][:7],
                          "b": params["state_fc"]["b"]}
    hw = jcfg.vit.image_size
    batches = list(DebugBatcher(jcfg, tok, batch_size=2, num_batches=2,
                                img_hw=hw, grip_hw=hw, seed=8))
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, params), jcfg,
                                  batches, 0.5, max_batches=2,
                                  streamed=streamed, warm_prefix=warm)
    probs = (tcal.streamed_sample_probs(tcfg, 0.5, None, "exp",
                                        "mpt_dolly_3b") if streamed else None)
    th_t, vals_t = tcal.calibrate(
        to_torch(params, "cpu"), tcfg, batches, 0.5, max_batches=2,
        streamed=streamed, warm_prefix=warm,
        draws=calib_draws(jcfg, 2, streamed, warm, probs))
    assert vals_t.shape == vals_j.shape
    assert rel_l2(vals_t, vals_j) <= REL_L2
    assert th_t.keys() == th_j.keys()
    np.testing.assert_allclose([th_t[e] for e in th_t],
                               [th_j[e] for e in th_j], rtol=REL_L2)


# ---------------------------------------------------------------------------
# serving the per-frame variants
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve():
    """The state model (SERVE) in both packages' scan engines, bf16 off
    (fp32), plain and int8."""
    jcfg, tcfg = pair(SERVE)
    p = variant_params(jcfg)
    jp = jax.tree.map(jnp.asarray, p)
    pols = {q: (JaxScanPolicy(jp, jcfg, quantize=q),
                ScanDeerPolicy(p, tcfg, quantize=q, device="cpu"))
            for q in (None, "int8")}
    return jcfg, tcfg, p, pols


def serve_obs(cfg, b, seed):
    img, grip, st = frames(cfg, b, seed)
    ids, mask = text(cfg, b, seed + 50, media_at=2)
    return img, grip, ids, mask, st


def same_carry(ct, cj):
    for t, j in zip(ct, cj):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_scan_step_with_state_matches_jax(serve, quantize):
    jcfg, tcfg, _, pols = serve
    jpol, tpol = pols[quantize]
    seen = set()
    for th in THRESHOLDS:
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for t in range(2):
            img, grip, ids, mask, st = serve_obs(jcfg, 1, seed=t)
            a_j = jpol.step(*jx(img, grip, ids, mask), state=jnp.asarray(st))
            a_t = tpol.step(img, grip, ids, mask, state=st)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(a_t, np.asarray(a_j), **TOL)
            same_carry(tpol.carry, jpol.carry)
            seen.add(tpol.last_exit_layer)
    assert seen == set(jcfg.all_exit_ids())


def test_scan_step_batch_with_state_per_stream_rows_match_jax(serve):
    jcfg, tcfg, _, pols = serve
    jpol, tpol = pols[None]
    rows = THRESHOLDS + [[1e-4, 1e8]]
    for p in (jpol, tpol):
        p.set_thresholds_batch(rows)
        p.reset()
    for t in range(2):
        img, grip, ids, mask, st = serve_obs(jcfg, 4, seed=10 + t)
        acts_j, ex_j = jpol.step_batch(*jx(img, grip, ids, mask),
                                       state=jnp.asarray(st))
        acts_t, ex_t = tpol.step_batch(img, grip, ids, mask, state=st)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
        same_carry(tpol.carry, jpol.carry)
    with pytest.raises(ValueError, match="state rows"):
        tpol.step(img[:1], grip[:1], ids[:1], mask[:1], state=st)


def controllers(cfg, th):
    from deer_vla_tpu.models.value_net import ExitController as JaxCtrl
    out = []
    for cls in (JaxCtrl, ExitController):
        c = cls(exit_id_list=list(cfg.all_exit_ids()),
                max_layer=cfg.n_layers)
        c.set_threshold_values(th)
        out.append(c)
    return out


def test_deer_policy_with_state_matches_jax(serve):
    """The host-bucketed engine with the state model, the thresholds of
    each row of THRESHOLDS in turn, the carry threaded; the port's fixed
    exit (``forward_fixed_exit``) gives its last step's action."""
    jcfg, tcfg, p, _ = serve
    jc, tc = controllers(tcfg, THRESHOLDS[0])
    jpol = JaxDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg, controller=jc)
    tpol = DeerPolicy(p, tcfg, controller=tc, device="cpu")
    seen = set()
    for t, th in enumerate(THRESHOLDS * 2):
        jc.set_threshold_values(th)
        tc.set_threshold_values(th)
        for pol in (jpol, tpol):
            pol.set_timestep(t)
        img, grip, ids, mask, st = serve_obs(jcfg, 1, seed=t)
        a_j = jpol.step(*jx(img, grip, ids, mask), state=jnp.asarray(st))
        a_t = tpol.step(img, grip, ids, mask, state=st)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        np.testing.assert_allclose(a_t, np.asarray(a_j), **TOL)
        same_carry(tpol.carry, jpol.carry)
        seen.add(tpol.last_exit_layer)
    assert seen == set(jcfg.all_exit_ids())
    fixed = DeerPolicy(p, tcfg, exit_id=1, device="cpu")
    img, grip, ids, mask, st = serve_obs(jcfg, 1, seed=7)
    a = fixed.step(img, grip, ids, mask, state=st)
    out, _ = tflam.forward_fixed_exit(
        to_torch(p, "cpu"), *tt(img, ids.astype(np.int64), mask), tcfg, 1,
        torch.as_tensor(grip), torch.as_tensor(st))
    np.testing.assert_allclose(a[:6], out.actions[0, 0].numpy(), **TOL)


@pytest.mark.parametrize("changes", [{"fusion_mode": "pre", "k": 3},
                                     {"fusion_mode": "two_way"}])
def test_multi_step_and_fusion_serving_matches_jax(changes):
    """'pre' with a 3-step plan and 'two_way' through the scan engine at
    B=1 ((k, 7) plans) and through BatchedDeerPolicy at B=3, which takes no
    state, as in JAX."""
    jcfg, tcfg = pair(changes)
    p = variant_params(jcfg)
    jp = jax.tree.map(jnp.asarray, p)
    k = jcfg.head.multi_step_action
    jpol, tpol = (JaxScanPolicy(jp, jcfg), ScanDeerPolicy(p, tcfg,
                                                          device="cpu"))
    for p_ in (jpol, tpol):
        p_.set_thresholds([1e-3, 1e8])
    for t in range(2):
        img, grip, ids, mask, _ = serve_obs(jcfg, 1, seed=20 + t)
        a_j = np.asarray(jpol.step(*jx(img, grip, ids, mask)))
        a_t = tpol.step(img, grip, ids, mask)
        assert a_t.shape == ((k, 7) if k > 1 else (7,))
        assert tpol.last_exit_layer == jpol.last_exit_layer
        np.testing.assert_allclose(a_t, a_j, **TOL)
    jb = JaxBatchedPolicy(jp, jcfg, batch=3, thresholds=[1e-3, 1e8])
    tb = BatchedDeerPolicy(p, tcfg, batch=3, thresholds=[1e-3, 1e8],
                           device="cpu")
    for t in range(2):
        img, grip, ids, mask, _ = serve_obs(jcfg, 3, seed=30 + t)
        acts_j, ex_j = jb.step(*jx(img, grip, ids, mask))
        acts_t, ex_t = tb.step(img, grip, ids, mask)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
