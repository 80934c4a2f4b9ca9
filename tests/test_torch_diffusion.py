"""PyTorch port, the diffusion action head against the JAX package on the
CPU: the normalizer (bit for bit), the U-Net's pieces (the transposed
convolution's weight layout and the strided convolution's one-sided 'SAME'
padding, both with weights that are not symmetric), the U-Net, the DDPM
and DDIM samplers and the losses with JAX's draws fed in, the serving
engines (the exit criterion on the conditioning features), calibration,
the train step, ``DiffusionSamplerPolicy`` and ``BatchedDiffusionSampler``
(JAX's draws fed, lane locality, a single lane equal to the sequential
wrapper), the normalizer's fit and checkpoint, and the CLIs.

Sizes: deer_tiny with JAX's tiny diffusion choices (5 timesteps, horizon
4, 2 observation steps, down dims (8, 16); tests/test_head_types.py).
Weights: the shared JAX init of tests/test_torch_fusion.py's backbone
with feature-only LSTM heads, a U-Net and a normalizer drawn by JAX,
bridged.  Tolerances: normalizer bit-equal; the pieces within 1e-5; the
U-Net within 1e-5 relative L2; the plans within 1e-4 relative L2 (the
U-Net's fp32 rounding through 1 / sqrt(alpha_bar) at the chain's start);
the losses within 1e-5 relative and gradients within 1e-4 relative L2
(tests/test_torch_train.py's), on a U-Net of down dims (16, 32) over a
horizon of 8 (``DIFF_GRAD``: at the tiny choices both packages' fp32
gradients are further than that from a float64 one); the engines' exits
equal and features and carries within 2e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.eval import diffusion_policy as jdp
from deer_vla_tpu.eval import scan_policy as jscan
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeerPolicy
from deer_vla_tpu.models import diffusion as jd
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import heads as jheads
from deer_vla_tpu.models import normalizer as jnorm
from deer_vla_tpu.train import losses as jloss
from deer_vla_tpu.train import trainer as jtrainer
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.data.debug_data import DebugBatcher
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.eval import diffusion_policy as tdp
from deer_vla_tpu_torch.eval import scan_policy as tscan
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.models import diffusion as td
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import heads as theads
from deer_vla_tpu_torch.models import normalizer as tnorm
from deer_vla_tpu_torch.models.flamingo import TrainOutputs
from deer_vla_tpu_torch.train import losses as tloss
from deer_vla_tpu_torch.train import trainer as ttrainer
from deer_vla_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_fusion import full_params, jx, rel_l2
from test_torch_heads import (check_grads, configs, jax_loss_and_grads,
                              obs)
from test_torch_state import calib_draws, controllers, same_carry
from test_torch_train import jax_flat, make_batch, torch_flat

PIECE_ATOL = 1e-5
UNET_REL_L2 = 1e-5
PLAN_REL_L2 = 1e-4
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
TOL = dict(rtol=2e-4, atol=2e-4)
CALIB_REL_L2 = 1e-4
# JAX's tiny diffusion choices (tests/test_head_types.py:17-24)
DIFF = {"head_type": "diffusion", "diff_timesteps": 5, "diff_horizon": 4,
        "n_obs_steps": 2, "diff_down_dims": (8, 16)}
# the gradient tests' U-Net: at the tiny choices its GroupNorms normalize
# groups of 2 to 4 values, and the U-Net's fp32 gradient under the
# multi-exit loss is 1.9e-3 (JAX) and 5e-4 (the port) from a float64 one;
# with (16, 32) over a horizon of 8 both are within 1.1e-6 of it
DIFF_GRAD = dict(DIFF, diff_horizon=8, diff_down_dims=(16, 32))
# per-exit threshold rows on the feature deltas
ROWS = [[1e8, 1e8], [-1.0, 1e8], [0.1, 1e8], [0.3, 1e8]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def diff_params(jcfg, seed=80):
    """The shared backbone, feature-only LSTM heads, a U-Net and a
    normalizer that is not the identity, drawn by JAX."""
    full = full_params()
    p = {k: full[k] for k in ("vit", "perceiver", "decoder")}

    init = jax.jit(lambda k: jheads.init_any_head(k, jcfg))

    def head(i):
        return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed + i)))

    p["lm_head"], p["extra_exit"] = head(0), head(1)
    p["lm_exits"] = {k: head(2 + i) for i, k in enumerate(full["lm_exits"])}
    r = np.random.RandomState(seed)
    p["diffusion"] = {
        "unet": jax.tree.map(np.asarray, jd.init_unet(
            jax.random.PRNGKey(seed + 9), jheads.diffusion_head_config(jcfg))),
        "norm": {"scale": r.uniform(0.5, 2.0, 7).astype(np.float32),
                 "offset": r.uniform(-0.3, 0.3, 7).astype(np.float32)}}
    return p


def dcfgs(cond_predict_scale=False):
    jcfg, tcfg = configs(DIFF)
    j = dataclasses.replace(jheads.diffusion_head_config(jcfg),
                            cond_predict_scale=cond_predict_scale)
    t = dataclasses.replace(theads.diffusion_head_config(tcfg),
                            cond_predict_scale=cond_predict_scale)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def jax_noise(rng, n_steps, shape):
    """The draws of JAX's samplers from ``rng``: the split chain's initial
    normal, then one a step."""
    rng, k0 = jax.random.split(rng)
    out = [np.asarray(jax.random.normal(k0, shape))]
    for _ in range(n_steps):
        rng, kn = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(kn, shape)))
    return np.stack(out)


# ---------------------------------------------------------------------------
# the normalizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,fit_offset", [("limits", True),
                                             ("limits", False),
                                             ("gaussian", True),
                                             ("gaussian", False)])
def test_normalizer_is_bit_equal(mode, fit_offset):
    """Both modes with and without an offset, a constant column and one of
    range below range_eps among them; LinearNormalizer's fields and its
    state dict."""
    r = np.random.RandomState(1)
    data = (r.randn(40, 3, 7) * [1, 2, 3, 4, 5, 6, 7]).astype(np.float32)
    data[..., 2] = 0.25
    data[..., 4] = 1.0 + 1e-5 * r.rand(40, 3)
    want = jnorm.SingleFieldLinearNormalizer().fit(
        data, mode=mode, fit_offset=fit_offset)
    got = tnorm.SingleFieldLinearNormalizer().fit(
        data, mode=mode, fit_offset=fit_offset)
    for k in ("scale", "offset"):
        np.testing.assert_array_equal(got.params[k], want.params[k])
    x = r.randn(5, 7).astype(np.float32)
    np.testing.assert_array_equal(got.normalize(x), want.normalize(x))
    np.testing.assert_array_equal(got.unnormalize(x), want.unnormalize(x))
    jl = jnorm.LinearNormalizer().fit({"action": data, "state": data[..., :3]},
                                      mode=mode, fit_offset=fit_offset)
    tl = tnorm.LinearNormalizer().fit({"action": data, "state": data[..., :3]},
                                      mode=mode, fit_offset=fit_offset)
    back = tnorm.LinearNormalizer().load_state_dict(tl.state_dict())
    for key in ("action", "state"):
        np.testing.assert_array_equal(back.normalize(x[:, :3], key)
                                      if key == "state" else
                                      back.normalize(x, key),
                                      jl.normalize(x[:, :3], key)
                                      if key == "state" else
                                      jl.normalize(x, key))


# ---------------------------------------------------------------------------
# the U-Net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [4, 7, 8, 16])
def test_conv_layouts_match_jax(length):
    """The upsampling conv reads JAX's square (c, c, 4) weight as
    ``lax.conv_transpose`` does, and the strided conv pads XLA's 'SAME'
    way (one step on the right at an even length): with weights that are
    not symmetric, torch's own layouts give other numbers."""
    r = np.random.RandomState(length)
    x = r.randn(2, 5, length).astype(np.float32)
    up = {"w": r.randn(5, 5, 4).astype(np.float32),
          "b": r.randn(5).astype(np.float32)}
    down = {"w": r.randn(5, 5, 3).astype(np.float32),
            "b": r.randn(5).astype(np.float32)}
    assert not np.allclose(up["w"], up["w"].transpose(1, 0, 2))
    tx = torch.as_tensor(x)
    for p, jfn, tfn, naive in (
            (up, lambda p_, x_: jd.conv1d_transpose(p_, x_),
             td.conv1d_transpose,
             lambda p_, x_: F.conv_transpose1d(x_, p_["w"], p_["b"],
                                               stride=2, padding=1)),
            (down, lambda p_, x_: jd.conv1d(p_, x_, stride=2),
             lambda p_, x_: td.conv1d(p_, x_, stride=2),
             lambda p_, x_: F.conv1d(x_, p_["w"], p_["b"], stride=2,
                                     padding=1))):
        want = np.asarray(jfn(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
        tp = to_torch(p, "cpu")
        got = tfn(tp, tx).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=PIECE_ATOL)
        if p is up or length % 2 == 0:
            assert np.abs(naive(tp, tx).numpy() - want).max() > 1e-2


def test_unet_pieces_match_jax():
    r = np.random.RandomState(2)
    x = (r.randn(3, 16, 6) * 4).astype(np.float32)
    np.testing.assert_allclose(td.mish(torch.as_tensor(x)).numpy(),
                               np.asarray(jd.mish(jnp.asarray(x))), rtol=0,
                               atol=PIECE_ATOL)
    gn = {"scale": r.randn(16).astype(np.float32),
          "bias": r.randn(16).astype(np.float32)}
    np.testing.assert_allclose(
        td.group_norm(to_torch(gn, "cpu"), torch.as_tensor(x), 8).numpy(),
        np.asarray(jd.group_norm(jax.tree.map(jnp.asarray, gn),
                                 jnp.asarray(x), 8)), rtol=0, atol=PIECE_ATOL)
    t = np.array([0, 3, 149])
    np.testing.assert_allclose(
        td.sinusoidal_pos_emb(torch.as_tensor(t), 32).numpy(),
        np.asarray(jd.sinusoidal_pos_emb(jnp.asarray(t), 32)), rtol=0,
        atol=PIECE_ATOL)
    jc, tc = dcfgs()
    jb, tb = jd.ddpm_buffers(jc), td.ddpm_buffers(tc)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("cond_predict_scale", [False, True])
def test_unet_forward_matches_jax(cond_predict_scale):
    jc, tc = dcfgs(cond_predict_scale)
    p = jax.tree.map(np.asarray, jd.init_unet(jax.random.PRNGKey(3), jc))
    r = np.random.RandomState(4)
    x = r.randn(3, jc.horizon, 7).astype(np.float32)
    t = np.array([0, 2, 4])
    g = r.randn(3, jc.global_cond_dim).astype(np.float32)
    want = np.asarray(jax.jit(lambda p_, x_, t_, g_: jd.unet_forward(
        p_, x_, t_, jc, g_))(jax.tree.map(jnp.asarray, p), *jx(x, t, g)))
    got = td.unet_forward(to_torch(p, "cpu"), torch.as_tensor(x),
                          torch.as_tensor(t), tc, torch.as_tensor(g)).numpy()
    assert rel_l2(got, want) <= UNET_REL_L2
    tp = td.init_unet(torch.Generator().manual_seed(0), tc)
    assert sorted(torch_flat(tp)) == sorted(jax_flat(p))


def test_schedule_terms_match_jax():
    jc, tc = dcfgs()
    jb, tb = jd.ddpm_buffers(jc), td.ddpm_buffers(tc)
    r = np.random.RandomState(5)
    x0, xt, eps = (r.randn(3, 4, 7).astype(np.float32) for _ in range(3))
    t = np.array([4, 0, 2])
    for fj, ft in (
            (lambda: jd.q_sample(jb, *jx(x0), jnp.asarray(t), jnp.asarray(eps)),
             lambda: td.q_sample(tb, torch.as_tensor(x0), torch.as_tensor(t),
                                 torch.as_tensor(eps))),
            (lambda: jd.predict_start_from_noise(jb, jnp.asarray(xt),
                                                 jnp.asarray(t),
                                                 jnp.asarray(eps), jc),
             lambda: td.predict_start_from_noise(tb, torch.as_tensor(xt),
                                                 torch.as_tensor(t),
                                                 torch.as_tensor(eps), tc)),
            (lambda: jd.q_posterior(jb, *jx(x0, xt), jnp.asarray(t))[0],
             lambda: td.q_posterior(tb, *map(torch.as_tensor, (x0, xt)),
                                    torch.as_tensor(t))[0])):
        np.testing.assert_allclose(ft().numpy(), np.asarray(fj()),
                                   rtol=PIECE_ATOL, atol=PIECE_ATOL)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim3", "ddim3_eta0.5"])
def test_samplers_match_jax_with_its_draws(sampler):
    """The full DDPM chain (its 0.5-scaled noise, none at t = 0) and DDIM
    subsequences (collapsing to x0 at t_prev = -1), the history rows
    inpainted after every step, on JAX's split-chain draws."""
    jc, tc = dcfgs()
    p = jax.tree.map(np.asarray, jd.init_unet(jax.random.PRNGKey(6), jc))
    r = np.random.RandomState(7)
    b = 2
    cond = np.zeros((b, jc.horizon, 7), np.float32)
    cond[:, :1] = r.randn(b, 1, 7)
    mask = np.zeros(cond.shape, bool)
    mask[:, :1] = True
    g = r.randn(b, jc.global_cond_dim).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p, "cpu")
    args = (jnp.asarray(cond), jnp.asarray(mask), jc, jnp.asarray(g))
    targs = (torch.as_tensor(cond), torch.as_tensor(mask), tc,
             torch.as_tensor(g))
    buf, tbuf = jd.ddpm_buffers(jc), td.ddpm_buffers(tc)
    if sampler == "ddpm":
        want = jd.conditional_sample(jp, buf, rng, *args)
        noise = jax_noise(rng, jc.n_timesteps, cond.shape)
        got = td.conditional_sample(tp, tbuf, *targs,
                                    noise=torch.as_tensor(noise))
    else:
        eta = 0.5 if "eta" in sampler else 0.0
        want = jd.conditional_sample_ddim(jp, buf, rng, *args, steps=3,
                                          eta=eta)
        assert td.sampler_steps(tc, 3) == 3
        noise = jax_noise(rng, 3, cond.shape)
        got = td.conditional_sample_ddim(tp, tbuf, *targs,
                                         noise=torch.as_tensor(noise),
                                         steps=3, eta=eta)
    assert rel_l2(got.numpy(), want) <= PLAN_REL_L2
    np.testing.assert_array_equal(got.numpy()[:, :1], cond[:, :1])


def test_diffusion_loss_matches_jax():
    jc, tc = dcfgs()
    p = jax.tree.map(np.asarray, jd.init_unet(jax.random.PRNGKey(9), jc))
    r = np.random.RandomState(10)
    x = r.randn(3, jc.horizon, 7).astype(np.float32)
    g = r.randn(3, jc.global_cond_dim).astype(np.float32)
    mask = np.zeros(x.shape, bool)
    mask[:, :1] = True
    rng = jax.random.PRNGKey(11)
    want = float(jax.jit(lambda p_, x_, g_, m_: jd.diffusion_loss(
        p_, jd.ddpm_buffers(jc), rng, x_, jc, g_, m_))(
            jax.tree.map(jnp.asarray, p), *jx(x, g, mask)))
    rng_t, rng_n = jax.random.split(rng)
    t = np.asarray(jax.random.randint(rng_t, (3,), 0, jc.n_timesteps))
    noise = np.asarray(jax.random.normal(rng_n, x.shape))
    got = float(td.diffusion_loss(to_torch(p, "cpu"), td.ddpm_buffers(tc),
                                  torch.as_tensor(x), tc, torch.as_tensor(g),
                                  torch.as_tensor(mask),
                                  t=torch.as_tensor(t),
                                  noise=torch.as_tensor(noise)))
    assert abs(got - want) <= LOSS_REL * abs(want)


def test_multi_exit_diffusion_loss_and_gradients_match_jax():
    """One U-Net call over E*B rows, the history rows clamped, the loss on
    rows [hist, W), the normalizer without gradient: the loss and the
    gradients of the U-Net and of the exits' features (DIFF_GRAD)."""
    jcfg, tcfg = configs(DIFF_GRAD)
    p = diff_params(jcfg)["diffusion"]
    r = np.random.RandomState(12)
    b, w, hid = 2, jcfg.window_size, jcfg.head.hidden_size
    feats = [r.randn(b, w, hid).astype(np.float32) for _ in range(4)]
    labels = np.clip(r.randn(b, w, 7), -1, 1).astype(np.float32)
    rng = jax.random.PRNGKey(13)

    def jloss_fn(dp, fs):
        out = jflam.TrainOutputs((fs[0],), fs[1], fs[2], fs[3], None, None,
                                 None)
        return jloss.multi_exit_diffusion_loss(out, jnp.asarray(labels), dp,
                                               jcfg, rng)[0]

    want, (gp, gf) = jax.jit(jax.value_and_grad(jloss_fn, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), [jnp.asarray(f) for f in feats])
    rng_t, rng_n = jax.random.split(rng)
    t = np.asarray(jax.random.randint(rng_t, (b,), 0, jcfg.diff_timesteps))
    noise = np.asarray(jax.random.normal(rng_n, (b, jcfg.diff_horizon, 7)))
    tp = to_torch(p, "cpu")
    leaves = list(torch_flat(tp["unet"]).values())
    norm = list(tp["norm"].values())
    fs = [torch.as_tensor(f).requires_grad_(True) for f in feats]
    for leaf in leaves + norm:
        leaf.requires_grad_(True)
    out = TrainOutputs((fs[0],), fs[1], fs[2], fs[3], None, None, None)
    got, metrics = tloss.multi_exit_diffusion_loss(
        out, torch.as_tensor(labels), tp, tcfg, t=torch.as_tensor(t),
        noise=torch.as_tensor(noise))
    assert abs(float(got.detach()) - float(want)) <= \
        LOSS_REL * abs(float(want))
    assert metrics["per_exit_loss"].shape == (4,)
    grads = torch.autograd.grad(got, leaves + fs + norm, allow_unused=True)
    assert grads[-1] is None and grads[-2] is None
    want_u = jax_flat(gp["unet"])
    got_u = dict(zip(torch_flat(tp["unet"]), grads[:len(leaves)]))
    for k, g in got_u.items():
        assert rel_l2(g.numpy(), want_u[k]) <= GRAD_REL_L2, k
    for g, j in zip(grads[len(leaves):len(leaves) + 4], gf):
        assert rel_l2(g.numpy(), np.asarray(j)) <= GRAD_REL_L2


def test_diffusion_train_step_matches_jax():
    """The joint step's DDPM loss and gradients (the LSTM feature heads,
    the U-Net, the backbone) with JAX's layer draws and its loss draws
    (``fold_in(rng, 99)``); the trained and the checkpointed leaves as
    JAX marks them (DIFF_GRAD)."""
    jcfg, tcfg = configs(DIFF_GRAD)
    p = diff_params(jcfg)
    batch = make_batch(jcfg, 2, seed=14)
    rng = jax.random.PRNGKey(15)
    loss, grads, draws = jax_loss_and_grads(jcfg, p, batch, rng)
    rng_t, rng_n = jax.random.split(jax.random.fold_in(rng, 99))
    draws["diff_t"] = torch.as_tensor(np.asarray(jax.random.randint(
        rng_t, (2,), 0, jcfg.diff_timesteps)))
    draws["diff_noise"] = torch.as_tensor(np.asarray(jax.random.normal(
        rng_n, (2, jcfg.diff_horizon, 7))))
    keys, got = check_grads(tcfg, p, batch, loss, grads, draws)
    assert any(k.startswith("diffusion/unet/") for k in keys)
    assert not any(k.startswith("diffusion/norm") for k in keys)
    jp, tp = jax.tree.map(jnp.asarray, p), to_torch(p, "cpu")
    for phase in ("joint", "exit_only"):
        want = jax_flat(jflam.trainable_mask(jp, jcfg, phase))
        assert {k: bool(v) for k, v in torch_flat(
            tflam.trainable_mask(tp, tcfg, phase)).items()} == \
            {k: bool(v) for k, v in want.items()}
    want = jax_flat(jflam.checkpoint_mask(jp, jcfg))
    assert {k: bool(v) for k, v in torch_flat(
        tflam.checkpoint_mask(tp, tcfg)).items()} == \
        {k: bool(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# serving and calibration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = configs(DIFF)
    p = diff_params(jcfg)
    return (jcfg, tcfg, p,
            jscan.ScanDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg),
            tscan.ScanDeerPolicy(p, tcfg, device="cpu"))


def test_diffusion_scan_engine_matches_jax(served):
    """B=1 over the threshold rows, then B=4 with a row a stream and a
    lane-local reset: the exits on the feature deltas, the chosen exit's
    (hidden,) feature and the LSTM carries."""
    jcfg, _, _, jpol, tpol = served
    seen = set()
    for th in ROWS:
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for t in range(2):
            args = obs(jcfg, 1, seed=t)
            f_j = jpol.step(*jx(*args))
            f_t = tpol.step(*args)
            assert f_t.shape == (jcfg.head.hidden_size,)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(f_t, np.asarray(f_j), **TOL)
            same_carry(tpol.carry, jpol.carry)
            seen.add(tpol.last_exit_layer)
    assert seen == set(jcfg.all_exit_ids())
    for p in (jpol, tpol):
        p.set_thresholds_batch(ROWS)
        p.reset()
    for t in range(2):
        args = obs(jcfg, 4, seed=10 + t)
        a_j, g_j, e_j = jpol.dispatch_batch(*jx(*args))
        a_t, g_t, e_t = tpol.run_batch(*args)
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
        assert not g_t.any()
        same_carry(tpol.carry, jpol.carry)
        reset = np.array([True, False, True, False])
        jpol.reset_streams(reset)
        tpol.reset_streams(reset)
        same_carry(tpol.carry, jpol.carry)


def test_diffusion_deer_policy_matches_jax(served):
    jcfg, tcfg, p, _, _ = served
    jc, tc = controllers(tcfg, ROWS[0])
    jpol = JaxDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg, controller=jc)
    tpol = DeerPolicy(p, tcfg, controller=tc, device="cpu")
    for t, th in enumerate(ROWS):
        jc.set_threshold_values(th)
        tc.set_threshold_values(th)
        args = obs(jcfg, 1, seed=30 + t)
        f_j = jpol.step(*jx(*args))
        f_t = tpol.step(*args)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        np.testing.assert_allclose(f_t, np.asarray(f_j), **TOL)
        same_carry(tpol.carry, jpol.carry)
    with pytest.raises(NotImplementedError, match="ensembling"):
        DeerPolicy(p, tcfg, controller=tc, use_action_ensemble=True,
                   device="cpu")


@pytest.mark.parametrize("streamed", [False, True])
def test_diffusion_calibration_matches_jax(served, streamed):
    """Calibration's deltas are feature deltas (1024-wide at deer_3b), in
    the folded regime (head_features over random-layer prefixes) and the
    streamed one (the LSTM feature carry)."""
    jcfg, tcfg, p, _, _ = served
    tok = HashTokenizer(vocab_size=128, max_length=8)
    hw = jcfg.vit.image_size
    batches = list(DebugBatcher(jcfg, tok, batch_size=2, num_batches=1,
                                img_hw=hw, grip_hw=hw, seed=9))
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, p), jcfg,
                                  batches, 0.5, max_batches=1,
                                  streamed=streamed)
    probs = (tcal.streamed_sample_probs(tcfg, 0.5, None, "exp",
                                        "mpt_dolly_3b") if streamed else None)
    th_t, vals_t = tcal.calibrate(
        to_torch(p, "cpu"), tcfg, batches, 0.5, max_batches=1,
        streamed=streamed, draws=calib_draws(jcfg, 1, streamed, 0, probs))
    assert vals_t.shape == vals_j.shape
    assert rel_l2(vals_t, vals_j) <= CALIB_REL_L2
    np.testing.assert_allclose([th_t[e] for e in sorted(th_t)],
                               [th_j[e] for e in sorted(th_j)],
                               rtol=CALIB_REL_L2)


# ---------------------------------------------------------------------------
# the plan samplers
# ---------------------------------------------------------------------------


def feed_jax_draws(sampler, seed, steps):
    """The port's plan draws replaced by JAX's: lane c's are the split
    chain of ``fold_in(PRNGKey(seed), c)``."""
    cfg = sampler.dcfg
    n = td.sampler_steps(cfg, steps)

    def noise(_, counts):
        return torch.as_tensor(np.concatenate([jax_noise(
            jax.random.fold_in(jax.random.PRNGKey(seed), int(c)), n,
            (1, cfg.horizon, 7)) for c in counts], axis=1))

    sampler.noise = noise


@pytest.mark.parametrize("steps", [0, 3])
def test_sampler_policy_matches_jax(served, steps):
    """DiffusionSamplerPolicy around each package's scan engine on JAX's
    draws: the zero history at reset, the inpainted history, the plan's
    supervised rows unnormalized with the gripper at +-1, three steps and
    a reset; DDPM and DDIM."""
    jcfg, tcfg, p, jscan_pol, tscan_pol = served
    for pol in (jscan_pol, tscan_pol):
        pol.set_thresholds([0.1, 1e8])
    jw = jdp.DiffusionSamplerPolicy(jscan_pol, jax.tree.map(jnp.asarray, p),
                                    seed=3, sample_steps=steps)
    tw = tdp.DiffusionSamplerPolicy(tscan_pol, p, seed=3, sample_steps=steps)
    feed_jax_draws(tw.sampler, 3, steps)
    for t in range(4):
        if t == 3:
            jw.reset()
            tw.reset()
        args = obs(jcfg, 1, seed=40 + t)
        want = np.asarray(jw.step(*jx(*args)))
        got = tw.step(*args)
        assert got.shape == (jcfg.window_size - 1, 7)
        assert tw.last_exit_layer == jw.last_exit_layer
        np.testing.assert_array_equal(got[:, 6], want[:, 6])
        assert rel_l2(got[:, :6], want[:, :6]) <= PLAN_REL_L2
    plans = tdp.DiffusionSamplerPolicy(tscan_pol, p, future_act_len=2,
                                       sample_steps=steps).step(*args)
    assert plans.shape == (2, 7) and set(plans[:, 6]) <= {-1.0, 1.0}


def test_batched_sampler_matches_jax_and_keeps_lanes_apart(served):
    """Two lanes against JAX's BatchedDiffusionSampler on its draws; then
    in the port alone: a lane's plan does not depend on the other lane,
    a single lane equals the sequential wrapper, a reset is lane-local,
    a parked lane keeps its counter and history, a copy starts fresh."""
    jcfg, tcfg, p, jscan_pol, tscan_pol = served
    for pol in (jscan_pol, tscan_pol):
        pol.set_thresholds([0.1, 1e8])
        pol.reset()
    jb = jdp.BatchedDiffusionSampler(jscan_pol, jax.tree.map(jnp.asarray, p),
                                     seed=5, sample_steps=3)
    tb = tdp.BatchedDiffusionSampler(tscan_pol, p, seed=5, sample_steps=3)
    feed_jax_draws(tb.sampler, 5, 3)
    for t in range(2):
        args = obs(jcfg, 2, seed=50 + t)
        want, ex_j = jb.step_batch(*jx(*args))
        got, ex_t = tb.step_batch(*args)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_array_equal(got[..., 6], np.asarray(want)[..., 6])
        assert rel_l2(got[..., :6], np.asarray(want)[..., :6]) <= PLAN_REL_L2

    def lanes(seed_b, active=None, b=2):
        pol = tscan.ScanDeerPolicy(p, tcfg, thresholds=[0.1, 1e8],
                                   device="cpu")
        s = tdp.BatchedDiffusionSampler(pol, p, seed=5, sample_steps=3)
        outs = []
        for t in range(2):
            img, grip, ids, mask = obs(jcfg, b, seed=60 + t)
            if b == 2:
                o = obs(jcfg, 2, seed=seed_b + t)
                img[1], grip[1], ids[1], mask[1] = (a[1] for a in o)
            outs.append(s.step_batch(img, grip, ids, mask,
                                     active=active)[0])
        return s, outs

    s1, a = lanes(70)
    _, b = lanes(80)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
    seq_pol = tscan.ScanDeerPolicy(p, tcfg, thresholds=[0.1, 1e8],
                                   device="cpu")
    seq = tdp.DiffusionSamplerPolicy(seq_pol, p, seed=5, sample_steps=3)
    _, single = lanes(0, b=1)
    for t in range(2):
        plan = seq.step(*(x[:1] for x in obs(jcfg, 1, seed=60 + t)))
        np.testing.assert_array_equal(single[t][0], plan)
    hist = s1._hist.copy()
    s1.reset_streams([False, True])
    np.testing.assert_array_equal(s1._hist[0], hist[0])
    assert not s1._hist[1].any()
    counts = s1._counts.copy()
    s1.step_batch(*obs(jcfg, 2, seed=90), active=np.array([True, False]))
    np.testing.assert_array_equal(s1._counts, counts + [1, 0])
    assert not s1._hist[1].any()
    import copy
    c = copy.copy(s1)
    assert c._hist is None and c.policy is not s1.policy
    assert c.cfg is s1.cfg


# ---------------------------------------------------------------------------
# the normalizer's fit, the checkpoint and the CLIs
# ---------------------------------------------------------------------------


def test_fit_action_normalizer_matches_jax():
    """'limits' over the loader's actions up to max_actions, written as an
    fp32 affine; a tree without the diffusion head is returned as is."""
    jcfg, tcfg = configs(DIFF)
    tok = HashTokenizer(vocab_size=128, max_length=8)
    batches = list(DebugBatcher(jcfg, tok, batch_size=2, num_batches=3,
                                img_hw=28, grip_hw=28, seed=3))
    p = diff_params(jcfg)
    want = jtrainer.fit_action_normalizer(jax.tree.map(jnp.asarray, p),
                                          batches, max_actions=10)
    tp = to_torch(p, "cpu")
    tp["diffusion"]["norm"] = {k: v.to(torch.bfloat16)
                               for k, v in tp["diffusion"]["norm"].items()}
    got = ttrainer.fit_action_normalizer(tp, batches, max_actions=10)
    for k in ("scale", "offset"):
        assert got["diffusion"]["norm"][k].dtype == torch.float32
        np.testing.assert_array_equal(got["diffusion"]["norm"][k].numpy(),
                                      np.asarray(want["diffusion"]["norm"][k]))
    plain = {"vit": tp["vit"]}
    assert ttrainer.fit_action_normalizer(plain, batches) is plain


def test_train_cli_then_eval_diffusion(tmp_path, capsys):
    """cli/train --head_type diffusion in bf16: the normalizer is fitted
    after the frozen leaves' cast (fp32), trained by no phase and saved in
    the delta checkpoint; cli/eval reloads it into the DDIM sampler's
    rollouts, sequential and over 2 lanes."""
    run = str(tmp_path / "run")
    argv = ["--debug", "--model", "tiny", "--num_joint_epochs", "1",
            "--num_exit_epochs", "0", "--batch_size_calvin", "2",
            "--run_name", run, "--joint_warmup_steps", "1",
            "--head_type", "diffusion",
            "--n_timesteps", "5", "--n_obs_steps", "3", "--diff_horizon",
            "8"]
    trainer = train_cli.main(argv, device="cpu")
    cfg = trainer.cfg
    assert (cfg.diff_timesteps, cfg.n_obs_steps, cfg.diff_horizon) == (5, 3, 8)
    norm = trainer.params["diffusion"]["norm"]
    assert norm["scale"].dtype == torch.float32
    assert not torch.equal(norm["scale"], torch.ones(7))
    with open(f"{run}/deer_0.json") as f:
        assert json.load(f)["config"]["head_type"] == "diffusion"
    params, _, _ = load_checkpoint(f"{run}/deer_0.ckpt",
                                   tflam.init_deer(cfg, device="cpu"))
    for k in ("scale", "offset"):
        assert torch.equal(params["diffusion"]["norm"][k], norm[k])
    capsys.readouterr()
    for lanes in ("1", "2"):
        report = eval_cli.main(
            ["--debug", "--evaluate_from_checkpoint", f"{run}/deer_0.ckpt",
             "--calib_batches", "1", "--num_sequences_override", "1",
             "--exit_ratio", "0.5", "--diff_steps", "2", "--lanes", lanes],
            device="cpu")
        assert report["env_steps"] > 0
        assert sum(report["success_exit_hist"]) + \
            sum(report["fail_exit_hist"]) > 0
    assert "loaded" in capsys.readouterr().out
