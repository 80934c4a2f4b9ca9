"""PyTorch port, the llama decoder (``models/llama.py``) and bc_llama (the
BCFlamingo config: llama LM, cross-attention every 4 layers, no internal
exit heads) against the JAX package on the CPU.

The modules (RMSNorm, interleaved RoPE in fp32 and bf16, a block) take the
same numpy-seeded inputs and JAX-initialized weights.  bc_llama keeps its
topology at test width (``test_torch_9b.shrink``: an 8-layer, d_model-128
llama with cross-attention on layers 3 and 7, the extra exit serving exits
[1, 3, 5, 7]).  The JAX ``ScanDeerPolicy`` does not serve a llama decoder
(its layer body calls the MPT block), so the port's ``ScanDeerPolicy`` is
held against the JAX ``DeerPolicy``: the same exit rule and commit, one
stream at a time (each stream its own carry and threshold row).

Tolerances: modules within 2e-5 (fp32; the RoPE tables differ from JAX's
by one fp32 ulp) and bit for bit in bf16; serving, exits equal and actions
and carries within 2e-4; calibration within 1e-4 relative L2 (thresholds
also 1e-7 absolute, ``test_torch_9b.DELTA_ATOL``); train steps
within tests/test_torch_train_steps.py's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeerPolicy
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import llama as jllama
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.eval.scan_policy import (ScanDeerPolicy,
                                                 build_scan_step)
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import llama as tllama
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.train import checkpoint as tckpt
from deer_vla_tpu_torch.train.trainer import Trainer
from test_torch_9b import (DELTA_ATOL, REL_L2, TOL, assert_masks_match_jax,
                           assert_train_steps_match, controllers, init_np,
                           port_config, same_carry, shrink, step_both,
                           tree_sig)
from test_torch_calibrate import (debug_batches, jax_batch_draws, make_media,
                                  make_text, switch_layer_ids)
from test_torch_scan_policy import obs
from torch_train_common import rel_l2, trainer_setup

MODULE_TOL = dict(rtol=2e-5, atol=2e-5)
# per-exit thresholds for exits [1, 3, 5, 7]: a row a stream, each taking
# another exit (these weights' deltas are 1e-4 to 1e-3 at every exit)
THRESHOLDS = [[1e8] * 4, [-1.0] * 3 + [1e8], [-1.0, 1e-2, -1.0, 1e8],
              [-1.0, -1.0, 1e-2, 1e8]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama():
    jcfg = shrink(jconfig.bc_llama(n_layers=8))
    return jcfg, port_config(jcfg), init_np(jcfg)


def rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    p = {"scale": rand((64,), 0)}
    x = rand((3, 5, 64), 1, 3.0)
    want = np.asarray(jllama.rmsnorm(
        {"scale": jnp.asarray(p["scale"])},
        jnp.asarray(x).astype(getattr(jnp, dtype))).astype(jnp.float32))
    got = tllama.rmsnorm({"scale": torch.as_tensor(p["scale"])},
                         torch.as_tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype, head_dim):
    """Interleaved pairs, the tables cast to x's dtype first: bf16 equal
    bit for bit, fp32 within the tables' one-ulp difference."""
    cj, sj = jllama.rope_tables(32, head_dim)
    ct, st = tllama.rope_tables(32, head_dim)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=1e-7)
    x = rand((2, 4, 32, head_dim), 2)
    want = np.asarray(jllama.apply_rope(
        jnp.asarray(x).astype(getattr(jnp, dtype)), cj, sj).astype(
            jnp.float32))
    got = tllama.apply_rope(torch.as_tensor(x).to(getattr(torch, dtype)),
                            ct, st).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **MODULE_TOL)
    # the half-split layout of other llama ports rotates other pairs
    half = np.concatenate([x[..., 0::2], x[..., 1::2]], -1)
    assert not np.allclose(tllama.apply_rope(
        torch.as_tensor(half), ct, st).numpy(), want, atol=1e-2)


def test_ffn_width_rounds_like_jax():
    assert tllama.ffn_width(4096) == 11008
    assert tllama.ffn_width(64) == tllama.ffn_width(96) == 256
    cfg = jconfig.bc_llama(n_layers=1, d_model=128).mpt
    blk = jllama.init_llama_block(jax.random.PRNGKey(0), cfg)
    assert blk["w_up"]["w"].shape == (128, tllama.ffn_width(128)) == \
        (128, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_block_matches_jax(llama, dtype):
    jcfg, tcfg, params = llama
    blk = params["decoder"]["blocks"][2]
    for norm in ("attn_norm", "mlp_norm"):  # non-trivial scales
        blk = dict(blk, **{norm: {"scale": 1.0 + rand((128,), 3) * 0.1}})
    ids, mask = make_text(jcfg, 3, seed=4)
    bias_j = jmpt.make_attn_bias(jnp.asarray(mask), jcfg.mpt, jnp.float32)
    bias_t = tmpt.make_attn_bias(torch.as_tensor(mask), tcfg.mpt,
                                 torch.float32)
    np.testing.assert_array_equal(bias_t.numpy(), np.asarray(bias_j))
    x = rand((3, jcfg.text_len, 128), 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jllama.llama_block_forward(
        jax.tree.map(jnp.asarray, blk), jnp.asarray(x).astype(jdt),
        bias_j.astype(jdt), jcfg.mpt).astype(jnp.float32))
    got = tllama.llama_block_forward(
        to_torch(blk, "cpu"), torch.as_tensor(x).to(tdt), bias_t.to(tdt),
        tcfg.mpt)
    assert got.dtype == tdt
    if dtype == "bfloat16":  # both round each product's output to bf16
        assert rel_l2(got.float().numpy(), want) <= 1e-2
    else:
        np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_bc_llama_preset():
    cfg = tconfig.bc_llama()
    assert cfg.to_json() == jconfig.bc_llama().to_json()
    assert (cfg.mpt.arch, cfg.mpt.alibi, cfg.multi_exit) == ("llama", False,
                                                             False)
    assert (cfg.n_layers, cfg.mpt.d_model, cfg.mpt.n_heads,
            cfg.mpt.vocab_size) == (32, 4096, 32, 32000)
    assert cfg.all_exit_ids() == tuple(range(1, 32, 2))
    assert [i for i in range(32) if cfg.has_xattn(i)] == \
        list(range(3, 32, 4))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_init_tree_matches_jax(llama):
    """Same keys, nesting, shapes and dtypes as the JAX init: the untied
    lm_head_w and norm_f beside wte, no lm_exits (multi_exit False)."""
    jcfg, tcfg, params = llama
    got = tflam.init_deer(tcfg, seed=0, device="cpu")
    assert tree_sig(got) == tree_sig(to_torch(params, "cpu"))
    dec = got["decoder"]
    assert dec["lm_head_w"]["w"].shape == (128, 128)
    assert got["lm_exits"] == {} and "extra_exit" in got
    assert sorted(dec["blocks"][0]) == sorted(params["decoder"]["blocks"][0])


def test_decoder_forward_matches_jax(llama):
    jcfg, tcfg, params = llama
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params, "cpu")
    ids, mask = make_text(jcfg, 3, seed=9)
    media = make_media(jcfg, 3, seed=10)
    hs_j, x_j = jmpt.decoder_forward(jp["decoder"], jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(media),
                                     jcfg)
    hs_t, x_t = tmpt.decoder_forward(tp["decoder"],
                                     torch.as_tensor(ids).long(),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(media), tcfg)
    assert hs_t.shape == (8, 3, jcfg.text_len, 128)
    assert rel_l2(hs_t.numpy(), np.asarray(hs_j)) <= REL_L2
    assert rel_l2(x_t.numpy(), np.asarray(x_j)) <= REL_L2


def test_forward_train_matches_jax(llama):
    """No internal exit heads: the final head and the extra exit twice, on
    JAX's layer draws."""
    jcfg, tcfg, params = llama
    r = np.random.RandomState(3)
    bsw = 2 * jcfg.window_size
    img = r.randn(bsw, 1, 1, 3, 28, 28).astype(np.float32)
    ids = r.randint(1, jcfg.media_token_id, (bsw, jcfg.text_len))
    ids[:, 0] = jcfg.media_token_id
    mask = np.ones_like(ids)
    mask[::3, -2:] = 0
    rng = jax.random.PRNGKey(1)
    want = jflam.forward_train(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(img), jnp.asarray(ids),
                               jnp.asarray(mask), jcfg, rng,
                               vision_gripper=jnp.asarray(img), train=False)
    got = tflam.forward_train(
        to_torch(params, "cpu"), torch.as_tensor(img),
        torch.as_tensor(ids).long(), torch.as_tensor(mask), tcfg,
        vision_gripper=torch.as_tensor(img), train=False,
        rand_layer_ids=torch.as_tensor(np.array(want.rand_layer_ids)),
        switch_layer_ids=torch.as_tensor(switch_layer_ids(jcfg, rng, 2)))
    assert got.exit_outputs == () == want.exit_outputs
    assert rel_l2(got.hidden_states.numpy(),
                  np.asarray(want.hidden_states)) <= REL_L2
    for part in ("final_output", "extra_output", "extra_output2"):
        for g, w in zip(getattr(got, part), getattr(want, part)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("knobs", [{}, {"freeze_embed": True},
                                   {"train_params": 140}])
def test_masks_match_jax(llama, knobs):
    """norm_f and lm_head_w train in the joint phase (JAX
    flamingo.py:505-509), the llama blocks never."""
    jcfg, _, params = llama
    jcfg = dataclasses.replace(jcfg, **knobs)
    tcfg = port_config(jcfg)
    assert_masks_match_jax(jcfg, tcfg, params)
    mask = tflam.trainable_mask(to_torch(params, "cpu"), tcfg, "joint")
    assert mask["decoder"]["lm_head_w"]["w"] and \
        mask["decoder"]["norm_f"]["scale"]
    assert not any(m for blk in mask["decoder"]["blocks"]
                   for leaf in blk.values() for m in leaf.values())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def jax_deer(jcfg, params, quantize=None, th=THRESHOLDS[0]):
    jc, tc = controllers(jcfg, th)
    return (JaxDeerPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                          controller=jc, quantize=quantize), jc, tc)


@pytest.fixture(scope="module")
def jax_policies(llama):
    jcfg, _, params = llama
    return {q: jax_deer(jcfg, params, q) for q in (None, "int8", "int4")}


@pytest.mark.parametrize("quantize", [None, "int8", "int4", "int8_w8a8",
                                      "int4_w8a8"])
def test_scan_step_matches_jax_deer_policy(llama, jax_policies, quantize):
    """B=1 over each threshold row: exits equal, actions and carry within
    2e-4 (the w8a8 modes against JAX's int8 / int4 weights with its w8a8
    products, through its DeerPolicy's quantize)."""
    jcfg, tcfg, params = llama
    if quantize in jax_policies:
        jpol, jc, _ = jax_policies[quantize]
    else:
        jpol, jc, _ = jax_deer(jcfg, params, quantize)
    tpol = ScanDeerPolicy(params, tcfg, quantize=quantize, device="cpu")
    seen = set()
    for th in THRESHOLDS:
        jc.set_threshold_values(th)
        tpol.set_thresholds(th)
        for p in (jpol, tpol):
            p.reset()
        for t in range(2):
            jpol.set_timestep(t)
            seen.add(step_both(jpol, tpol, tcfg, seed=t))
            same_carry(tpol.carry, jpol.carry)
    assert seen == {1, 3, 5, 7}


def test_scan_step_batch_per_stream_rows_match_jax(llama, jax_policies):
    """B=4, one threshold row a stream: each stream equals a JAX
    DeerPolicy stepping that stream alone with its own carry."""
    jcfg, tcfg, params = llama
    jpol, jc, _ = jax_policies[None]
    tpol = ScanDeerPolicy(params, tcfg, device="cpu")
    tpol.set_thresholds_batch(THRESHOLDS)
    carries = [None] * 4
    seen = set()
    for t in range(3):
        img, grip, ids, mask = obs(tcfg, 4, seed=10 + t)
        acts, exits = tpol.step_batch(img, grip, ids, mask)
        for i in range(4):
            jpol.reset()
            jpol.carry = carries[i]
            jc.set_threshold_values(THRESHOLDS[i])
            a = jpol.step(*(jnp.asarray(v[i:i + 1])
                            for v in (img, grip, ids, mask)))
            carries[i] = jpol.carry
            assert exits[i] == jpol.last_exit_layer, (t, i)
            np.testing.assert_allclose(acts[i], a, **TOL)
            for ct, cj in zip(tpol.carry, jpol.carry):
                np.testing.assert_allclose(ct[:, i:i + 1].numpy(),
                                           np.asarray(cj), **TOL)
        seen |= set(exits.tolist())
    assert seen == {1, 3, 5, 7}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_deer_policy_matches_jax(llama, jax_policies, quantize):
    jcfg, tcfg, params = llama
    jpol, jc, tc = jax_policies[quantize]
    tpol = DeerPolicy(params, tcfg, controller=tc, quantize=quantize,
                      device="cpu")
    for p in (jpol, tpol):
        p.reset()
    seen = set()
    for t, th in enumerate(THRESHOLDS * 2):
        jc.set_threshold_values(th)
        tc.set_threshold_values(th)
        for p in (jpol, tpol):
            p.set_timestep(t)
        seen.add(step_both(jpol, tpol, tcfg, seed=t))
        same_carry(tpol.carry, jpol.carry)
    assert seen == {1, 3, 5, 7}


@pytest.mark.parametrize("row", [THRESHOLDS[2], THRESHOLDS[3]])
def test_batched_policy_matches_jax(llama, row):
    """BatchedDeerPolicy (one threshold row for the batch, B=3): a llama
    layer in each segment, exits and carries as JAX's."""
    from deer_vla_tpu.eval.batched_policy import BatchedDeerPolicy as JaxB
    from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
    jcfg, tcfg, params = llama
    jpol = JaxB(jax.tree.map(jnp.asarray, params), jcfg, batch=3,
                thresholds=row)
    tpol = BatchedDeerPolicy(params, tcfg, batch=3, thresholds=row,
                             device="cpu")
    for t in range(2):
        img, grip, ids, mask = obs(tcfg, 3, seed=30 + t)
        acts_j, ex_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                                 jnp.asarray(ids), jnp.asarray(mask))
        acts_t, ex_t = tpol.step(img, grip, ids, mask)
        np.testing.assert_array_equal(ex_t, np.asarray(ex_j))
        np.testing.assert_allclose(acts_t, np.asarray(acts_j), **TOL)
        same_carry(tpol.carry, jpol.carry)
    assert set(ex_t.tolist()) == {3 if row is THRESHOLDS[2] else 5}


def test_indexed_mm_on_llama_raises(llama):
    """K2-K4 implement the MPT block's products: asking for them on a llama
    decoder raises instead of serving without them."""
    _, tcfg, params = llama
    for q in (None, "int8", "int4"):
        with pytest.raises(ValueError, match="MPT block"):
            ScanDeerPolicy(params, tcfg, indexed_mm=True, quantize=q,
                           device="cpu")
    with pytest.raises(ValueError, match="MPT block"):
        build_scan_step(tcfg, list(tcfg.all_exit_ids()), indexed_mm=True)


# ---------------------------------------------------------------------------
# calibration, training, the CLI and the checkpoint record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("streamed", [False, True])
def test_calibrate_matches_jax(llama, streamed):
    """The extra exit's deltas over all four exit ids, as JAX's cli/eval
    calibrates bc_llama (cli/eval.py:274-300)."""
    jcfg, tcfg, params = llama
    tok = HashTokenizer(vocab_size=128, max_length=8)
    jcfg, tcfg = (dataclasses.replace(c, media_token_id=tok.media_token_id)
                  for c in (jcfg, tcfg))
    batches = debug_batches(jcfg, tok, num=2, seed=8)
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, params), jcfg,
                                  batches, 0.5, max_batches=2,
                                  streamed=streamed, model_name="llama_9b")
    probs = (tcal.streamed_sample_probs(tcfg, 0.5, None, "exp", "llama_9b")
             if streamed else None)
    th_t, vals_t = tcal.calibrate(
        to_torch(params, "cpu"), tcfg, batches, 0.5, max_batches=2,
        streamed=streamed, model_name="llama_9b",
        draws=jax_batch_draws(jcfg, 2, streamed, probs))
    assert vals_t.shape == vals_j.shape and vals_t.shape[0] == 4
    assert rel_l2(vals_t, vals_j) <= REL_L2
    assert list(th_t) == list(th_j) == [1, 3, 5, 7]
    np.testing.assert_allclose([th_t[e] for e in th_t],
                               [th_j[e] for e in th_j], rtol=REL_L2,
                               atol=DELTA_ATOL)


@pytest.mark.parametrize("phase", ["joint", "exit_only"])
def test_train_steps_match_jax(llama, phase):
    """lm_head_w and norm_f are trainable in the joint phase but no loss
    reaches them: no gradient in the port, zero in JAX, unchanged."""
    jcfg, tcfg, params = llama
    keys = assert_train_steps_match(jcfg, tcfg, params, phase)
    assert ("decoder/lm_head_w/w" in keys) == (phase == "joint")


def test_eval_cli_serves_a_llama_checkpoint(llama, tmp_path, capsys):
    """cli/eval on a bc_llama checkpoint: calibrates over its exits and
    serves sequentially and over lanes (indexed_mm off: the CLI asks for
    it only on an MPT decoder)."""
    _, tcfg, params = llama
    tok = HashTokenizer(vocab_size=128, max_length=8)
    tcfg = dataclasses.replace(tcfg, media_token_id=tok.media_token_id)
    path = tckpt.save_checkpoint(str(tmp_path / "llama"),
                                 to_torch(params, "cpu"), tcfg)
    for extra in ([], ["--lanes", "2"]):
        report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                                path, "--precision", "fp32",
                                "--calib_batches", "1",
                                "--num_sequences_override", "2",
                                "--exit_ratio", "0.5"] + extra,
                               device="cpu")
        last = capsys.readouterr().out.strip().splitlines()[-3:]
        assert len(last[0].split(",")) == 4  # a threshold an exit
        taken = {e for e, p in enumerate(report["exit_hist"]) if p > 0}
        assert taken and taken <= {1, 3, 5, 7}


def test_resume_refuses_another_model(tmp_path):
    """The backbone record holds the model: a llama run does not resume
    over an MPT run's checkpoint drawn from the same seed on the same
    device."""
    cfg, tcfg, loader = trainer_setup(tmp_path, batches=1,
                                      num_joint_epochs=2, num_exit_epochs=0)
    Trainer(cfg, tcfg, loader, device="cpu").train(num_epochs=1)
    side = json.loads((tmp_path / "deer_0.json").read_text())
    assert side["meta"]["init"]["backbone"]["decoder"]["arch"] == "mpt"
    other = dataclasses.replace(cfg, mpt=dataclasses.replace(
        cfg.mpt, arch="llama", alibi=False), multi_exit=False)
    tr = Trainer(other, tcfg, loader, device="cpu")
    with pytest.raises(ValueError, match="trained over the backbone"):
        tr.maybe_resume()
    assert Trainer(cfg, tcfg, loader, device="cpu").maybe_resume() == 1
