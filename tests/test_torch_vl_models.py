"""PyTorch port, the vision-language models against the JAX package on the
CPU: ``models/mpt.lm_logits`` (mpt and llama), text generation on the
recompute engine (``eval/vl_eval.greedy_generate``) and the cached one
(``eval/kv_decode.greedy_generate_cached``), LM scoring
(``summed_nll``, ``classify_by_lm_score``), RICES, and BLIP
(``models/blip``: vision, text decoder, forward, generation, the HF
converter), on deer_tiny / blip_tiny weights that the port draws and both
packages run (the cross-attention gates opened, so that the images reach
the text) and numpy-seeded inputs.

Generation must be token-equal to JAX's in fp32, on both engines and both
decoder archs; the step logits and module outputs agree within 2e-5
(``TOL``), BLIP's within 1e-5 relative (``BLIP_TOL``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval import kv_decode as jkv
from deer_vla_tpu.eval import vl_eval as jvl
from deer_vla_tpu.models import blip as jblip
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import kv_decode as tkv
from deer_vla_tpu_torch.eval import vl_eval as tvl
from deer_vla_tpu_torch.models import blip as tblip
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.ops.layers import tree_map

TOL = dict(rtol=2e-5, atol=2e-5)
BLIP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model(arch="mpt", seed=0):
    """(JAX cfg, port cfg, numpy params, port params, tokenizer) at
    deer_tiny, the gates drawn open.  The port draws the weights (the
    trees share their layout); JAX runs them as numpy arrays."""
    tok = HashTokenizer(vocab_size=128, max_length=64)
    jcfg = dataclasses.replace(jconfig.deer_tiny(),
                               media_token_id=tok.media_token_id)
    if arch == "llama":
        jcfg = dataclasses.replace(jcfg, mpt=dataclasses.replace(
            jcfg.mpt, arch="llama", alibi=False))
    tcfg = tconfig.DeerConfig.from_json(jcfg.to_json())
    params = tree_map(lambda t: t.numpy(),
                      tflam.init_deer(tcfg, seed=seed, device="cpu"))
    r = np.random.RandomState(seed + 100)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return jcfg, tcfg, params, to_torch(params, "cpu"), tok


@pytest.fixture(scope="module")
def mpt_model():
    return make_model("mpt")


@pytest.fixture(scope="module")
def llama_model():
    return make_model("llama")


def strip_tail(ids, mask, n, pad):
    """Drop each row's last ``n`` valid tokens (the tokenizer's trailing
    specials), so that generation continues the prompt."""
    ids, mask = np.array(ids, copy=True), np.array(mask, copy=True)
    for r, length in enumerate(mask.sum(-1)):
        ids[r, length - n:length] = pad
        mask[r, length - n:length] = 0
    return ids, mask


def ragged_prompts(tok):
    ids, mask = tok(["a photo of", "what is the small red object", "hi"])
    ids, mask = strip_tail(ids, mask, 2, 0)
    return ids[:, :-2], mask[:, :-2]


def fewshot_prompts(tok):
    texts = ["<image>A photo of a cat<|endofchunk|><image>A photo of a dog"
             "<|endofchunk|><image>A photo of",
             "<image>one<|endofchunk|><image>two<|endofchunk|><image>"
             "A photo of"]
    ids, mask = tok.encode_raw(texts, 40)
    return strip_tail(ids, mask, 1, tok.pad_token_id)


def vision(cfg, b, t, seed):
    hw = cfg.vit.image_size
    return np.random.RandomState(seed).randn(b, t, 1, 3, hw, hw).astype(
        np.float32)


# ---------------------------------------------------------------------------
# lm_logits, tokenization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_lm_logits_matches_jax(arch, mpt_model, llama_model):
    _, _, params, tparams, _ = mpt_model if arch == "mpt" else llama_model
    h = np.random.RandomState(1).randn(2, 5, 64).astype(np.float32)
    want = jmpt.lm_logits(params["decoder"], jnp.asarray(h), jnp.float32,
                          arch=arch)
    got = tmpt.lm_logits(tparams["decoder"], torch.from_numpy(h),
                         torch.float32, arch=arch)
    assert got.shape == (2, 5, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_raw_ids_equal_jax():
    texts = ["<image>A photo of a cat<|endofchunk|><image>dog", "",
             "plain words only", "<image><image><|endofchunk|>x y z " * 6]
    for vocab, n in ((128, 40), (50432, 12)):
        want = JaxTokenizer(vocab_size=vocab).encode_raw(texts, n)
        got = HashTokenizer(vocab_size=vocab).encode_raw(texts, n)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# generation: both engines, both archs, against JAX
# ---------------------------------------------------------------------------


def jax_generate(engine, params, cfg, vis, ids, mask, n_new, eos):
    fn = {"recompute": jvl.greedy_generate,
          "kv_cache": jkv.greedy_generate_cached}[engine]
    return fn(params, cfg, jnp.asarray(vis), ids, mask, max_new_tokens=n_new,
              eos_id=eos)


def port_generate(engine, tparams, cfg, vis, ids, mask, n_new, eos,
                  logits_out=None):
    fn = {"recompute": tvl.greedy_generate,
          "kv_cache": tkv.greedy_generate_cached}[engine]
    return fn(tparams, cfg, torch.from_numpy(vis), ids, mask,
              max_new_tokens=n_new, eos_id=eos, logits_out=logits_out)


@functools.lru_cache(maxsize=None)
def jax_forward_logits(cfg):
    def fwd(params, vis, ids, mask):
        media = jflam.encode_vision(params, vis, None, cfg)
        _, x = jmpt.decoder_forward(params["decoder"], ids, mask, media, cfg)
        return jmpt.lm_logits(params["decoder"], x, jnp.float32,
                              arch=cfg.mpt.arch)
    return jax.jit(fwd)


def jax_step_logits(params, cfg, vis, ids, mask, out, n_new):
    """JAX's logits at each decode step's read position, teacher-forced on
    the generated buffer ``out`` (the recompute step's own computation)."""
    b, s = ids.shape
    start = mask.sum(1)
    buf = np.zeros((b, s + n_new), np.int32)
    bmask = np.zeros((b, s + n_new), np.int32)
    buf[:, :s], bmask[:, :s] = ids, mask
    for r in range(b):
        buf[r, start[r]:start[r] + n_new] = out[r]
        bmask[r, start[r]:start[r] + n_new] = 1
    logits = np.asarray(jax_forward_logits(cfg)(params, jnp.asarray(vis),
                                                jnp.asarray(buf),
                                                jnp.asarray(bmask)))
    return np.stack([logits[np.arange(b), start + i - 1]
                     for i in range(n_new)])


# JAX's tokens and step logits a (arch, prompts): its recompute engine, which
# tests/test_kv_decode.py holds its cached engine to token for token
N_NEW = 6
_JAX_REF = {}


def jax_reference(model, arch, prompts):
    if (arch, prompts) not in _JAX_REF:
        jcfg, _, params, _, tok = model
        ids, mask = (ragged_prompts(tok) if prompts == "ragged"
                     else fewshot_prompts(tok))
        vis = vision(jcfg, ids.shape[0], 1 if prompts == "ragged" else 3, 2)
        out = jax_generate("recompute", params, jcfg, vis, ids, mask, N_NEW,
                           None)
        _JAX_REF[arch, prompts] = (ids, mask, vis, out, jax_step_logits(
            params, jcfg, vis, ids, mask, out, N_NEW))
    return _JAX_REF[arch, prompts]


@pytest.mark.parametrize("arch,engine,prompts,n_new", [
    ("mpt", "recompute", "ragged", N_NEW),
    ("mpt", "kv_cache", "ragged", N_NEW),
    ("mpt", "recompute", "fewshot", N_NEW),
    ("mpt", "kv_cache", "fewshot", N_NEW),
    ("mpt", "kv_cache", "ragged", 1),
    ("mpt", "recompute", "fewshot", 1),
    ("llama", "recompute", "ragged", N_NEW),
    ("llama", "recompute", "fewshot", 1)])
def test_generation_token_equal_to_jax(arch, engine, prompts, n_new,
                                       mpt_model, llama_model):
    """Token-equal to JAX's (greedy decoding is prefix-consistent: n_new=1
    is the first column of JAX's 6); each step's logits within TOL of
    JAX's teacher-forced ones (no eos trim, so that every step counts)."""
    model = mpt_model if arch == "mpt" else llama_model
    ids, mask, vis, want, ref = jax_reference(model, arch, prompts)
    steps = []
    got = port_generate(engine, model[3], model[1], vis, ids, mask, n_new,
                        None, steps)
    np.testing.assert_array_equal(got, want[:, :n_new])
    np.testing.assert_allclose(torch.stack(steps).numpy(), ref[:n_new],
                               **TOL)


def test_cached_equals_recompute_with_eos(mpt_model):
    """The port's two engines agree token for token, eos trim included
    (tests/test_kv_decode.py's contract for JAX's)."""
    jcfg, tcfg, _, tparams, tok = mpt_model
    ids, mask = fewshot_prompts(tok)
    vis = vision(jcfg, 2, 3, 3)
    outs = [port_generate(e, tparams, tcfg, vis, ids, mask, 7,
                          tok.eos_token_id) for e in ("recompute",
                                                      "kv_cache")]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_llama_refuses_the_cache(llama_model):
    jcfg, tcfg, _, tparams, tok = llama_model
    assert tkv.supports_kv_cache(tcfg) is jkv.supports_kv_cache(jcfg) is False
    ids, mask = ragged_prompts(tok)
    with pytest.raises(ValueError, match="recompute engine"):
        port_generate("kv_cache", tparams, tcfg, vision(jcfg, 3, 1, 0), ids,
                      mask, 2, None)


# ---------------------------------------------------------------------------
# scoring and RICES
# ---------------------------------------------------------------------------


def test_summed_nll_and_classification_match_jax(mpt_model):
    jcfg, tcfg, params, tparams, tok = mpt_model
    r = np.random.RandomState(4)
    logits = r.randn(3, 7, 128).astype(np.float32) * 3
    ids = r.randint(0, 128, (3, 7)).astype(np.int32)
    target = (r.rand(3, 7) > 0.4).astype(np.int32)
    want = jvl.summed_nll(jnp.asarray(logits), jnp.asarray(ids),
                          jnp.asarray(target))
    got = tvl.summed_nll(torch.from_numpy(logits), torch.from_numpy(ids),
                         torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    classes = ["cat", "dog", "red object", "a small blue thing"]
    vis = vision(jcfg, 1, 1, 5)
    arg_j, scores_j = jvl.classify_by_lm_score(params, jcfg, jnp.asarray(vis),
                                               classes, tok)
    arg_t, scores_t = tvl.classify_by_lm_score(tparams, tcfg,
                                               torch.from_numpy(vis),
                                               classes, tok)
    assert arg_t == arg_j
    np.testing.assert_allclose(scores_t, np.asarray(scores_j), **TOL)


def test_rices_indices_match_jax(mpt_model, tmp_path):
    jcfg, tcfg, params, tparams, _ = mpt_model
    hw = jcfg.vit.image_size
    r = np.random.RandomState(6)
    index = r.randn(12, 3, hw, hw).astype(np.float32)
    query = r.randn(4, 3, hw, hw).astype(np.float32)
    jr, tr = jvl.RICES(params, jcfg, batch_size=5), \
        tvl.RICES(tparams, tcfg, batch_size=5)
    np.testing.assert_allclose(tr.build_index(index), jr.build_index(index),
                               **TOL)
    np.testing.assert_array_equal(tr.retrieve(query, 3),
                                  jr.retrieve(query, 3))
    path = str(tmp_path / "feats.bin")
    tr.save(path)
    np.testing.assert_array_equal(jr.load(path), tr.features)


# ---------------------------------------------------------------------------
# BLIP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blip():
    cfg_j, cfg_t = jblip.blip_tiny(), tblip.blip_tiny()
    params = tree_map(lambda t: t.numpy(),
                      tblip.init_blip(cfg_t, seed=0, device="cpu"))
    return cfg_j, cfg_t, params, to_torch(params, "cpu")


def blip_inputs(cfg, b=2, s=7, seed=0):
    r = np.random.RandomState(seed)
    pix = r.randn(b, 3, cfg.vision.image_size,
                  cfg.vision.image_size).astype(np.float32)
    ids = r.randint(3, cfg.text.vocab_size - 4, (b, s)).astype(np.int32)
    ids[:, 0] = cfg.text.bos_token_id
    mask = np.ones((b, s), np.int32)
    mask[1, -2:] = 0  # a ragged row: the key-padding mask
    ids[1, -2:] = cfg.text.pad_token_id
    return pix, ids, mask


def test_blip_configs_match_jax():
    for name in ("blip_base", "blip_tiny"):
        assert (dataclasses.asdict(getattr(tblip, name)())
                == dataclasses.asdict(getattr(jblip, name)()))
    assert tblip.blip_base().vision.seq_len == 577


@pytest.mark.parametrize("part", ["vision", "text", "forward"])
def test_blip_matches_jax(blip, part):
    cfg_j, cfg_t, params, tparams = blip
    pix, ids, mask = blip_inputs(cfg_j, seed=1)
    pj, pt = jnp.asarray(pix), torch.from_numpy(pix)
    enc_j = jblip.vision_forward(params, pj, cfg_j.vision)
    enc_t = tblip.vision_forward(tparams, pt, cfg_t.vision)
    if part == "vision":
        want, got = enc_j, enc_t
    elif part == "text":
        want = jblip.text_decoder_forward(params, jnp.asarray(ids),
                                          jnp.asarray(mask), enc_j,
                                          cfg_j.text)
        got = tblip.text_decoder_forward(tparams, torch.from_numpy(ids),
                                         torch.from_numpy(mask), enc_t,
                                         cfg_t.text)
    else:
        want = jblip.blip_forward(params, pj, jnp.asarray(ids),
                                  jnp.asarray(mask), cfg_j)
        got = tblip.blip_forward(tparams, pt, torch.from_numpy(ids),
                                 torch.from_numpy(mask), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLIP_TOL)


def test_blip_generation_token_equal_and_overflow(blip):
    cfg_j, cfg_t, params, tparams = blip
    pix, _, _ = blip_inputs(cfg_j, b=2, seed=3)
    bos, pad = cfg_j.text.bos_token_id, cfg_j.text.pad_token_id
    prompt = np.full((2, 3), pad, np.int32)
    pmask = np.zeros((2, 3), np.int32)
    prompt[0, 0], pmask[0, 0] = bos, 1
    prompt[1, :3], pmask[1, :3] = [bos, 5, 9], 1
    want = jblip.blip_generate(params, cfg_j, jnp.asarray(pix), prompt,
                               pmask, max_new_tokens=8)
    got = tblip.blip_generate(tparams, cfg_t, torch.from_numpy(pix), prompt,
                              pmask, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    long = np.full((1, 35), bos, np.int32)
    with pytest.raises(ValueError, match="exceeds text.max_positions=40"):
        tblip.blip_generate(tparams, cfg_t, torch.from_numpy(pix[:1]), long,
                            np.ones_like(long), max_new_tokens=6)


def hf_blip_state_dict(cfg, seed=0) -> dict:
    """Every key of HF BlipForConditionalGeneration's state dict at
    ``cfg``, in HF's (out, in) layout, with seeded random values (the
    names tests/test_blip.py holds JAX's converter to on an HF replica)."""
    vc, tc = cfg.vision, cfg.text
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.randn(*shape, generator=g) * 0.1

    def lin(prefix, i, o):
        put(prefix + ".weight", o, i)
        put(prefix + ".bias", o)

    def ln(prefix, d):
        put(prefix + ".weight", d)
        put(prefix + ".bias", d)

    v, w = "vision_model.", vc.width
    put(v + "embeddings.class_embedding", 1, 1, w)
    put(v + "embeddings.patch_embedding.weight", w, 3, vc.patch_size,
        vc.patch_size)
    put(v + "embeddings.patch_embedding.bias", w)
    put(v + "embeddings.position_embedding", 1, vc.seq_len, w)
    for i in range(vc.layers):
        b = f"{v}encoder.layers.{i}."
        ln(b + "layer_norm1", w)
        ln(b + "layer_norm2", w)
        lin(b + "self_attn.qkv", w, 3 * w)
        lin(b + "self_attn.projection", w, w)
        lin(b + "mlp.fc1", w, vc.mlp_dim)
        lin(b + "mlp.fc2", vc.mlp_dim, w)
    ln(v + "post_layernorm", w)
    t, d = "text_decoder.bert.", tc.width
    put(t + "embeddings.word_embeddings.weight", tc.vocab_size, d)
    put(t + "embeddings.position_embeddings.weight", tc.max_positions, d)
    ln(t + "embeddings.LayerNorm", d)
    for i in range(tc.layers):
        b = f"{t}encoder.layer.{i}."
        for att, kv in (("attention", d), ("crossattention", w)):
            lin(b + att + ".self.query", d, d)
            lin(b + att + ".self.key", kv, d)
            lin(b + att + ".self.value", kv, d)
            lin(b + att + ".output.dense", d, d)
            ln(b + att + ".output.LayerNorm", d)
        lin(b + "intermediate.dense", d, tc.mlp_dim)
        lin(b + "output.dense", tc.mlp_dim, d)
        ln(b + "output.LayerNorm", d)
    pred = "text_decoder.cls.predictions."
    lin(pred + "transform.dense", d, d)
    ln(pred + "transform.LayerNorm", d)
    lin(pred + "decoder", d, tc.vocab_size)
    sd[pred + "bias"] = sd[pred + "decoder.bias"]  # HF's tied alias
    sd[t + "embeddings.position_ids"] = torch.arange(tc.max_positions)[None]
    return sd


def flat_leaves(tree, path=()) -> dict:
    """{path of str keys: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {p: leaf for k, v in items
            for p, leaf in flat_leaves(v, path + (str(k),)).items()}


def test_convert_hf_blip_leaf_for_leaf():
    """The converter against JAX's on one HF state dict, every leaf
    bit-equal; a key left over raises."""
    sd = hf_blip_state_dict(jblip.blip_tiny())
    want = flat_leaves(jax.tree.map(np.asarray, jblip.convert_hf_blip(
        sd, jblip.blip_tiny())))
    got = flat_leaves(tblip.convert_hf_blip(sd, tblip.blip_tiny()))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key].numpy(), leaf,
                                      err_msg=str(key))
    sd["vision_model.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed HF BLIP keys"):
        tblip.convert_hf_blip(sd, tblip.blip_tiny())
