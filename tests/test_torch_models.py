"""PyTorch port, models layer: each module against its JAX counterpart on
the CPU, with weights that JAX initializes and the bridge carries over.

Tolerance is 2e-5 per module in fp32, except where a line says otherwise.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import gated_xattn as jgx
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu.models import perceiver as jper
from deer_vla_tpu.models import value_net as jvn
from deer_vla_tpu.models import vit as jvit
from deer_vla_tpu.ops.layers import stack_layer_tree as jstack
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.models import action_head as thead
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import gated_xattn as tgx
from deer_vla_tpu_torch.models import heads as theads
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.models import perceiver as tper
from deer_vla_tpu_torch.models import value_net as tvn
from deer_vla_tpu_torch.models import vit as tvit
from deer_vla_tpu_torch.ops.layers import stack_layer_tree as tstack
from deer_vla_tpu_torch.ops.layers import tree_map

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def bridged(params):
    return to_torch(np_tree(params), "cpu")


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def cfgs():
    return jconfig.deer_tiny(), tconfig.deer_tiny()


# ---------------------------------------------------------------------------
# config + init
# ---------------------------------------------------------------------------


def test_config_copy_round_trips_the_jax_sidecar():
    for jcfg, tcfg in ((jconfig.deer_tiny(), tconfig.deer_tiny()),
                       (jconfig.deer_3b(), tconfig.deer_3b())):
        loaded = tconfig.DeerConfig.from_json(jcfg.to_json())
        assert loaded == tcfg
        assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
        assert tcfg.all_exit_ids() == jcfg.all_exit_ids()
        assert tcfg.num_media_tokens == jcfg.num_media_tokens
    assert tconfig.deer_3b().dtypes.cdt == torch.bfloat16
    assert tconfig.deer_3b().all_exit_ids() == (1, 3, 5, 7, 9, 11)
    sidecar = Path(__file__).resolve().parents[1] / "runs/deer/deer_0.json"
    text = json.dumps(json.loads(sidecar.read_text())["config"])
    assert (dataclasses.asdict(tconfig.DeerConfig.from_json(text))
            == dataclasses.asdict(jconfig.DeerConfig.from_json(text)))


def test_init_deer_builds_the_jax_tree(cfgs):
    """Same keys, nesting, shapes and dtypes as the JAX init."""
    jcfg, tcfg = cfgs
    ref = np_tree(jflam.init_deer(jax.random.PRNGKey(0), jcfg))
    got = tflam.init_deer(tcfg, seed=0, device="cpu")

    def sig(tree, path=()):
        if tree is None:
            return [(path, None)]
        if isinstance(tree, dict):
            return sum((sig(v, path + (k,)) for k, v in sorted(tree.items())),
                       [])
        if isinstance(tree, (list, tuple)):
            return sum((sig(v, path + (i,)) for i, v in enumerate(tree)), [])
        return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]

    assert sig(got) == sig(ref)
    again = tflam.init_deer(tcfg, seed=0, device="cpu")
    other = tflam.init_deer(tcfg, seed=1, device="cpu")
    a, b, c = (tree_leaves(x) for x in (got, again, other))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vcfg", [
    jconfig.ViTConfig(image_size=28, patch_size=14, width=64, layers=2,
                      heads=4),
    # 224 px: 257 tokens, so the port's attention takes the kernel route
    jconfig.ViTConfig(image_size=224, patch_size=14, width=32, layers=1,
                      heads=2),
    jconfig.ViTConfig(image_size=28, patch_size=14, width=32, layers=1,
                      heads=2, use_quick_gelu=False),
])
def test_vit_matches_jax(vcfg):
    tcfg = tconfig.ViTConfig(**dataclasses.asdict(vcfg))
    params = jvit.init_vit(jax.random.PRNGKey(1), vcfg)
    x = np.random.RandomState(0).randn(
        2, 3, vcfg.image_size, vcfg.image_size).astype(np.float32)
    cls_j, tok_j = jvit.vit_forward(params, jnp.asarray(x), vcfg)
    tp = bridged(params)
    cls_t, tok_t = tvit.vit_forward(tp, torch.from_numpy(x), tcfg)
    close(cls_t, cls_j)
    close(tok_t, tok_j)
    _, tok_s = tvit.vit_forward_stacked(
        tp, tvit.stack_vit_blocks(tp), torch.from_numpy(x), tcfg)
    close(tok_s, tok_j)


def test_patchify_flatten_order():
    x = np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(2, 3, 4, 4)
    ref = jvit._patchify(jnp.asarray(x), 2)
    close(tvit._patchify(torch.from_numpy(x), 2), ref, rtol=0, atol=0)


def test_perceiver_matches_jax(cfgs):
    jcfg, tcfg = cfgs
    params = jper.init_perceiver(jax.random.PRNGKey(2), jcfg.perceiver)
    x = np.random.RandomState(1).randn(2, 1, 1, 5, 64).astype(np.float32)
    ref = jper.perceiver_forward(params, jnp.asarray(x), jcfg.perceiver)
    tp = bridged(params)
    close(tper.perceiver_forward(tp, torch.from_numpy(x), tcfg.perceiver),
          ref)
    close(tper.perceiver_forward_stacked(
        tp, tper.stack_perceiver_layers(tp), torch.from_numpy(x),
        tcfg.perceiver), ref)


@pytest.mark.parametrize("use_gripper", [True, False])
def test_encode_vision_post_fusion_matches_jax(cfgs, use_gripper):
    jcfg, tcfg = (dataclasses.replace(c, use_gripper=use_gripper)
                  for c in cfgs)
    params = jflam.init_deer(jax.random.PRNGKey(3), jcfg)
    r = np.random.RandomState(2)
    img = r.randn(2, 1, 1, 3, 28, 28).astype(np.float32)
    grip = r.randn(2, 1, 1, 3, 28, 28).astype(np.float32)
    ref = jflam.encode_vision(params, jnp.asarray(img), jnp.asarray(grip),
                              jcfg)
    tp = bridged(params)
    got = tflam.encode_vision(tp, torch.from_numpy(img),
                              torch.from_numpy(grip), tcfg)
    assert got.shape == (2, 1, tcfg.num_media_tokens, 64)
    close(got, ref)


# ---------------------------------------------------------------------------
# gated cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("immediate", [True, False])
def test_gated_xattn_media_not_first_matches_jax(immediate):
    """The media token sits at position 3, so rows 0..2 are fully masked:
    they come out zero (immediate media), never NaN."""
    p = jgx.init_gated_xattn(jax.random.PRNGKey(4), 32, 16, dim_head=8,
                             heads=2)
    p = np_tree(p)
    p["attn_gate"] = np.array([0.6], np.float32)
    p["ff_gate"] = np.array([-0.3], np.float32)
    r = np.random.RandomState(3)
    x = r.randn(2, 7, 32).astype(np.float32)
    media = r.randn(2, 2, 4, 16).astype(np.float32)
    mloc = np.zeros((2, 7), bool)
    mloc[:, 3] = True
    mloc[1, 5] = True
    kw = dict(heads=2, dim_head=8, only_attend_immediate_media=immediate)
    jp = jax.tree.map(jnp.asarray, p)
    tp = to_torch(p, "cpu")
    att_j = jgx.masked_cross_attention(jp, jnp.asarray(x), jnp.asarray(media),
                                       jnp.asarray(mloc), **kw)
    att_t = tgx.masked_cross_attention(tp, torch.from_numpy(x),
                                       torch.from_numpy(media),
                                       torch.from_numpy(mloc), **kw)
    assert torch.isfinite(att_t).all()
    close(att_t, att_j)
    if immediate:
        assert not att_t[:, :3].any()
    out_j = jgx.gated_xattn_forward(jp, jnp.asarray(x), jnp.asarray(media),
                                    jnp.asarray(mloc), **kw)
    out_t = tgx.gated_xattn_forward(tp, torch.from_numpy(x),
                                    torch.from_numpy(media),
                                    torch.from_numpy(mloc), **kw)
    close(out_t, out_j)


# ---------------------------------------------------------------------------
# decoder block
# ---------------------------------------------------------------------------


def test_mpt_block_plain_and_stacked_match_jax(cfgs):
    jcfg, tcfg = cfgs
    blocks = [jmpt.init_mpt_block(k, jcfg.mpt)
              for k in jax.random.split(jax.random.PRNGKey(5), 3)]
    r = np.random.RandomState(4)
    x = r.randn(2, 8, 64).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    jbias = jmpt.make_attn_bias(jnp.asarray(mask), jcfg.mpt, jnp.float32)
    tbias = tmpt.make_attn_bias(torch.from_numpy(mask), tcfg.mpt,
                                torch.float32)
    close(tbias, jbias, rtol=0, atol=0)
    jst = jstack(blocks)
    tst = tstack([bridged(b) for b in blocks])
    for i in range(3):
        ref = jmpt.mpt_block_forward(blocks[i], jnp.asarray(x), jbias,
                                     jcfg.mpt)
        ref_s = jmpt.mpt_block_forward_stacked(jst, jnp.int32(i),
                                               jnp.asarray(x), jbias,
                                               jcfg.mpt)
        got = tmpt.mpt_block_forward(bridged(blocks[i]), torch.from_numpy(x),
                                     tbias, tcfg.mpt)
        got_s = tmpt.mpt_block_forward_stacked(
            tst, i, torch.from_numpy(x), tbias, tcfg.mpt,
            torch.tensor(i, dtype=torch.int32))
        close(got, ref)
        close(got_s, ref_s)
        close(got_s, got, rtol=1e-6, atol=1e-6)


def test_embed_tokens_matches_jax(cfgs):
    jcfg, _ = cfgs
    w = np.random.RandomState(5).randn(128, 64).astype(np.float32)
    ids = np.random.RandomState(6).randint(0, 128, size=(2, 8))
    ref = jmpt.embed_tokens({"wte": {"w": jnp.asarray(w)}}, jnp.asarray(ids),
                            jnp.bfloat16)
    got = tmpt.embed_tokens({"wte": {"w": torch.from_numpy(w)}},
                            torch.from_numpy(ids), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# exit head + criterion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_ln,k", [(False, 1), (True, 2)])
def test_head_step_matches_jax(cfgs, mlp_ln, k):
    jcfg, _ = cfgs
    hcfg = dataclasses.replace(jcfg.head, mlp_layernorm=mlp_ln,
                               multi_step_action=k)
    thcfg = tconfig.HeadConfig(**{f.name: getattr(hcfg, f.name)
                                  for f in dataclasses.fields(hcfg)})
    p = jhead.init_head(jax.random.PRNGKey(6), hcfg)
    r = np.random.RandomState(7)
    feat = r.randn(3, 8, 64).astype(np.float32)
    carry = tuple(r.randn(2, 3, 32).astype(np.float32) for _ in range(2))
    out_j, (h_j, c_j) = jhead.head_step(p, jnp.asarray(feat),
                                        tuple(map(jnp.asarray, carry)), hcfg)
    out_t, (h_t, c_t) = thead.head_step(bridged(p), torch.from_numpy(feat),
                                        tuple(map(torch.from_numpy, carry)),
                                        thcfg)
    assert out_t.actions.shape == (3, 1, 6 * k)
    for a, b in zip(out_t, out_j):
        close(a, b)
    close(h_t, h_j)
    close(c_t, c_j)
    close(thead.pool_tokens(torch.from_numpy(feat)),
          jhead.pool_tokens(jnp.asarray(feat)), rtol=0, atol=0)


def test_head_routing_refuses_other_families(cfgs):
    _, tcfg = cfgs
    assert theads.head_action_width(tcfg) == 6
    carry = theads.any_zero_carry(tcfg, 3)
    assert carry[0].shape == (2, 3, 32)
    for ht in ("lstm", "transformer"):
        with pytest.raises(ValueError):
            theads.any_zero_carry(dataclasses.replace(tcfg, head_type=ht), 1)


@pytest.mark.parametrize("kind", ["L2", "mean", "max", "cosine"])
def test_get_delta_matches_jax(kind):
    r = np.random.RandomState(8)
    a, b = (r.randn(4, 6).astype(np.float32) for _ in range(2))
    close(tvn.get_delta(torch.from_numpy(a), torch.from_numpy(b), kind),
          jvn.get_delta(jnp.asarray(a), jnp.asarray(b), kind))
