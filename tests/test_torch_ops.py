"""PyTorch port, ops layer: each function against its JAX counterpart on the
CPU, on the same numpy inputs.

The two kernels are held through their plain versions: the port's
``flash_attention_reference`` against the Pallas flash-attention kernel in
TPU interpret mode, and ``indexed_matmul_reference`` against the Pallas
indexed-matmul kernel in interpret mode and its XLA fallback.  Tolerance is
2e-5 per op in fp32 (the tolerance tests/test_pallas.py holds the Pallas
kernels to), except where a line says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.ops import alibi as jalibi
from deer_vla_tpu.ops import attention as jattn
from deer_vla_tpu.ops import layers as jlayers
from deer_vla_tpu.ops import lstm as jlstm
from deer_vla_tpu.ops.pallas import flash_attention as jfa
from deer_vla_tpu.ops.pallas import indexed_matmul as jimm
from deer_vla_tpu_torch.ops import alibi as talibi
from deer_vla_tpu_torch.ops import attention as tattn
from deer_vla_tpu_torch.ops import layers as tlayers
from deer_vla_tpu_torch.ops import lstm as tlstm
from deer_vla_tpu_torch.ops.kernels import flash_attention as tfa
from deer_vla_tpu_torch.ops.kernels import indexed_matmul as timm

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_matches_jax(with_bias):
    r = np.random.RandomState(0)
    x = (r.randn(3, 5, 24) * 3 + 1).astype(np.float32)
    p = {"scale": r.randn(24).astype(np.float32)}
    if with_bias:
        p["bias"] = r.randn(24).astype(np.float32)
    ref = jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(tlayers.layernorm({k: t(v) for k, v in p.items()}, t(x)), ref)


def test_layernorm_bf16_keeps_dtype_with_fp32_stats():
    r = np.random.RandomState(1)
    x = torch.from_numpy(r.randn(4, 32).astype(np.float32)).bfloat16()
    y = tlayers.layernorm(None, x)
    assert y.dtype == torch.bfloat16
    ref = tlayers.layernorm(None, x.float())
    # one bf16 rounding of the output: 2^-8 relative
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), rtol=8e-3,
                               atol=8e-3)


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear_matches_jax(with_bias):
    r = np.random.RandomState(2)
    x = r.randn(2, 7, 16).astype(np.float32)
    p = {"w": r.randn(16, 12).astype(np.float32)}
    if with_bias:
        p["b"] = r.randn(12).astype(np.float32)
    ref = jlayers.linear(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(tlayers.linear({k: t(v) for k, v in p.items()}, t(x)), ref)


def test_quick_gelu_and_embedding_match_jax():
    r = np.random.RandomState(3)
    x = r.randn(5, 9).astype(np.float32)
    close(tlayers.quick_gelu(t(x)), jlayers.quick_gelu(jnp.asarray(x)))
    table = r.randn(11, 6).astype(np.float32)
    ids = r.randint(0, 11, size=(2, 4))
    ref = jlayers.embedding({"w": jnp.asarray(table)}, jnp.asarray(ids))
    close(tlayers.embedding({"w": t(table)}, t(ids)), ref)


def test_stack_layer_tree_keeps_1d_leaves_dtype():
    r = np.random.RandomState(4)
    layers = [{"w": r.randn(4, 3).astype(np.float32),
               "ln": {"scale": r.randn(3).astype(np.float32)}}
              for _ in range(3)]
    ref = jlayers.stack_layer_tree(jax.tree.map(jnp.asarray, layers),
                                   jnp.bfloat16)
    got = tlayers.stack_layer_tree(
        [{"w": t(l["w"]), "ln": {"scale": t(l["ln"]["scale"])}}
         for l in layers], torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (3, 4, 3)
    assert got["ln"]["scale"].dtype == torch.float32
    assert str(ref["ln"]["scale"].dtype) == "float32"
    np.testing.assert_array_equal(
        got["w"].float().numpy(), np.asarray(ref["w"].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# attention + kernel K1 (flash attention)
# ---------------------------------------------------------------------------


def pallas_flash(q, k, v, bias, scale):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            bias=None if bias is None else jnp.asarray(bias), scale=scale)


def qkv(shape, sk, seed):
    b, h, sq, d = shape
    r = np.random.RandomState(seed)
    return (r.randn(b, h, sq, d).astype(np.float32),
            r.randn(b, h, sk, d).astype(np.float32),
            r.randn(b, h, sk, d).astype(np.float32), r)


@pytest.mark.parametrize("shape,sk,bias_shape", [
    ((2, 4, 32, 16), 32, (2, 1, 32, 32)),     # decoder-like, per-batch bias
    ((2, 4, 257, 64), 257, None),             # the ViT's 257-token block
    ((2, 2, 64, 32), 79, (2, 1, 64, 79)),     # kv longer than q, ragged Sk
    ((2, 4, 24, 16), 24, (1, 4, 24, 24)),     # bias broadcast over B
    ((3, 2, 16, 8), 40, (1, 1, 16, 40)),      # bias broadcast over B and H
])
def test_flash_attention_reference_matches_pallas(shape, sk, bias_shape):
    q, k, v, r = qkv(shape, sk, seed=0)
    bias = (None if bias_shape is None
            else (r.randn(*bias_shape) * 2).astype(np.float32))
    scale = shape[-1] ** -0.5
    ref = pallas_flash(q, k, v, bias, scale)
    got = tfa.flash_attention_reference(
        t(q), t(k), t(v), None if bias is None else t(bias), scale)
    close(got, ref)
    # on CPU tensors the wrapper is the plain version
    close(tfa.flash_attention(t(q), t(k), t(v),
                              None if bias is None else t(bias), scale), ref)


def test_flash_attention_fully_masked_row_is_uniform():
    """A row whose bias is -1e9 everywhere (text before the first media
    token) gives the plain version's uniform weights, not NaN."""
    q, k, v, _ = qkv((1, 2, 8, 16), 12, seed=5)
    bias = np.zeros((1, 1, 8, 12), np.float32)
    bias[..., 0, :] = -1e9
    ref = pallas_flash(q, k, v, bias, 0.25)
    got = tfa.flash_attention_reference(t(q), t(k), t(v), t(bias), 0.25)
    assert torch.isfinite(got).all()
    close(got, ref)
    close(got[0, :, 0], np.broadcast_to(v[0].mean(1), (2, 16)), atol=1e-5,
          rtol=1e-5)


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 1, 8, 512)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    q, k = torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 9, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, k, bias=torch.zeros(3, 1, 8, 9))


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on the card raises: the plain
    version is taken only for CPU tensors."""
    q = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    x = torch.zeros(4, 64, device="meta")
    w = torch.zeros(2, 64, 16, device="meta")
    with pytest.raises(ValueError):
        timm.indexed_matmul(x, w, 0)


@pytest.mark.parametrize("shape,sk,with_bias", [
    ((2, 4, 32, 16), 32, True),     # plain path (Sq < 128)
    ((1, 2, 130, 16), 130, True),   # kernel path (Sq >= 128)
    ((1, 2, 257, 32), 257, False),  # kernel path, the ViT's shape class
])
def test_dot_attention_matches_jax(shape, sk, with_bias):
    q, k, v, r = qkv(shape, sk, seed=6)
    bias = (r.randn(shape[0], 1, shape[2], sk).astype(np.float32)
            if with_bias else None)
    ref = jattn.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if bias is None else jnp.asarray(bias))
    got = tattn.dot_attention(t(q), t(k), t(v),
                              None if bias is None else t(bias))
    close(got, ref)


def test_split_merge_heads_match_jax():
    x = np.random.RandomState(7).randn(2, 5, 12).astype(np.float32)
    sj = jattn.split_heads(jnp.asarray(x), 3)
    st = tattn.split_heads(t(x), 3)
    close(st, sj, rtol=0, atol=0)
    close(tattn.merge_heads(st), jattn.merge_heads(sj), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# kernel K2 (layer-indexed matmul)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,kdim,n,blk", [
    (32, 256, 384, (128, 128)),   # multi k/n tiles
    (7, 256, 128, (256, 128)),    # M padding
    (16, 512, 256, (512, 256)),   # single k tile
])
def test_indexed_matmul_reference_matches_pallas(m, kdim, n, blk):
    from jax.experimental.pallas import tpu as pltpu
    r = np.random.RandomState(0)
    x = r.randn(m, kdim).astype(np.float32)
    w = r.randn(3, kdim, n).astype(np.float32)
    for idx in range(3):
        with pltpu.force_tpu_interpret_mode():
            ref = jimm.indexed_matmul(jnp.asarray(x), jnp.asarray(w), idx,
                                      block_k=blk[0], block_n=blk[1],
                                      backend="pallas")
        ref_xla = jimm.indexed_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.int32(idx), backend="xla")
        # K = 512 sums of unit normals: 2e-4 absolute, as test_pallas.py
        got = timm.indexed_matmul_reference(t(x), t(w), idx)
        close(got, ref, rtol=2e-5, atol=2e-4)
        close(got, ref_xla, rtol=2e-5, atol=2e-4)
        idx_t = torch.tensor(idx, dtype=torch.int32)
        close(timm.indexed_matmul(t(x), t(w), idx_t), ref, rtol=2e-5,
              atol=2e-4)


def test_indexed_matmul_keeps_leading_dims():
    r = np.random.RandomState(1)
    x = r.randn(2, 3, 64).astype(np.float32)
    w = r.randn(4, 64, 16).astype(np.float32)
    y = timm.indexed_matmul(t(x), t(w), torch.tensor(2, dtype=torch.int32))
    assert y.shape == (2, 3, 16)
    close(y, x @ w[2], rtol=2e-5, atol=1e-4)
    with pytest.raises(ValueError):
        timm.indexed_matmul(t(x), t(w[:, :32]), 0)


# ---------------------------------------------------------------------------
# ALiBi, LSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_heads", [16, 12])
def test_alibi_slopes_and_bias_match_jax(n_heads):
    np.testing.assert_array_equal(talibi.alibi_slopes(n_heads),
                                  jalibi.alibi_slopes(n_heads))
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = jalibi.full_attn_bias(jnp.asarray(mask), n_heads, 10, 8.0, jdt)
        got = talibi.full_attn_bias(t(mask), n_heads, 10, 8.0, tdt)
        assert got.shape == (2, n_heads, 10, 10) and got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    ref = jalibi.causal_padding_bias(jnp.asarray(mask), 10)
    close(talibi.causal_padding_bias(t(mask), 10), ref, rtol=0, atol=0)


@pytest.mark.parametrize("use_ln", [False, True])
def test_lstm_step_matches_jax(use_ln):
    params = jlstm.init_lstm(jax.random.PRNGKey(0), 12, 8, 3, use_ln)
    params = jax.tree.map(np.asarray, params)
    r = np.random.RandomState(8)
    x = r.randn(4, 12).astype(np.float32)
    carry = tuple(r.randn(3, 4, 8).astype(np.float32) for _ in range(2))
    y_j, (h_j, c_j) = jlstm.lstm_step(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x),
                                      tuple(map(jnp.asarray, carry)))
    tp = tlayers.tree_map(t, params)
    y_t, (h_t, c_t) = tlstm.lstm_step(tp, t(x), tuple(map(t, carry)))
    close(y_t, y_j)
    close(h_t, h_j)
    close(c_t, c_j)
    z = tlstm.zero_carry(3, 4, 8)
    assert z[0].shape == (3, 4, 8) and not z[0].any()
