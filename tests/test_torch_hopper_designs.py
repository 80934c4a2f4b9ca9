"""PyTorch port: the Hopper designs of K1 (tensor-core flash attention) and
K2 (pipelined split-K weight stream), checked on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  What the CPU can hold is the arithmetic of
each design and the Python around it:

- K1's bf16 arithmetic in the kernel's tile order (64-key tiles, online
  max and sum, P rounded to bf16 against the running max, division last),
  emulated here and held against the Pallas kernel in TPU interpret mode
  within 2e-2 (one bf16 rounding of P against the running instead of the
  final max, and of the output; outputs of unit scale).
- ``dot_attention`` on ``split_heads`` views of a fused qkv projection
  hands the views to K1 uncopied and equals JAX's ``dot_attention`` +
  ``merge_heads`` within 2e-5 in fp32.
- K2's plan (``indexed_matmul_plan``) for every deer_3b product at B = 1,
  2, 3, 4, 8 and 32 and for every forced block config, and the plan's split-K summation order emulated in fp32 with
  one rounding to bf16, held against the Pallas kernel in interpret mode at
  every layer within 2^-7 max|y| (two bf16 ulps: both sides round an fp32
  sum once, in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.ops import attention as jattn
from deer_vla_tpu.ops.pallas import flash_attention as jfa
from deer_vla_tpu.ops.pallas import indexed_matmul as jimm
from deer_vla_tpu_torch.ops import attention as tattn
from deer_vla_tpu_torch.ops.kernels import flash_attention as tfa
from deer_vla_tpu_torch.ops.kernels import indexed_matmul as timm

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K1_TOL = 2e-2
K2_REL_TOL = 2 ** -7
KEY_TILE = 64


def t(a):
    return torch.from_numpy(np.array(a))


def bf16_np(a):
    """Round an fp32 array to bf16 and back (numpy keeps fp32)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def pallas(fn, *args, **kw):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw).astype(jnp.float32))


# ---------------------------------------------------------------------------
# K1: the kernel's tile-order arithmetic
# ---------------------------------------------------------------------------


def k1_tile_emulation(q, k, v, bias, scale, tile=KEY_TILE):
    """bf16 q, k, v (B, H, S, D); fp32 bias broadcast to (B, H, Sq, Sk).
    Keys in tiles of ``tile``, the last one padded with -1e30 logits; per
    tile the running max, the rescale of sum and output, P rounded to bf16
    against the running max before an fp32 P.V; division by the sum last."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, sq, 1), -float("inf"))
    l = torch.zeros(b, h, sq, 1)
    o = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        if bias is not None:
            s = s + bias[..., k0:k0 + tile].float()
        pad = tile - kt.shape[2]
        if pad:
            s = torch.cat([s, torch.full((b, h, sq, pad), -1e30)], -1)
            vt = torch.cat([vt, torch.zeros(b, h, pad, d)], 2)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                     p.bfloat16().float(), vt)
        m = mn
    return (o / l).bfloat16()


def k1_inputs(shape, sk, seed, bias_shape=None):
    b, h, sq, d = shape
    r = np.random.RandomState(seed)
    q, k, v = (bf16_np(r.randn(b, h, n, d).astype(np.float32))
               for n in (sq, sk, sk))
    bias = (None if bias_shape is None
            else (r.randn(*bias_shape) * 2).astype(np.float32))
    return q, k, v, bias


def pallas_flash_bf16(q, k, v, bias, scale):
    return pallas(jfa.flash_attention, jnp.asarray(q, jnp.bfloat16),
                  jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                  bias=None if bias is None else jnp.asarray(bias),
                  scale=scale)


@pytest.mark.parametrize("shape,sk,bias_shape", [
    ((1, 2, 257, 64), 257, None),            # the ViT's block, 5 key tiles
    ((2, 2, 100, 64), 79, (2, 1, 100, 79)),  # ragged Sk, bias over heads
    ((2, 2, 40, 16), 79, (1, 1, 40, 79)),    # deer_tiny head dim, bias over B, H
    ((1, 2, 130, 128), 130, (1, 2, 130, 130)),  # D = 128 (MPT-1B heads)
])
def test_k1_tile_order_matches_pallas(shape, sk, bias_shape):
    q, k, v, bias = k1_inputs(shape, sk, seed=11, bias_shape=bias_shape)
    scale = shape[-1] ** -0.5
    ref = pallas_flash_bf16(q, k, v, bias, scale)
    got = k1_tile_emulation(t(q).bfloat16(), t(k).bfloat16(),
                            t(v).bfloat16(),
                            None if bias is None else t(bias), scale)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=K1_TOL)
    # the port's plain version (final-max rounding) agrees as closely
    plain = tfa.flash_attention_reference(
        t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16(),
        None if bias is None else t(bias), scale)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=K1_TOL)


def test_k1_tile_order_fully_masked_row_is_uniform():
    """A query row whose bias is -1e9 on every key, across two key tiles,
    gives uniform weights (the mean of V), not NaN, in the tile order too."""
    q, k, v, _ = k1_inputs((1, 2, 8, 16), 79, seed=12)
    bias = np.zeros((1, 1, 8, 79), np.float32)
    bias[..., 0, :] = -1e9
    ref = pallas_flash_bf16(q, k, v, bias, 0.25)
    got = k1_tile_emulation(t(q).bfloat16(), t(k).bfloat16(),
                            t(v).bfloat16(), t(bias), 0.25)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(got[0, :, 0].float().numpy(),
                               np.broadcast_to(v[0].mean(1), (2, 16)),
                               rtol=0, atol=K1_TOL)


# ---------------------------------------------------------------------------
# K1: strided inputs, no copies around the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,heads,d", [(2, 257, 4, 16), (1, 130, 2, 32)])
def test_dot_attention_on_split_heads_views_matches_jax(monkeypatch, b, s,
                                                         heads, d):
    r = np.random.RandomState(13)
    qkv = r.randn(b, s, 3 * heads * d).astype(np.float32)
    jq, jk, jv = (jattn.split_heads(x, heads)
                  for x in jnp.split(jnp.asarray(qkv), 3, axis=-1))
    ref = jattn.merge_heads(jattn.dot_attention(jq, jk, jv))

    fused = t(qkv)
    seen = []
    kernel = tattn.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return kernel(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    q, k, v = (tattn.split_heads(x, heads) for x in fused.chunk(3, dim=-1))
    got = tattn.merge_heads(tattn.dot_attention(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    assert len(seen) == 1
    base = fused.untyped_storage().data_ptr()
    for x in seen[0]:  # the views themselves reach the kernel: no copy
        assert not x.is_contiguous()
        assert x.untyped_storage().data_ptr() == base


def test_k1_strided_views_are_taken_in_place():
    """The bf16 kernel reads split_heads views of a fused qkv (unit stride
    on D, 16-byte rows) without a copy, and copies what it cannot read."""
    qkv = torch.zeros(2, 257, 3 * 16 * 64, dtype=torch.bfloat16)
    for x in qkv.chunk(3, dim=-1):
        assert tfa.strided_ok(tattn.split_heads(x, 16))
    v = tattn.split_heads(qkv[..., :1024], 16)
    assert not tfa.strided_ok(v.transpose(2, 3))       # D not unit stride
    assert not tfa.strided_ok(qkv[..., 4:4 + 1024].reshape(
        2, 257, 16, 64).transpose(1, 2))               # rows 8 bytes off
    out = torch.empty(2, 257, 16, 64).transpose(1, 2)  # the kernel's output
    assert tattn.merge_heads(out).data_ptr() == out.data_ptr()


@pytest.mark.parametrize("d,want", [(16, 64), (32, 64), (48, 64), (64, 64),
                                    (80, 128), (128, 128)])
def test_k1_head_dims(d, want):
    assert tfa.kernel_head_dim(d) == want


@pytest.mark.parametrize("d", [8, 40, 100, 144, 256, 272])
def test_k1_head_dims_rejected(d):
    with pytest.raises(ValueError, match="multiple of 16"):
        tfa.kernel_head_dim(d)


# ---------------------------------------------------------------------------
# K2: the plan and its split-K order
# ---------------------------------------------------------------------------

DEER_3B_PRODUCTS = {"wqkv": (2048, 6144), "out_proj": (2048, 2048),
                    "mlp_up": (2048, 8192), "mlp_down": (8192, 2048)}


def assert_plan_legal(p, m, k, n):
    c = timm.K2_CONFIGS[p.config]
    assert (p.instruction, p.bm, p.bn, p.threads, p.stages) == tuple(c)
    assert p.splits in (1, 2, 4, 8)
    assert k % (p.splits * timm.K2_BK) == 0 and p.k_slice * p.splits == k
    assert n % p.bn == 0 and p.strips == n // p.bn
    assert p.bm % p.splits == 0           # the cluster shares the rows out
    assert p.m_chunks * p.bm >= m and (p.m_chunks - 1) * p.bm < m
    assert p.stages >= 3
    assert p.threads <= 1024 and p.threads % 128 == 0
    assert p.smem == c.smem <= timm.SMEM_PER_BLOCK
    assert p.smem >= p.bm * (p.bn + 8) * 4  # the fp32 partial tile
    assert p.blocks == p.splits * p.m_chunks * p.strips
    if p.instruction == "mma.sync":
        assert p.blocks >= timm.H100_SMS or p.splits == timm.K2_MAX_SPLITS
    else:                                  # one wave of one block an SM
        assert p.splits <= 4
        assert p.blocks <= timm.H100_SMS or p.splits == 1


@pytest.mark.parametrize("streams", [1, 2, 3, 4, 8, 32])
@pytest.mark.parametrize("product", sorted(DEER_3B_PRODUCTS))
def test_k2_plan_is_legal_for_deer_3b(product, streams):
    k, n = DEER_3B_PRODUCTS[product]
    m = 32 * streams
    p = timm.indexed_matmul_plan(m, k, n)
    assert_plan_legal(p, m, k, n)
    assert min(m, 256) <= p.bm            # all rows in one block up to 256
    if streams == 1:
        assert p.config == 0 and p.blocks >= timm.H100_SMS
    else:
        assert p.instruction == "wgmma"


@pytest.mark.parametrize("config", range(len(timm.K2_CONFIGS)))
@pytest.mark.parametrize("m", [32, 64, 96, 128, 256])
def test_k2_forced_configs_are_legal(config, m):
    """Every block config at the row counts where chip_smoke.py checks and
    times them against each other."""
    for k, n in DEER_3B_PRODUCTS.values():
        p = timm.indexed_matmul_plan(m, k, n, config=config)
        assert p.config == config
        assert_plan_legal(p, m, k, n)


@pytest.mark.parametrize("k,n", [(100, 128), (256, 96)])
def test_k2_plan_rejects_unaligned(k, n):
    with pytest.raises(ValueError, match="K % 64"):
        timm.indexed_matmul_plan(32, k, n)


def test_k2_forced_wgmma_config_needs_128_columns():
    assert timm.indexed_matmul_plan(256, 256, 192).config == 0
    with pytest.raises(ValueError, match="N % 128"):
        timm.indexed_matmul_plan(256, 256, 192, config=2)


def split_k_emulation(x, w_layer, splits):
    """The kernel's sum: one fp32 partial product per K slice, the partials
    added in slice (cluster rank) order, one rounding to bf16."""
    kslice = x.shape[1] // splits
    acc = torch.zeros(x.shape[0], w_layer.shape[1])
    for s in range(splits):
        sl = slice(s * kslice, (s + 1) * kslice)
        acc = acc + x[:, sl].float() @ w_layer[sl].float()
    return acc.bfloat16()


@pytest.mark.parametrize("m,k,n", [(32, 512, 128), (40, 256, 192),
                                   (256, 256, 256)])
def test_k2_split_k_order_matches_pallas(m, k, n):
    plan = timm.indexed_matmul_plan(m, k, n)
    assert plan.splits > 1
    r = np.random.RandomState(14)
    x = bf16_np(r.randn(m, k).astype(np.float32))
    w = bf16_np((r.randn(3, k, n) * k ** -0.5).astype(np.float32))
    xt, wt = t(x).bfloat16(), t(w).bfloat16()
    for idx in range(3):
        ref = pallas(jimm.indexed_matmul, jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), idx, block_k=128,
                     block_n=64, backend="pallas")
        got = split_k_emulation(xt, wt[idx], plan.splits).float().numpy()
        tol = K2_REL_TOL * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        plain = timm.indexed_matmul(xt, wt, torch.tensor(idx,
                                                         dtype=torch.int32))
        np.testing.assert_allclose(got, plain.float().numpy(), rtol=0,
                                   atol=tol)
