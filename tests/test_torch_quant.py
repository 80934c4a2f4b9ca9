"""PyTorch port, quantized serving: ``ops/quant.py``, the quantized
``linear`` branches, the K3 / K4 plain versions, the quantized stacked
decoder and perceiver, and ``ScanDeerPolicy(quantize=...)``, each against
the JAX package on the same numpy inputs, on the CPU.

Quantization must equal the JAX package's bit for bit.  The K3 / K4 plain
versions are held against the Pallas kernels in TPU interpret mode: fp32
within rtol 2e-5 / atol 2e-4 (tests/test_pallas.py's tolerance), bf16
within two ulps of max|y| (2^-7 max|y|; both sides round an fp32 sum once,
in different orders).  The policies must agree on every stream's exit layer
and on actions and carry within 2e-4 (tests/test_torch_scan_policy.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval import scan_policy as jsp
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu.models import perceiver as jperceiver
from deer_vla_tpu.ops import layers as jlayers
from deer_vla_tpu.ops import quant as jq
from deer_vla_tpu.ops.pallas import indexed_matmul as jimm
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval import scan_policy as tsp
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.models import perceiver as tperceiver
from deer_vla_tpu_torch.ops import layers as tlayers
from deer_vla_tpu_torch.ops import quant as tq
from deer_vla_tpu_torch.ops.kernels import indexed_matmul as timm

from test_torch_scan_policy import (THRESHOLDS, assert_same_carry,
                                    make_params, obs)

TOL = dict(rtol=2e-4, atol=2e-4)
# The w8a8 modes round every activation to int8 per row, which is not
# continuous: an activation within an fp32 ulp of a rounding tie (seen:
# -59.500004 in units of its row's scale, at B=4) takes a different code
# when the two frameworks' fp32 sums differ in the last bit, and that one
# code moves one stream's carry by up to 1.8e-3 (B=4, seeds 10-42).  At B=4
# there are enough activations that such a tie turns up at every seed tried,
# so the w8a8 carry at B=4 is held to 5e-3; exits and actions at B=4, and
# everything at B=1, hold TOL.
W8A8_B4_CARRY_TOL = dict(rtol=0, atol=5e-3)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def t(a):
    return torch.from_numpy(np.array(a))


def jnp_tree(tree):
    return jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree)


def assert_same_tree(port, ref):
    """Equal structure, keys, dtypes and values (bit for bit)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            assert_same_tree(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert_same_tree(a, b)
    else:
        ref = np.asarray(ref)
        assert str(port.dtype).replace("torch.", "") == ref.dtype.name
        np.testing.assert_array_equal(port.numpy(), ref)


# ---------------------------------------------------------------------------
# quantize_weight / quantize_weight4 / unpack_int4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 40), (3, 128, 24), (2, 3, 32, 16)])
def test_quantize_weight_bit_equal_to_jax(shape, dtype):
    r = np.random.RandomState(0)
    w = (r.randn(*shape) * r.rand(shape[-1]) * 3).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero column: scale floored at 1e-12
    tdt, jdt = DTYPES[dtype]
    wt, wj = t(w).to(tdt), jnp.asarray(w).astype(jdt)
    q, s = tq.quantize_weight(wt)
    qj, sj = jq.quantize_weight(wj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert_same_tree({"q": q, "s": s}, {"q": qj, "s": sj})
    assert not q[..., 5].any() and (s[..., 5] == np.float32(1e-12)).all()
    q4, s4 = tq.quantize_weight4(wt)
    q4j, s4j = jq.quantize_weight4(wj)
    assert q4.shape == shape[:-2] + (shape[-2] // 2, shape[-1])
    assert_same_tree({"q4": q4, "s4": s4}, {"q4": q4j, "s4": s4j})
    assert_same_tree(tq.unpack_int4(q4), jq.unpack_int4(q4j))
    np.testing.assert_array_equal(
        tq.dequantize_weight4(q4, s4).numpy(),
        np.asarray(jq.dequantize_weight4(q4j, s4j)))
    np.testing.assert_array_equal(tq.dequantize_weight(q, s).numpy(),
                                  np.asarray(jq.dequantize_weight(qj, sj)))


def test_int4_pack_unpack_roundtrip_every_code():
    codes = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(codes, codes, indexing="ij")).reshape(2, 256)
    q = np.concatenate([q[:1], q[1:]], axis=0)  # rows: low, high
    packed = tq.pack_int4(t(q))
    assert packed.shape == (1, 256) and packed.dtype == torch.int8
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    # the same bytes as the JAX package's shift-and-or packing
    ref = ((q[1].astype(np.int16) << 4) | (q[0] & 0x0F)).astype(np.int8)
    np.testing.assert_array_equal(packed.numpy()[0], ref)
    with pytest.raises(AssertionError):
        tq.quantize_weight4(torch.ones(3, 4))


# ---------------------------------------------------------------------------
# quantize_tree / quantize_serving_stacked on deer_tiny's stacked tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_stacks():
    """The JAX and the port's stacked serving trees of the same deer_tiny
    weights."""
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    params = make_params(jcfg)
    js = jsp.stack_decoder_layers(jax.tree.map(jnp.asarray, params), jcfg,
                                  include_encoders=True)
    ts = tsp.stack_decoder_layers(to_torch(params, "cpu"), tcfg,
                                  include_encoders=True)
    return js, ts


@pytest.mark.parametrize("parts", ["all", "decoder", "vision"])
@pytest.mark.parametrize("mode", tq.QUANT_MODES)
def test_quantize_serving_stacked_matches_jax(tiny_stacks, mode, parts):
    js, ts = tiny_stacks
    got = tq.quantize_serving_stacked(ts, mode, parts=parts)
    ref = jq.quantize_serving_stacked(js, mode, parts=parts)
    for k in tq.SERVING_QUANT_PARTS:
        if k in ref:
            assert_same_tree(got[k], ref[k])
            if k not in tq.QUANT_PART_GROUPS[parts]:
                assert got[k] is ts[k]  # untouched subtrees are not copied
    assert got["layer_idx"] is ts["layer_idx"]
    assert tq.quantize_serving_stacked(ts, None) is ts
    assert tq.quantize_serving_stacked(ts, "none") is ts


@pytest.mark.parametrize("mode,even,odd", [
    ("int8", {"q", "s"}, {"q", "s"}),
    ("int8_w8a8", {"q", "s8"}, {"q", "s8"}),
    ("int4", {"q4", "s4"}, {"q", "s"}),           # odd K: int8
    ("int4_w8a8", {"q4", "s48"}, {"q", "s8"}),    # odd K: w8a8
])
def test_quantize_tree_odd_k_fallbacks(mode, even, odd):
    r = np.random.RandomState(1)
    tree = {"blocks": {"mlp": {"w": r.randn(2, 16, 8).astype(np.float32),
                               "b": r.randn(2, 8).astype(np.float32)},
                       "odd": {"w": r.randn(2, 15, 8).astype(np.float32)},
                       "ln": {"scale": np.ones((2, 8), np.float32)}},
            "has_xattn": np.ones((2,), np.bool_)}
    got = tq.quantize_serving_stacked(to_torch(tree, "cpu"), mode)
    ref = jq.quantize_serving_stacked(jax.tree.map(jnp.asarray, tree), mode)
    assert set(got["blocks"]["mlp"]) == even | {"b"}
    assert set(got["blocks"]["odd"]) == odd
    assert_same_tree(got["blocks"], ref["blocks"])
    assert tq.tree_bytes(got["blocks"]) == jq.tree_bytes(ref["blocks"])


@pytest.mark.parametrize("mode,parts", [
    ("int3", "all"), ("fp8", "all"), ("int8", "nope"),
    ("int8", ("blocks", "bogus")),
])
def test_unknown_mode_or_parts_raise(tiny_stacks, mode, parts):
    _, ts = tiny_stacks
    with pytest.raises(ValueError):
        tq.quantize_serving_stacked(ts, mode, parts=parts)


# ---------------------------------------------------------------------------
# linear: q, q4, s8, s48
# ---------------------------------------------------------------------------


def quantized_linear_params(kind, r, k=128, n=64):
    w = t((r.randn(k, n) * 0.05).astype(np.float32))
    b = t(r.randn(n).astype(np.float32))
    if kind in ("q", "s8"):
        q, s = tq.quantize_weight(w)
        return {"q": q, "s" if kind == "q" else "s8": s, "b": b}
    q4, s = tq.quantize_weight4(w)
    return {"q4": q4, "s4" if kind == "q4" else "s48": s, "b": b}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["q", "q4", "s8", "s48"])
def test_linear_quantized_matches_jax(kind, dtype):
    r = np.random.RandomState(2)
    p = quantized_linear_params(kind, r)
    x = r.randn(2, 5, 128).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    got = tlayers.linear(p, t(x).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 5, 64)
    ref = jax.jit(jlayers.linear)(jnp_tree(p), jnp.asarray(x).astype(jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    else:  # one bf16 ulp of max|y| for a flipped rounding
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2 ** -8 * np.abs(ref).max())


def test_int8_matmul_is_exact():
    r = np.random.RandomState(3)
    a = r.randint(-127, 128, (3, 5, 64)).astype(np.int8)
    b = r.randint(-127, 128, (64, 24)).astype(np.int8)
    got = tlayers.int8_matmul(t(a), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# ---------------------------------------------------------------------------
# K3 / K4 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def pallas_quantized(fn, x, wq, s, idx, **blocks):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(x, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()),
                             idx, backend="pallas", **blocks
                             ).astype(jnp.float32))


def close_kernel(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,kdim,n,blk", [
    (32, 256, 384, (128, 128)),   # multi k/n tiles
    (7, 256, 128, (256, 128)),    # M padding
    (16, 512, 256, (512, 256)),   # single k tile
])
def test_indexed_matmul_q8_reference_matches_pallas(m, kdim, n, blk, dtype):
    r = np.random.RandomState(4)
    x = r.randn(m, kdim).astype(np.float32)
    wq, s = tq.quantize_weight(t(r.randn(3, kdim, n).astype(np.float32)))
    tdt, jdt = DTYPES[dtype]
    for idx in range(3):
        ref = pallas_quantized(jimm.indexed_matmul_q8,
                               jnp.asarray(x).astype(jdt), wq, s, idx,
                               block_k=blk[0], block_n=blk[1])
        got = timm.indexed_matmul_q8_reference(t(x).to(tdt), wq, s, idx)
        assert got.dtype == tdt
        close_kernel(got, ref, dtype)
        idx_t = torch.tensor(idx, dtype=torch.int32)
        close_kernel(timm.indexed_matmul_q8(t(x).to(tdt), wq, s, idx_t), ref,
                     dtype)
    assert timm.indexed_matmul_q8.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,kdim,n,blk", [
    (32, 256, 384, (64, 128)),    # multi packed-k/n tiles
    (7, 256, 128, (128, 128)),    # M padding + single packed-k tile
])
def test_indexed_matmul_q4_reference_matches_pallas(m, kdim, n, blk, dtype):
    r = np.random.RandomState(5)
    x = r.randn(m, kdim).astype(np.float32)
    wq4, s = tq.quantize_weight4(t(r.randn(3, kdim, n).astype(np.float32)))
    tdt, jdt = DTYPES[dtype]
    for idx in range(3):
        ref = pallas_quantized(jimm.indexed_matmul_q4,
                               jnp.asarray(x).astype(jdt), wq4, s, idx,
                               block_kp=blk[0], block_n=blk[1])
        got = timm.indexed_matmul_q4_reference(t(x).to(tdt), wq4, s, idx)
        assert got.dtype == tdt
        close_kernel(got, ref, dtype)
        idx_t = torch.tensor(idx, dtype=torch.int32)
        close_kernel(timm.indexed_matmul_q4(t(x).to(tdt), wq4, s, idx_t),
                     ref, dtype)
    assert timm.indexed_matmul_q4.launches == 0


@pytest.mark.parametrize("kernel", ["q8", "q4"])
def test_quantized_wrappers_check_shapes_and_never_fall_back(kernel):
    fn = getattr(timm, f"indexed_matmul_{kernel}")
    rows = 64 if kernel == "q8" else 32
    x = torch.randn(2, 3, 64)
    wq = torch.randint(-7, 8, (4, rows, 16), dtype=torch.int8)
    s = torch.rand(4, 16)
    y = fn(x, wq, s, torch.tensor(2, dtype=torch.int32))
    assert y.shape == (2, 3, 16)
    with pytest.raises(ValueError):
        fn(x[..., :48], wq, s, 0)
    # a tensor neither on the CPU nor on the card raises
    meta = [v.to("meta") for v in (x, wq, s)]
    with pytest.raises(ValueError):
        fn(meta[0], meta[1], meta[2], 0)
    # the card's bf16 rules: K % 64 == 0 and N % 64 == 0 (this 16-column
    # stack runs only on the CPU), any row count, no padding
    q4 = kernel == "q4"
    with pytest.raises(ValueError, match="N % 64"):
        timm.indexed_matmul_quant_plan(6, 64, 16, q4)
    with pytest.raises(ValueError, match="K % 64"):
        timm.indexed_matmul_quant_plan(6, 96, 64, q4)
    plan = timm.indexed_matmul_quant_plan(6, 64, 64, q4)
    assert plan.m_chunks == 1 and plan.k_slice * plan.splits == 64


# ---------------------------------------------------------------------------
# stacked decoder block and perceiver on quantized stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", tq.QUANT_MODES)
def test_mpt_block_forward_stacked_quantized_matches_jax(tiny_stacks, mode):
    js, ts = tiny_stacks
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    jb = jq.quantize_serving_stacked(js, mode)["blocks"]
    tb = tq.quantize_serving_stacked(ts, mode)["blocks"]
    r = np.random.RandomState(6)
    x = (r.randn(2, tcfg.text_len, tcfg.mpt.d_model) * 0.5).astype(np.float32)
    mask = np.ones((2, tcfg.text_len), np.int32)
    mask[1, -3:] = 0
    jbias = jmpt.make_attn_bias(jnp.asarray(mask), jcfg.mpt, jnp.float32)
    tbias = tmpt.make_attn_bias(t(mask), tcfg.mpt, torch.float32)
    for i in range(tcfg.n_layers):
        ref = jmpt.mpt_block_forward_stacked(jb, i, jnp.asarray(x), jbias,
                                             jcfg.mpt)
        got = tmpt.mpt_block_forward_stacked(tb, i, t(x), tbias, tcfg.mpt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", tq.QUANT_MODES)
def test_perceiver_forward_stacked_quantized_matches_jax(tiny_stacks, mode):
    """The perceiver counts its layers from a leaf that quantization leaves
    alone: a quantized stack has no ``to_q.w``."""
    js, ts = tiny_stacks
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    jst = jq.quantize_serving_stacked(js, mode)
    tst = tq.quantize_serving_stacked(ts, mode)
    assert "w" not in tst["perceiver"]["to_q"]
    params = jax.tree.map(np.asarray, make_params(jcfg)["perceiver"])
    r = np.random.RandomState(7)
    p = tcfg.perceiver
    x = r.randn(2, 1, 1, 9, p.dim).astype(np.float32)
    ref = jperceiver.perceiver_forward_stacked(
        jax.tree.map(jnp.asarray, params), jst["perceiver"], jnp.asarray(x),
        jcfg.perceiver)
    got = tperceiver.perceiver_forward_stacked(
        to_torch(params, "cpu"), tst["perceiver"], t(x), p)
    assert got.shape == (2, 1, p.num_latents, p.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# ScanDeerPolicy(quantize=...) against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized_policies():
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    params = make_params(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    pols = {}
    for mode in tq.QUANT_MODES:
        for imm in (False, True):
            pols[mode, imm] = (
                jsp.ScanDeerPolicy(jp, jcfg, indexed_mm=imm, quantize=mode),
                tsp.ScanDeerPolicy(params, tcfg, indexed_mm=imm,
                                   quantize=mode, device="cpu"))
    return tcfg, params, pols


@pytest.mark.parametrize("indexed_mm", [False, True])
@pytest.mark.parametrize("mode", tq.QUANT_MODES)
def test_quantized_policy_matches_jax(quantized_policies, mode, indexed_mm):
    tcfg, _, pols = quantized_policies
    jpol, tpol = pols[mode, indexed_mm]
    for th in THRESHOLDS:
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for step in range(3):
            img, grip, ids, mask = obs(tcfg, 1, seed=step)
            a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                            jnp.asarray(ids), jnp.asarray(mask))
            a_t = tpol.step(img, grip, ids, mask)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(a_t, a_j, **TOL)
            assert_same_carry(jpol, tpol)
    # B=4 with one threshold row per stream
    carry_tol = W8A8_B4_CARRY_TOL if mode.endswith("w8a8") else TOL
    rows = THRESHOLDS + [[0.02, 1e8]]
    jpol.set_thresholds_batch(rows)
    tpol.set_thresholds_batch(rows)
    for p in (jpol, tpol):
        p.reset()
    for step in range(3):
        img, grip, ids, mask = obs(tcfg, 4, seed=10 + step)
        acts_j, ex_j = jpol.step_batch(jnp.asarray(img), jnp.asarray(grip),
                                       jnp.asarray(ids), jnp.asarray(mask))
        acts_t, ex_t = tpol.step_batch(img, grip, ids, mask)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
        for cj, ct in zip(jpol.carry, tpol.carry):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                       **carry_tol)


@pytest.mark.parametrize("mode,limit", [("int8", 0.62), ("int4", 0.4)])
def test_quantized_policy_tree_is_smaller(quantized_policies, mode, limit):
    tcfg, params, pols = quantized_policies
    full = tsp.ScanDeerPolicy(params, tcfg, device="cpu")
    tpol = pols[mode, True][1]
    assert tq.tree_bytes(tpol.stacked) < limit * tq.tree_bytes(full.stacked)
    leaves = tpol.stacked["blocks"]["wqkv"]
    assert leaves[{"int8": "q", "int4": "q4"}[mode]].dtype == torch.int8
    # the embedding and the exit head stay in full precision
    assert tpol.params["decoder"]["wte"]["w"].dtype == torch.float32

