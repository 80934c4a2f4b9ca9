"""PyTorch port: the Hopper designs of K3 (int8) and K4 (int4) layer-indexed
matmuls, checked on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  What the CPU can hold is the arithmetic of
the design and the Python around it:

- The widen stage's bit operations (``csrc/indexed_matmul_quant.cu``
  ``widen16``), written out on numpy words with the kernel's byte-permute
  selectors and magic numbers: over all 256 int8 codes and all 256 packed
  int4 bytes (every low / high nibble pair) they give exactly
  ``float(code)``, in the kernel's column order.
- ``indexed_matmul_quant_plan`` for every deer_3b product at B = 1, 2, 3,
  4, 8 and 32 and for every forced block config, in K3 and K4; unaligned
  shapes raise.
- The kernel's summation order: 64-row K-tiles (K4: 32 packed rows, the low
  nibbles against x columns [k, k + 32) and the high ones against
  [K/2 + k, K/2 + k + 32)), one fp32 partial sum per K split added in
  cluster-rank order, the fp32 scale, one rounding to bf16; held against
  the Pallas ``_run_q8`` / ``_run_q4`` in interpret mode at every layer
  within 2^-7 max|y| (two bf16 ulps: both sides round an fp32 sum once, in
  different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.ops.pallas import indexed_matmul as jimm
from deer_vla_tpu_torch.ops import quant as tq
from deer_vla_tpu_torch.ops.kernels import indexed_matmul as timm

REL_TOL = 2 ** -7
DEER_3B_PRODUCTS = {"wqkv": (2048, 6144), "out_proj": (2048, 2048),
                    "mlp_up": (2048, 8192), "mlp_down": (8192, 2048)}
BK = 64  # product rows a K-tile


# ---------------------------------------------------------------------------
# the widen stage, bit for bit
# ---------------------------------------------------------------------------


def byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte n of the
    result is byte ``(sel >> 4n) & 7`` of the 8 bytes {y:x} (x bytes 0-3)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for n in range(4):
        pick = (sel >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * pick)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def as_f32(u):
    return np.asarray(u, np.uint32).view(np.float32)


def bf16_pairs(words):
    """uint32 words of two bf16 (low half first) -> their float values, in
    column order (low, high) along the last axis."""
    halves = np.stack([words & 0xFFFF, words >> 16], -1).astype(np.uint16)
    flat = torch.from_numpy(halves.view(np.int16).reshape(-1).copy())
    return flat.view(torch.bfloat16).float().numpy().reshape(halves.shape)


def widen_s8_reference(w):
    """The kernel's int8 widening of words w (4 codes each, byte j = column
    j): b ^ 0x80 into the mantissa of 2^23, minus (2^23 + 128) in fp32, and
    the upper halves of two fp32 values packed as one bf16 pair."""
    u = np.asarray(w, np.uint32) ^ np.uint32(0x80808080)
    f = [as_f32(byte_perm(u, 0x4B000000, 0x7540 | j)) - np.float32(8388736.0)
         for j in range(4)]
    pair = [byte_perm(f[0].view(np.uint32), f[1].view(np.uint32), 0x7632),
            byte_perm(f[2].view(np.uint32), f[3].view(np.uint32), 0x7632)]
    return np.concatenate([bf16_pairs(p) for p in pair], -1)


def minus136(words):
    """One packed bf16 subtraction of (136, 136) (exact on these values)."""
    halves = np.stack([words & 0xFFFF, words >> 16], -1).astype(np.uint16)
    v = torch.from_numpy(halves.view(np.int16).copy()).view(torch.bfloat16)
    return (v - torch.tensor(136.0, dtype=torch.bfloat16)).float().numpy()


def widen_s4_reference(w):
    """The kernel's int4 widening of words w (4 packed bytes, byte j =
    column j): bytes 2j, 2j + 1 spread to bytes 0 and 2, each nibble ^ 8
    into the mantissa of bf16 128, one packed subtraction of 136.  Returns
    (low nibbles, high nibbles), 4 columns each."""
    w = np.asarray(w, np.uint32)
    lo, hi = [], []
    for j in range(2):
        t = byte_perm(w, 0, 0x4342 if j else 0x4140)
        lo.append(minus136((t & 0x000F000F) ^ 0x43084308))
        hi.append(minus136(((t >> 4) & 0x000F000F) ^ 0x43084308))
    return np.concatenate(lo, -1), np.concatenate(hi, -1)


def words_of(codes):
    """int8 codes (n * 4,) -> little-endian uint32 words (n,)."""
    return np.ascontiguousarray(codes.astype(np.int8)).view(np.uint32)


def test_widen_int8_is_exact_for_every_code():
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    got = widen_s8_reference(words_of(codes)).reshape(-1)
    np.testing.assert_array_equal(got, codes.astype(np.float32))


def test_widen_int4_is_exact_for_every_nibble_pair():
    packed = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    lo, hi = widen_s4_reference(words_of(packed))
    rows = tq.unpack_int4(torch.from_numpy(packed)[None]).numpy()
    np.testing.assert_array_equal(lo.reshape(-1), rows[0].astype(np.float32))
    np.testing.assert_array_equal(hi.reshape(-1), rows[1].astype(np.float32))
    # and every one of the 16 nibbles appears in both halves
    assert set(lo.reshape(-1)) == set(hi.reshape(-1)) == set(range(-8, 8))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def assert_quant_plan_legal(p, m, k, n, q4):
    c = timm.QUANT_CONFIGS[p.config]
    assert (p.instruction, p.bm, p.bn, p.threads, p.stages) == tuple(c)
    code_rows = k // 2 if q4 else k
    tile_rows = BK // 2 if q4 else BK
    assert p.splits in (1, 2, 4, 8)
    assert code_rows % (p.splits * tile_rows) == 0
    assert p.k_slice * p.splits == k
    assert n % p.bn == 0 and p.strips == n // p.bn
    assert p.bm % p.splits == 0            # the cluster shares the rows out
    assert p.m_chunks * p.bm >= m and (p.m_chunks - 1) * p.bm < m
    assert p.stages >= 4
    assert p.threads <= 1024 and p.threads % 128 == 0
    assert p.smem == timm.quant_smem(c, q4) <= timm.SMEM_PER_BLOCK
    assert p.smem >= p.bm * (p.bn + 8) * 4   # the fp32 partial tile
    assert p.blocks == p.splits * p.m_chunks * p.strips
    if p.instruction == "mma.sync":
        assert p.blocks >= timm.H100_SMS or p.splits == timm.K2_MAX_SPLITS
    else:                                   # one wave of one block an SM
        assert p.splits <= 4
        assert p.blocks <= timm.H100_SMS or p.splits == 1


@pytest.mark.parametrize("q4", [False, True], ids=["q8", "q4"])
@pytest.mark.parametrize("streams", [1, 2, 3, 4, 8, 32])
@pytest.mark.parametrize("product", sorted(DEER_3B_PRODUCTS))
def test_quant_plan_is_legal_for_deer_3b(product, streams, q4):
    k, n = DEER_3B_PRODUCTS[product]
    m = 32 * streams
    p = timm.indexed_matmul_quant_plan(m, k, n, q4)
    assert_quant_plan_legal(p, m, k, n, q4)
    assert min(m, 256) <= p.bm             # all rows in one block up to 256
    if streams == 1:
        assert p.instruction == "mma.sync" and p.blocks >= timm.H100_SMS
    else:
        assert p.instruction == "wgmma"


@pytest.mark.parametrize("q4", [False, True], ids=["q8", "q4"])
@pytest.mark.parametrize("config", range(len(timm.QUANT_CONFIGS)))
@pytest.mark.parametrize("m", [32, 64, 96, 128, 256])
def test_quant_forced_configs_are_legal(config, m, q4):
    """Every block config at the row counts where chip_smoke.py checks and
    times them against each other."""
    for k, n in DEER_3B_PRODUCTS.values():
        p = timm.indexed_matmul_quant_plan(m, k, n, q4, config=config)
        assert p.config == config
        assert_quant_plan_legal(p, m, k, n, q4)


@pytest.mark.parametrize("q4", [False, True], ids=["q8", "q4"])
@pytest.mark.parametrize("k,n,match", [(100, 128, "K % 64"),
                                       (256, 96, "N % 64"),
                                       (256, 192, "N % 128")])
def test_quant_plan_rejects_unaligned(k, n, match, q4):
    config = 2 if match == "N % 128" else None  # a forced wgmma config
    with pytest.raises(ValueError, match=match):
        timm.indexed_matmul_quant_plan(256, k, n, q4, config=config)


def test_quant_plan_takes_mma_sync_where_n_is_not_a_multiple_of_128():
    for q4 in (False, True):
        assert timm.indexed_matmul_quant_plan(256, 256, 192, q4).config == 0


# ---------------------------------------------------------------------------
# the kernel's summation order against the Pallas kernels
# ---------------------------------------------------------------------------


def quant_split_k_emulation(x, codes, scale, splits, q4):
    """The kernel's sum for one layer: x bf16 (m, K); codes (K, N) int8 or
    (K/2, N) packed int4; per split an fp32 partial over 64-row K-tiles in
    order, the partials added in split (cluster rank) order, times the fp32
    scale, one rounding to bf16."""
    rows = codes.shape[0]
    tile = BK // 2 if q4 else BK
    rslice = rows // splits
    xf = x.float()
    acc = torch.zeros(x.shape[0], codes.shape[1])
    for sp in range(splits):
        part = torch.zeros_like(acc)
        for r in range(sp * rslice, (sp + 1) * rslice, tile):
            block = codes[r:r + tile]
            if q4:
                lo, hi = tq.unpack_nibbles(block)
                part = part + (xf[:, r:r + tile] @ lo.float()
                               + xf[:, rows + r:rows + r + tile] @ hi.float())
            else:
                part = part + xf[:, r:r + tile] @ block.float()
        acc = acc + part
    return (acc * scale.float()).bfloat16()


def pallas_quant(fn, x, wq, s, idx, **blocks):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()),
                             idx, backend="pallas", **blocks
                             ).astype(jnp.float32))


@pytest.mark.parametrize("q4", [False, True], ids=["q8", "q4"])
@pytest.mark.parametrize("m,k,n", [(32, 512, 128), (40, 256, 128),
                                   (256, 512, 256)])
def test_quant_split_k_order_matches_pallas(m, k, n, q4):
    plan = timm.indexed_matmul_quant_plan(m, k, n, q4)
    assert plan.splits > 1
    r = np.random.RandomState(15)
    x = torch.from_numpy(r.randn(m, k).astype(np.float32)).bfloat16()
    w = torch.from_numpy((r.randn(3, k, n) * k ** -0.5).astype(np.float32))
    if q4:
        wq, s = tq.quantize_weight4(w)
        fn, blocks = jimm.indexed_matmul_q4, {"block_kp": 64, "block_n": 128}
        wrapper = timm.indexed_matmul_q4
    else:
        wq, s = tq.quantize_weight(w)
        fn, blocks = jimm.indexed_matmul_q8, {"block_k": 128, "block_n": 128}
        wrapper = timm.indexed_matmul_q8
    for idx in range(3):
        ref = pallas_quant(fn, x.float().numpy(), wq, s, idx, **blocks)
        got = quant_split_k_emulation(x, wq[idx], s[idx], plan.splits,
                                      q4).float().numpy()
        tol = REL_TOL * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        plain = wrapper(x, wq, s, torch.tensor(idx, dtype=torch.int32))
        np.testing.assert_allclose(got, plain.float().numpy(), rtol=0,
                                   atol=tol)
