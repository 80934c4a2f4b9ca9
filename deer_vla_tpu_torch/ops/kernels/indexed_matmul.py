"""Layer-indexed matmuls over stacked (L, K, N) weights, with the layer
index ``idx`` read from a 0-dim int32 device tensor inside the kernel, so
choosing a layer costs no host sync:

  K2 ``indexed_matmul``     ``y = x @ W[idx]``;
  K3 ``indexed_matmul_q8``  ``y = (x @ Wq[idx]) * s[idx]``, Wq int8;
  K4 ``indexed_matmul_q4``  the same with Wq4 (L, K/2, N) nibble-packed
                            int4 (``ops.quant`` halves layout).

They replace the TPU kernels ``indexed_matmul``, ``indexed_matmul_q8`` and
``indexed_matmul_q4`` of ``deer_vla_tpu/ops/pallas/indexed_matmul.py``.  The
CUDA sources are ``deer_vla_tpu_torch/csrc/indexed_matmul.cu`` (K2) and
``indexed_matmul_quant.cu`` (K3, K4); their bounds on the card and what the
designs do about them are noted there.

Each wrapper launches its kernel for CUDA tensors and raises for anything
the kernel cannot take; for CPU tensors it runs its ``*_reference``, which
computes what the TPU kernel body computes (fp32 accumulation; for K3/K4
the scale applied in fp32 and one rounding to x.dtype).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from deer_vla_tpu_torch.ops.kernels.build import function
from deer_vla_tpu_torch.ops.quant import unpack_nibbles

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

K2_BK = 64                  # K-tile depth
K2_MAX_SPLITS = 8           # a portable thread-block cluster
H100_SMS = 132
SMEM_PER_BLOCK = 232_448    # 227 KB, the most a block can have on Hopper


class K2Config(NamedTuple):
    """One block configuration of csrc/indexed_matmul.cu (K2) or, in
    ``QUANT_CONFIGS``, of csrc/indexed_matmul_quant.cu (K3, K4)."""
    instruction: str    # "mma.sync" (warps) or "wgmma" (warpgroups)
    bm: int             # rows a block
    bn: int             # columns a block
    threads: int
    stages: int         # shared-memory ring depth

    @property
    def smem(self) -> int:
        """K2's dynamic shared bytes: the ring, or the fp32 partial tile that
        reuses it, whichever is larger (wgmma: + 1 KB to align the ring
        to its 1024-byte swizzle atoms)."""
        partials = self.bm * (self.bn + 8) * 4
        if self.instruction == "mma.sync":  # rows padded by 16 bytes
            ring = self.stages * (self.bm * (K2_BK + 8)
                                  + K2_BK * (self.bn + 8)) * 2
            return max(ring, partials)
        ring = self.stages * (self.bm + self.bn) * K2_BK * 2
        return max(ring, partials) + 1024


# in the order of the C++ dispatch (config 0-2)
K2_CONFIGS = (K2Config("mma.sync", 32, 64, 128, 4),
              K2Config("wgmma", 128, 128, 256, 4),
              K2Config("wgmma", 256, 128, 512, 4))


class Plan(NamedTuple):
    """How K2 (or K3 / K4) runs one bf16 product: block config, grid and
    shared bytes."""
    config: int
    instruction: str
    bm: int
    bn: int
    threads: int
    stages: int
    splits: int     # K split = cluster size; partials summed in rank order
    m_chunks: int
    strips: int
    smem: int
    blocks: int
    k_slice: int


@functools.lru_cache(maxsize=None)
def indexed_matmul_plan(m: int, k: int, n: int,
                        config: Optional[int] = None) -> Plan:
    """The tiling, split and grid of K2 for ``x (m, k) @ W (k, n)`` in bf16.

    A block keeps all ``m`` rows up to 256 (256-row chunks beyond), so at
    B <= 8 each weight byte is read from device memory once.  The block
    config is the one measured fastest for the row count (``chip_smoke.py``
    times each at 32-256 rows: PERF.md section 6): up to 32 rows (one
    stream) mma.sync warps, whose small blocks spread the weight stream
    over every SM; above, one wgmma warpgroup per 64 rows (mma.sync, which
    issues at about a third of the card's bf16 rate, was slower from 64
    rows on), and mma.sync also wherever N % 128 != 0.  K is split
    over a cluster of blocks: for mma.sync blocks in the fewest powers of
    two (at most 8) that put a block on each of the 132 SMs; for wgmma
    blocks (one fits an SM) in the most (at most 4) that keep the grid
    within one wave, since a cluster of 8 such blocks waits for 8 free SMs
    of one GPC.  ``config`` forces one of ``K2_CONFIGS`` instead."""
    if k % K2_BK or n % 64:
        raise ValueError(f"bf16 indexed_matmul needs K % {K2_BK} == 0 and "
                         f"N % 64 == 0, got K={k} N={n}")
    return _plan(K2_CONFIGS, m, k, n, config, lambda c: c.smem)


def _plan(configs, m: int, k: int, n: int, config: Optional[int],
          smem) -> Plan:
    """The config, split and grid of a layer-indexed product, as
    ``indexed_matmul_plan`` says; ``configs`` lists the mma.sync, 128-row
    and 256-row wgmma configs in that order."""
    if config is None:
        if m <= 32 or n % 128:
            config = 0
        elif m <= 128:
            config = 1
        else:
            config = 2
    c = configs[config]
    if n % c.bn:
        raise ValueError(f"config {config} needs N % {c.bn} == 0, got N={n}")
    chunks = -(-m // c.bm)
    strips = n // c.bn
    splits = 1

    def can_double():
        return (splits < K2_MAX_SPLITS and k % (2 * splits * K2_BK) == 0
                and c.bm % (2 * splits) == 0)

    if c.instruction == "mma.sync":
        while strips * chunks * splits < H100_SMS and can_double():
            splits *= 2
    else:
        while (splits < 4 and strips * chunks * splits * 2 <= H100_SMS
               and can_double()):
            splits *= 2
    return Plan(config, c.instruction, c.bm, c.bn, c.threads, c.stages,
                splits, chunks, strips, smem(c), splits * chunks * strips,
                k // splits)


def indexed_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``x @ W[idx]`` in x.dtype."""
    return x @ w[int(idx)].to(x.dtype)


def indexed_matmul(x: torch.Tensor, w: torch.Tensor,
                   idx: Union[int, torch.Tensor], *,
                   plan: Optional[Plan] = None) -> torch.Tensor:
    """``x (..., K) @ w (L, K, N)[idx] -> (..., N)``.  On the card ``idx``
    must be a 0-dim int32 tensor on the same device; in bf16, K % 64 == 0,
    N % 64 == 0, and x and w 16-byte aligned (x rows of any count).
    ``plan`` replaces ``indexed_matmul_plan``'s choice for a bf16 launch
    (``chip_smoke.py`` checks and times every block config with it)."""
    if w.ndim != 3 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match stacked w "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return indexed_matmul_reference(x, w, idx)
    if not x.is_cuda:
        raise ValueError(f"indexed_matmul: unsupported device {x.device}")
    if not (isinstance(idx, torch.Tensor) and idx.ndim == 0
            and idx.dtype == torch.int32 and idx.device == x.device):
        raise TypeError("idx must be a 0-dim int32 tensor on x's device")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x/w must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous on {x.device}")
    nl, kdim, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim).contiguous()
    m = x2.shape[0]
    config, splits = 0, 1
    if x.dtype == torch.bfloat16:
        plan = plan or indexed_matmul_plan(m, kdim, n)
        config, splits = plan.config, plan.splits
        if x2.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("bf16 indexed_matmul needs 16-byte aligned x "
                             "and w")
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    err = function("deer_indexed_matmul", _ARGTYPES)(
        x2.data_ptr(), w.data_ptr(), idx.data_ptr(), y.data_ptr(), m, kdim,
        n, nl, _DTYPE_CODE[x.dtype], config, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"indexed_matmul launch failed: CUDA error {err}")
    indexed_matmul.launches += 1
    return y.reshape(*lead, n)


indexed_matmul.launches = 0


# ---------------------------------------------------------------------------
# K3 / K4: int8 and nibble-packed int4 weights with per-column fp32 scales
# ---------------------------------------------------------------------------

_Q_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

# in the order of the C++ dispatch of csrc/indexed_matmul_quant.cu (0-2)
QUANT_CONFIGS = (K2Config("mma.sync", 32, 64, 384, 4),
                 K2Config("wgmma", 128, 128, 256, 4),
                 K2Config("wgmma", 256, 128, 512, 4))


def quant_smem(c: K2Config, q4: bool) -> int:
    """Dynamic shared bytes of a K3 (``q4`` False) or K4 block: the ring of
    x tiles (BM x 64 bf16) and code tiles (64 int8 rows, or 32 packed int4
    rows, x BN bytes) plus two widened bf16 tiles (64 x BN), or the fp32
    partial tile that reuses them, whichever is larger."""
    code_rows = K2_BK // 2 if q4 else K2_BK
    partials = c.bm * (c.bn + 8) * 4
    if c.instruction == "mma.sync":  # x and widened rows padded by 16 bytes
        ring = (c.stages * (c.bm * (K2_BK + 8) * 2 + code_rows * c.bn)
                + 2 * K2_BK * (c.bn + 8) * 2)
        return max(ring, partials)
    ring = (c.stages * (c.bm * K2_BK * 2 + code_rows * c.bn)
            + 2 * K2_BK * c.bn * 2)
    return max(ring, partials) + 1024


@functools.lru_cache(maxsize=None)
def indexed_matmul_quant_plan(m: int, k: int, n: int, q4: bool,
                              config: Optional[int] = None) -> Plan:
    """The tiling, split and grid of K3 (``q4`` False: int8 codes) or K4
    (``q4`` True: packed int4) for ``x (m, k) @ Wq (k, n)`` in bf16; ``k``
    is x's width (K4's packed stack has k / 2 rows).  A K-tile is 64 rows
    of the product (64 int8 rows, or 32 packed rows paired with two 32-
    column x tiles), so the rules and the split are K2's: K % 64 == 0,
    N % 64 == 0, mma.sync blocks up to 32 rows and wgmma above, K split
    over a cluster (``indexed_matmul_plan``).  ``config`` forces one of
    ``QUANT_CONFIGS`` (``chip_smoke.py`` checks and times each)."""
    if k % K2_BK or n % 64:
        raise ValueError(f"bf16 indexed_matmul_q{4 if q4 else 8} needs "
                         f"K % {K2_BK} == 0 and N % 64 == 0, got K={k} N={n}")
    return _plan(QUANT_CONFIGS, m, k, n, config, lambda c: quant_smem(c, q4))


def indexed_matmul_q8_reference(x: torch.Tensor, wq: torch.Tensor,
                                s: torch.Tensor,
                                idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x @ Wq[idx]) * s[idx]``: fp32 products and sum, the scale in fp32,
    one rounding to x.dtype."""
    i = int(idx)
    return ((x.float() @ wq[i].float()) * s[i].float()).to(x.dtype)


def indexed_matmul_q4_reference(x: torch.Tensor, wq4: torch.Tensor,
                                s: torch.Tensor,
                                idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """``(x @ unpack(Wq4[idx])) * s[idx]`` as two fp32 products against the
    x halves (low nibbles with x[..., :K/2], high with x[..., K/2:]), the
    scale in fp32, one rounding to x.dtype."""
    i = int(idx)
    kp = wq4.shape[1]
    lo, hi = unpack_nibbles(wq4[i])
    x32 = x.float()
    y = x32[..., :kp] @ lo.float() + x32[..., kp:] @ hi.float()
    return (y * s[i].float()).to(x.dtype)


def _launch_quantized(fn_name: str, x: torch.Tensor, wq: torch.Tensor,
                      s: torch.Tensor, idx: torch.Tensor, kdim: int,
                      plan: Optional[Plan]) -> torch.Tensor:
    """Checks and launch shared by K3 and K4 (``wq`` holds K or K/2 rows)."""
    if not x.is_cuda:
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    if not (isinstance(idx, torch.Tensor) and idx.ndim == 0
            and idx.dtype == torch.int32 and idx.device == x.device):
        raise TypeError("idx must be a 0-dim int32 tensor on x's device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn_name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    nl, rows, n = wq.shape
    if wq.dtype != torch.int8 or s.dtype != torch.float32 \
            or s.shape != (nl, n):
        raise TypeError(f"{fn_name}: want int8 weights and (L, N) float32 "
                        f"scales, got {wq.dtype} {tuple(wq.shape)} / "
                        f"{s.dtype} {tuple(s.shape)}")
    for t in (wq, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{fn_name}: weights and scales must be "
                             f"contiguous on {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim).contiguous()
    m = x2.shape[0]
    config, splits = 0, 1
    if x.dtype == torch.bfloat16:
        plan = plan or indexed_matmul_quant_plan(m, kdim, n, rows != kdim)
        config, splits = plan.config, plan.splits
        if x2.data_ptr() % 16 or wq.data_ptr() % 16 or s.data_ptr() % 16:
            raise ValueError(f"bf16 {fn_name} needs 16-byte aligned x, "
                             "weights and scales")
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    err = function(f"deer_{fn_name}", _Q_ARGTYPES)(
        x2.data_ptr(), wq.data_ptr(), s.data_ptr(), idx.data_ptr(),
        y.data_ptr(), m, kdim, n, nl, _DTYPE_CODE[x.dtype], config, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return y.reshape(*lead, n)


def indexed_matmul_q8(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                      idx: Union[int, torch.Tensor], *,
                      plan: Optional[Plan] = None) -> torch.Tensor:
    """``(x (..., K) @ wq (L, K, N)[idx]) * s (L, N)[idx] -> (..., N)`` with
    int8 weights.  On the card ``idx`` must be a 0-dim int32 tensor on the
    same device; in bf16, K % 64 == 0, N % 64 == 0 and x, wq and s 16-byte
    aligned (x rows of any count).  ``plan`` replaces
    ``indexed_matmul_quant_plan``'s choice for a bf16 launch."""
    if wq.ndim != 3 or x.shape[-1] != wq.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match stacked int8 "
                         f"weights {tuple(wq.shape)}")
    if x.device.type == "cpu":
        return indexed_matmul_q8_reference(x, wq, s, idx)
    y = _launch_quantized("indexed_matmul_q8", x, wq, s, idx, wq.shape[1],
                          plan)
    indexed_matmul_q8.launches += 1
    return y


def indexed_matmul_q4(x: torch.Tensor, wq4: torch.Tensor, s: torch.Tensor,
                      idx: Union[int, torch.Tensor], *,
                      plan: Optional[Plan] = None) -> torch.Tensor:
    """``(x (..., K) @ unpack(wq4 (L, K/2, N)[idx])) * s (L, N)[idx]`` with
    nibble-packed int4 weights; the rest as ``indexed_matmul_q8``."""
    if wq4.ndim != 3 or x.shape[-1] != 2 * wq4.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match stacked packed "
                         f"int4 weights {tuple(wq4.shape)}")
    if x.device.type == "cpu":
        return indexed_matmul_q4_reference(x, wq4, s, idx)
    y = _launch_quantized("indexed_matmul_q4", x, wq4, s, idx,
                          2 * wq4.shape[1], plan)
    indexed_matmul_q4.launches += 1
    return y


indexed_matmul_q8.launches = 0
indexed_matmul_q4.launches = 0
