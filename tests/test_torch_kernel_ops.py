"""PyTorch port, the kernels K1-K4 as ``torch.library`` operators
(``deer::flash_attention``, ``deer::flash_attention_with_stats``,
``deer::indexed_matmul`` / ``_q8`` / ``_q4``): ``torch.library.opcheck`` on
CPU tensors at small shapes (the schema, the fake implementation against
the CPU one, the autograd registration and ``aot_autograd``'s trace of
forward and, for K1 with its statistics, backward), and each Python entry
reaching its operator.  The CPU implementations are the plain versions
(``tests/test_torch_ops.py`` and ``tests/test_torch_quant.py`` hold them
to the Pallas kernels).
"""

import numpy as np
import pytest
import torch

from deer_vla_tpu_torch.ops.kernels import flash_attention as k1
from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def rand(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32)).to(dtype)


def attention_inputs(with_bias, dtype=torch.float32, grad=False):
    q, k, v = (rand(2, 3, 130, 16, seed=i, dtype=dtype) for i in range(3))
    bias = rand(2, 1, 130, 130, seed=3, dtype=dtype) if with_bias else None
    if grad:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_operator(with_bias, dtype):
    q, k, v, bias = attention_inputs(with_bias, dtype)
    torch.library.opcheck(torch.ops.deer.flash_attention.default,
                          (q, k, v, bias, 0.25))
    assert torch.equal(k1.flash_attention(q, k, v, bias, 0.25),
                       k1.flash_attention_reference(q, k, v, bias, 0.25))


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_with_stats_operator_and_gradient(with_bias):
    """The statistics variant, with q, k and v requiring grad: its
    registered gradient (``flash_attention_backward``) is traced and run
    by opcheck, and equals autograd through the plain forward."""
    q, k, v, bias = attention_inputs(with_bias, grad=True)
    torch.library.opcheck(torch.ops.deer.flash_attention_with_stats.default,
                          (q, k, v, bias, 0.25))
    out, stats = k1.flash_attention_with_stats(q, k, v, bias, 0.25)
    assert stats.shape == (2, 2, 3, 130) and stats.dtype == torch.float32
    dout = rand(*q.shape, seed=9)
    got = torch.autograd.grad(k1.flash_attention(q, k, v, bias, 0.25),
                              (q, k, v), dout)
    want = torch.autograd.grad(
        k1.flash_attention_reference(q, k, v, bias, 0.25), (q, k, v), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_flash_attention_refuses_a_bias_that_requires_grad():
    q, k, v, bias = attention_inputs(True, grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        k1.flash_attention(q, k, v, bias.requires_grad_(), 0.25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_indexed_matmul_operator(dtype):
    x, w = rand(2, 5, 64, dtype=dtype), rand(3, 64, 128, seed=1, dtype=dtype)
    idx = torch.tensor(2, dtype=torch.int32)
    torch.library.opcheck(torch.ops.deer.indexed_matmul.default, (x, w, idx))
    assert torch.equal(imm.indexed_matmul(x, w, idx),
                       imm.indexed_matmul_reference(x, w, 2))


def quantized(q4):
    """(codes, scales) of a stack of 3 (64, 128) weights: int8 codes, or
    int4 packed two a byte (any byte is a pair of codes)."""
    r = np.random.RandomState(4)
    lo, hi = (-128, 128) if q4 else (-127, 128)
    codes = r.randint(lo, hi, (3, 32 if q4 else 64, 128)).astype(np.int8)
    return (torch.from_numpy(codes),
            torch.from_numpy(r.rand(3, 128).astype(np.float32)))


@pytest.mark.parametrize("q4", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_indexed_matmul_operators(q4, dtype):
    x = rand(7, 64, dtype=dtype)
    wq, s = quantized(q4)
    idx = torch.tensor(1, dtype=torch.int32)
    op = (torch.ops.deer.indexed_matmul_q4 if q4
          else torch.ops.deer.indexed_matmul_q8).default
    torch.library.opcheck(op, (x, wq, s, idx))
    entry, ref = ((imm.indexed_matmul_q4, imm.indexed_matmul_q4_reference)
                  if q4 else (imm.indexed_matmul_q8,
                              imm.indexed_matmul_q8_reference))
    assert torch.equal(entry(x, wq, s, 1), ref(x, wq, s, 1))


def test_entries_are_traced_as_their_operators():
    """``torch.export`` records each Python entry as its ``deer::`` node
    (the plan arguments at their defaults), and the CPU launch counters
    stay at zero."""
    wq, s = quantized(False)
    wq4, _ = quantized(True)

    class M(torch.nn.Module):
        def forward(self, q, x, w, idx):
            return (k1.flash_attention(q, q, q),
                    imm.indexed_matmul(x, w, idx),
                    imm.indexed_matmul_q8(x, wq, s, idx),
                    imm.indexed_matmul_q4(x, wq4, s, idx))

    args = (rand(1, 2, 130, 16), rand(4, 64), rand(3, 64, 128, seed=1),
            torch.tensor(0, dtype=torch.int32))
    with torch.no_grad():
        ep = torch.export.export(M(), args, strict=False)
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert [o for o in ops if o.startswith("deer.")] == [
        "deer.flash_attention.default", "deer.indexed_matmul.default",
        "deer.indexed_matmul_q8.default", "deer.indexed_matmul_q4.default"]
    for got, want in zip(ep.module()(*args), M()(*args)):
        assert torch.equal(got, want)
    assert k1.flash_attention.launches == imm.indexed_matmul.launches == 0
    assert imm.indexed_matmul_q8.launches == imm.indexed_matmul_q4.launches \
        == 0
