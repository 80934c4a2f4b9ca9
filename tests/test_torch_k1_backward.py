"""PyTorch port, the gradient of K1 (``flash_attention_backward`` and its
plain version ``flash_attention_backward_reference``, the autograd function
``flash_attention`` takes on the card) against autograd through the plain
forward and against JAX's gradient of the JAX package's attention
(``ops/attention._xla_attention``: its Pallas kernel has no backward), on
the CPU.

The shapes are those the port trains through K1 at test width: the ViT's
self-attention without bias, the decoder's with its ALiBi + causal +
padding bias (B, H, S, S), and the cross-attention's (B, 1, Sq, Sk) media
bias with rows masked everywhere; Sq != Sk and head dims that are not a
multiple of 32; and Sq = 70, Sk = 130, which leave ragged 64-row tiles on
both sides of the bf16 kernels.  The backward reads the forward's row
statistics (max m and 1 / l, ``flash_attention_with_stats``); the plain
version given them equals the one that recomputes them.

Tolerances: fp32 within 1e-5 of each gradient's largest entry (other
summation orders); the plain backward in bf16 against fp32 autograd within
2e-2 of the largest entry (bf16 inputs and outputs, as chip_smoke.py's
K1_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.ops import attention as jattn
from deer_vla_tpu_torch.ops.alibi import full_attn_bias
from deer_vla_tpu_torch.ops.kernels import flash_attention as k1

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FP32_TOL = 1e-5
BF16_TOL = 2e-2


def case(name, seed=0):
    """(q, k, v, bias, scale) as numpy, fp32."""
    r = np.random.RandomState(seed)

    def rand(*shape):
        return r.randn(*shape).astype(np.float32)

    if name == "vit":
        b, h, sq, sk, d, bias = 2, 4, 17, 17, 16, None
    elif name == "decoder":
        b, h, sq, sk, d = 2, 4, 20, 20, 32
        mask = torch.ones(b, sq, dtype=torch.int64)
        mask[1, 14:] = 0
        bias = full_attn_bias(mask, h, sq, 8.0).numpy()
    elif name == "xattn":
        b, h, sq, sk, d = 2, 3, 12, 24, 48
        bias = np.zeros((b, 1, sq, sk), np.float32)
        bias[:, :, :, 16:] = -1e9
        bias[:, :, :3, :] = -1e9  # text before the media token
    elif name == "tails":
        b, h, sq, sk, d = 1, 2, 70, 130, 64
        bias = r.randn(b, h, sq, sk).astype(np.float32)
        bias[:, :, 5, :] = -1e9
    else:
        raise ValueError(name)
    return (rand(b, h, sq, d), rand(b, h, sk, d), rand(b, h, sk, d), bias,
            d ** -0.5)


CASES = ["vit", "decoder", "xattn", "tails"]


def autograd_grads(q, k, v, bias, scale, dout, dtype=torch.float32):
    """dq, dk, dv by autograd through the plain forward, and its output."""
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    b = None if bias is None else torch.tensor(bias, dtype=dtype)
    out = k1.flash_attention_reference(*ts, b, scale)
    grads = torch.autograd.grad(out, ts, torch.tensor(dout, dtype=dtype))
    return [g.float().numpy() for g in grads], out.detach()


def assert_close(got, want, tol, what):
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        g = np.asarray(g, np.float32)
        err = np.abs(g - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (what, n, err)


@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_autograd_and_jax(name):
    """fp32: the plain backward (the kernel's arithmetic) against autograd
    through the plain forward and against jax.vjp of the JAX package's
    attention on the same inputs; given the plain forward's row statistics
    it equals the one that recomputes them."""
    q, k, v, bias, scale = case(name)
    dout = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    want, out = autograd_grads(q, k, v, bias, scale, dout)
    tb = None if bias is None else torch.from_numpy(bias)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = k1.flash_attention_backward(tq, tk, tv, tb, out,
                                      torch.from_numpy(dout), scale)
    assert all(g.dtype == torch.float32 and g.is_contiguous() for g in got)
    assert_close([g.numpy() for g in got], want, FP32_TOL, "autograd")
    out_s, stats = k1.flash_attention_with_stats(tq, tk, tv, tb, scale)
    assert torch.equal(out_s, out)
    saved = k1.flash_attention_backward(tq, tk, tv, tb, out,
                                        torch.from_numpy(dout), scale, stats)
    assert_close([g.numpy() for g in saved], [g.numpy() for g in got],
                 FP32_TOL, "saved stats")
    jb = None if bias is None else jnp.asarray(bias)

    @jax.jit  # one compile instead of one an operation
    def jax_grads(a, b_, c, do):
        _, vjp = jax.vjp(lambda x, y, z: jattn._xla_attention(x, y, z, jb,
                                                              scale),
                         a, b_, c)
        return vjp(do)

    jgrads = [np.asarray(g) for g in jax_grads(
        *(jnp.asarray(a) for a in (q, k, v, dout)))]
    assert_close([g.numpy() for g in got], jgrads, FP32_TOL, "jax")


@pytest.mark.parametrize("name", CASES)
def test_plain_backward_in_bf16(name):
    """bf16 inputs, output and upstream gradient: the gradients come back
    in bf16 within bf16 rounding of fp32 autograd."""
    q, k, v, bias, scale = case(name, seed=2)
    dout = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    bf = torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(a).to(bf) for a in (q, k, v, dout))
    tb = None if bias is None else torch.from_numpy(bias).to(bf)
    out, stats = k1.flash_attention_with_stats(tq, tk, tv, tb, scale)
    assert stats.dtype == torch.float32
    got = k1.flash_attention_backward(tq, tk, tv, tb, out, tdo, scale,
                                      stats)
    assert all(g.dtype == bf for g in got)
    want, _ = autograd_grads(*(t.float().numpy() for t in (tq, tk, tv)),
                             None if tb is None else tb.float().numpy(),
                             scale, tdo.float().numpy())
    assert_close([g.float().numpy() for g in got], want, BF16_TOL, "bf16")


def test_autograd_function_wires_the_backward(monkeypatch):
    """The operator the wrapper takes for inputs that require grad
    (``deer::flash_attention_with_stats``): its forward is K1's launch
    asked for its row statistics and its registered gradient
    ``flash_attention_backward`` given them (here both on their
    plain versions, as a CPU tensor gets them); q, k and v get autograd's
    gradients, the bias none, on strided views of one fused qkv as the ViT
    hands them over."""
    calls, saved = [], []

    def forward(q, k, v, bias, scale, with_stats=False):
        calls.append("forward")
        out, stats = k1.flash_attention_reference(q, k, v, bias, scale,
                                                  with_stats=True)
        saved.append(stats)
        return (out, stats) if with_stats else out

    def backward(q, k, v, bias, out, dout, scale, stats):
        calls.append("backward")
        assert stats.data_ptr() == saved[0].data_ptr()  # not recomputed
        return k1.flash_attention_backward_reference(q, k, v, bias, out,
                                                     dout, scale, stats)

    monkeypatch.setattr(k1, "_forward", forward)
    monkeypatch.setattr(k1, "flash_attention_backward", backward)
    q, k, v, bias, scale = case("decoder", seed=4)
    fused = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    d = q.shape[-1]
    views = [fused[..., i * d:(i + 1) * d] for i in range(3)]
    tb = torch.from_numpy(bias)
    out = k1.flash_attention(*views, tb, scale)
    dout = torch.from_numpy(
        np.random.RandomState(5).randn(*q.shape).astype(np.float32))
    (got,) = torch.autograd.grad(out, fused, dout)
    assert calls == ["forward", "backward"]
    want = torch.from_numpy(np.concatenate(
        autograd_grads(q, k, v, bias, scale, dout.numpy())[0], -1))
    assert torch.allclose(got, want, atol=FP32_TOL * want.abs().max().item(),
                          rtol=0)


def test_backward_checks_its_inputs():
    q, k, v, _, scale = case("vit")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="do not match q"):
        k1.flash_attention_backward(tq, tk, tv, None, tq, tq[:, :, :5],
                                    scale)
    with pytest.raises(ValueError, match="do not match"):
        k1.flash_attention_backward(tq, tk[:, :2], tv, None, tq, tq, scale)
    # the row statistics: (2, B, H, Sq) float32 on q's device
    for bad in (torch.zeros(2, *q.shape[:2], q.shape[2] + 1),
                torch.zeros(3, *q.shape[:3]),
                torch.zeros(2, *q.shape[:3], dtype=torch.float64),
                torch.zeros(2, *q.shape[:3], device="meta")):
        with pytest.raises(ValueError, match="stats must be float32"):
            k1.flash_attention_backward(tq, tk, tv, None, tq, tq, scale, bad)
    # neither on the CPU nor on the card: no plain version, a refusal
    m = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.flash_attention_backward(m, m, m, None, m, m)
    assert k1.flash_attention_backward.launches == 0


def test_stats_of_a_row_masked_everywhere():
    """The plain forward's (m, 1 / l) equal a recompute from fp32 logits; a
    row at -1e9 on every key keeps 1 / l = 1 / Sk, so p rebuilt from the
    saved statistics is uniform, where the log-sum-exp m + log l would round
    to m in fp32 and give p = 1 a key."""
    q, k, v, bias, scale = case("xattn", seed=6)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    out, stats = k1.flash_attention_with_stats(tq, tk, tv, tb, scale)
    assert torch.equal(out, k1.flash_attention_reference(tq, tk, tv, tb,
                                                         scale))
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk) * scale + tb
    m = s.amax(-1)
    assert torch.equal(stats[0], m)
    torch.testing.assert_close(stats[1], 1 / torch.exp(s - m[..., None]).sum(-1),
                               rtol=1e-6, atol=0)
    sk = k.shape[2]
    masked = stats[1][:, :, :3]  # rows masked everywhere (case "xattn")
    torch.testing.assert_close(masked, torch.full_like(masked, 1 / sk),
                               rtol=1e-6, atol=0)
    p = torch.exp(s - stats[0, ..., None]) * stats[1, ..., None]
    torch.testing.assert_close(p[:, :, :3], torch.full_like(p[:, :, :3],
                                                            1 / sk),
                               rtol=1e-6, atol=0)
    lse = stats[0] - torch.log(stats[1])
    assert torch.equal(lse[:, :, :3], stats[0][:, :, :3])
    assert torch.equal(torch.exp(s - lse[..., None])[:, :, :3],
                       torch.ones_like(p[:, :, :3]))
