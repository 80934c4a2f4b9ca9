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
multiple of 32.

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
    else:
        raise ValueError(name)
    return (rand(b, h, sq, d), rand(b, h, sk, d), rand(b, h, sk, d), bias,
            d ** -0.5)


CASES = ["vit", "decoder", "xattn"]


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
    attention on the same inputs."""
    q, k, v, bias, scale = case(name)
    dout = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    want, out = autograd_grads(q, k, v, bias, scale, dout)
    tb = None if bias is None else torch.from_numpy(bias)
    got = k1.flash_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v)), tb, out,
        torch.from_numpy(dout), scale)
    assert all(g.dtype == torch.float32 and g.is_contiguous() for g in got)
    assert_close([g.numpy() for g in got], want, FP32_TOL, "autograd")
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda a, b_, c: jattn._xla_attention(a, b_, c, jb,
                                                           scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
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
    out = k1.flash_attention_reference(tq, tk, tv, tb, scale)
    got = k1.flash_attention_backward(tq, tk, tv, tb, out, tdo, scale)
    assert all(g.dtype == bf for g in got)
    want, _ = autograd_grads(*(t.float().numpy() for t in (tq, tk, tv)),
                             None if tb is None else tb.float().numpy(),
                             scale, tdo.float().numpy())
    assert_close([g.float().numpy() for g in got], want, BF16_TOL, "bf16")


def test_autograd_function_wires_the_backward(monkeypatch):
    """The function the card's wrapper takes for inputs that require grad:
    its forward is K1's launch and its backward ``flash_attention_backward``
    (here both on their plain versions, as a CPU tensor gets them); q, k and
    v get autograd's gradients, the bias none, on strided views of one fused
    qkv as the ViT hands them over."""
    calls = []

    def forward(q, k, v, bias, scale):
        calls.append("forward")
        return k1.flash_attention_reference(q, k, v, bias, scale)

    def backward(*a):
        calls.append("backward")
        return k1.flash_attention_backward_reference(*a)

    monkeypatch.setattr(k1, "_forward", forward)
    monkeypatch.setattr(k1, "flash_attention_backward", backward)
    q, k, v, bias, scale = case("decoder", seed=4)
    fused = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    d = q.shape[-1]
    views = [fused[..., i * d:(i + 1) * d] for i in range(3)]
    tb = torch.from_numpy(bias)
    out = k1._FlashAttention.apply(*views, tb, scale)
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
    # neither on the CPU nor on the card: no plain version, a refusal
    m = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.flash_attention_backward(m, m, m, None, m, m)
    assert k1.flash_attention_backward.launches == 0
