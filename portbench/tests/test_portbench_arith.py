"""The yardstick's arithmetic against hand counts: model FLOPs of a served
step and of a train step (the frozen ViT charged its forward only), and
the kernels' operations and bytes."""

import pytest
import torch

import flops
import roofline
from deer_vla_tpu_torch.core.config import deer_3b, deer_9b

GF = 1e9


def test_vision_a_frame_by_hand():
    # ViT-L/14 at 224 px: 256 patches + CLS, width 1024, 24 layers, MLP 4096
    s, d = 257, 1024
    layer = (2 * s * d * 3 * d + 2 * s * d * d + 4 * s * s * d
             + 2 * 2 * s * d * 4 * d)
    vit = 2 * 256 * 588 * d + 24 * layer
    # perceiver: 64 latents over 256 tokens, 8 heads of 64, 6 layers
    n, v, inner = 64, 256, 512
    per = 6 * (2 * n * d * inner + 2 * (v + n) * d * 2 * inner
               + 4 * n * (v + n) * inner + 2 * n * inner * d
               + 2 * 2 * n * d * 4 * d)
    for cfg in (deer_3b(), deer_9b()):
        assert flops.vision_flops(cfg) == 2 * (vit + per)
    assert flops.vision_flops(deer_3b()) / GF == pytest.approx(347.1, abs=0.05)


@pytest.mark.parametrize("cfg, gf", [(deer_3b(), 69.5), (deer_9b(), 182.2)])
def test_decoder_to_the_last_layer(cfg, gf):
    s, d, m = 32, cfg.mpt.d_model, cfg.num_media_tokens
    block = 2 * s * d * 3 * d + 2 * s * d * d + 4 * s * s * d \
        + 2 * 2 * s * d * 4 * d
    xattn = (2 * s * d * 512 + 2 * m * 1024 * 1024 + 4 * s * m * 512
             + 2 * s * 512 * d + 2 * 2 * s * d * 4 * d)
    n_x = sum(cfg.has_xattn(i) for i in range(12))
    want = 12 * block + n_x * xattn
    assert flops.decoder_flops_to(cfg, 11) == want
    assert want / GF == pytest.approx(gf, abs=0.05)


def test_train_step_charges_the_frozen_vit_one_forward():
    cfg = deer_3b()
    vit = 2 * flops.vit_flops(cfg)
    rest = (2 * flops.perceiver_flops(cfg) + flops.decoder_flops_to(cfg, 11)
            + (3 + 5) * flops.head_flops(cfg))
    got = flops.train_step_flops(cfg)
    assert got == 12 * (vit + 3 * rest)
    # the program's count, 3 x (forward) with the ViT in it, is 2 ViT
    # forwards a frame more
    assert 12 * 3 * (vit + rest) - got == 12 * 2 * vit


def test_k1_bound_by_hand():
    q = torch.empty(128, 16, 257, 64, dtype=torch.bfloat16, device="meta")
    got = roofline.k1_launch(q, q, q, None, 0.125)
    nbytes = 4 * 128 * 16 * 257 * 64 * 2
    ops = 4 * 128 * 16 * 257 * 257 * 64
    assert (got["bytes"], got["flops"]) == (nbytes, ops)
    assert got["seconds"] == max(nbytes / 3.35e12, ops / 989e12)
    assert got["by_bytes"]  # 257 tokens of 64: bytes bind
    bias = torch.empty(1, 16, 257, 257, dtype=torch.bfloat16, device="meta")
    assert roofline.k1_launch(q, q, q, bias)["bytes"] == \
        nbytes + 16 * 257 * 257 * 2


def test_k2_bound_by_hand():
    x = torch.empty(64, 32, 2048, dtype=torch.bfloat16, device="meta")
    w = torch.empty(12, 2048, 6144, dtype=torch.bfloat16, device="meta")
    got = roofline.k2_launch(x, w)
    m = 64 * 32
    assert got["flops"] == 2 * m * 2048 * 6144
    assert got["bytes"] == (m * 2048 + 2048 * 6144 + m * 6144) * 2
    assert got["seconds"] == max(got["bytes"] / 3.35e12,
                                 got["flops"] / 989e12)
