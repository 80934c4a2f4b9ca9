"""Diffusion action head: the conditional 1-D U-Net and its DDPM / DDIM
samplers (the JAX package's ``models/diffusion.py``; the reference's
DiffusionDecoder, action_head.py:848-1108, and ConditionalUnet1D,
unets.py:148-326).

The convolutions are plain products over unfolded windows, as the JAX
package computes them with ``lax.conv_general_dilated`` outside any Pallas
kernel.  A product keeps fp32 on the card, where cuDNN's fp32 convolution
runs in TF32 by default (``torch.backends.cudnn.allow_tf32``), and on the
CPU it stays closer to the JAX package than mkldnn's convolution.  Two
layout points keep them equal to the JAX package's:

  * the weights are stored as JAX stores them, (c_out, c_in, k), and the
    upsampling weight (square, (c, c, 4)) is JAX's transposed-convolution
    kernel, read as ``lax.conv_transpose`` reads it (``conv1d_transpose``);
  * the strided downsampling is XLA's 'SAME' padding, which for an even
    length pads one step on the right only, not torch's symmetric
    ``padding=1`` (``conv1d``).

GroupNorm statistics are fp32.  The reverse diffusion is a host loop over
timesteps.  Every random draw (the initial sample and the per-step noise of
the samplers, the loss's timesteps and noise) comes from the caller, or
from a ``torch.Generator`` (``sampler_noise``), so that a test can feed the
JAX package's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deer_vla_tpu_torch.ops.layers import init_linear, linear, uniform


# ---------------------------------------------------------------------------
# schedules & buffers
# ---------------------------------------------------------------------------


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999).astype(np.float32)


@dataclass(frozen=True)
class DiffusionConfig:
    input_dim: int = 7
    horizon: int = 32
    global_cond_dim: int = 1024
    diffusion_step_embed_dim: int = 256
    down_dims: Tuple[int, ...] = (256, 512, 1024)
    kernel_size: int = 3
    n_groups: int = 8
    cond_predict_scale: bool = False
    n_timesteps: int = 150
    clip_denoised: bool = False
    predict_epsilon: bool = True


def ddpm_buffers(cfg: DiffusionConfig, device="cpu") -> dict:
    """The schedule's fp32 buffers, computed in float64 as the JAX package
    computes them and cast once.  The samplers read them on the host, so
    they stay on the CPU unless ``device`` says otherwise."""
    betas = cosine_beta_schedule(cfg.n_timesteps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in {
        "betas": betas,
        "alphas_cumprod": ac,
        "sqrt_alphas_cumprod": np.sqrt(ac),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - ac),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / ac),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / ac - 1.0),
        "posterior_variance": post_var,
        "posterior_log_variance_clipped": np.log(np.clip(post_var, 1e-20,
                                                         None)),
        "posterior_mean_coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
        "posterior_mean_coef2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    }.items()}


# ---------------------------------------------------------------------------
# unet pieces
# ---------------------------------------------------------------------------


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), the softplus as ``jax.nn.softplus`` computes
    it (max(x, 0) + log1p(exp(-|x|)))."""
    sp = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return x * torch.tanh(sp)


def _init_conv1d(gen, c_in: int, c_out: int, k: int, device, dtype) -> dict:
    bound = 1.0 / math.sqrt(c_in * k)
    return {"w": uniform((c_out, c_in, k), bound, gen, device, dtype),
            "b": uniform((c_out,), bound, gen, device, dtype)}


def same_padding(length: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of a length: (lo, hi), the odd step on the
    right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def _conv_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """Unpadded cross-correlation (B, C_in, T) x (C_out, C_in, k) as one
    product over the (C_in * k) window columns."""
    k = w.shape[-1]
    cols = x.unfold(2, k, stride)  # (B, C_in, T_out, k)
    bsz, c_in, t_out, _ = cols.shape
    y = cols.permute(0, 2, 1, 3).reshape(bsz, t_out, c_in * k) \
        @ w.reshape(w.shape[0], c_in * k).t()
    return (y + b).transpose(1, 2)


def conv1d(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(B, C_in, T) -> (B, C_out, ceil(T / stride)) with 'SAME' padding,
    weights (C_out, C_in, k)."""
    lo, hi = same_padding(x.shape[-1], p["w"].shape[-1], stride)
    x = F.pad(x, (lo, hi)) if lo or hi else x
    return _conv_matmul(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride)


def conv1d_transpose(p: dict, x: torch.Tensor, stride: int = 2,
                     torch_padding: int = 1) -> torch.Tensor:
    """ConvTranspose1d(dim, dim, 4, 2, 1) (unets.py:47-53) from the JAX
    package's kernel, computed as ``lax.conv_transpose`` does: the input
    dilated by ``stride``, padded k - 1 - torch_padding a side, and
    correlated with the stored (c, c, k) weight flipped in time.  (Torch's
    ``conv_transpose1d`` would take that weight with its first two dims
    swapped: it is square, so the wrong layout raises no shape error.)"""
    w = p["w"].to(x.dtype)
    k = w.shape[-1]
    b, c, t = x.shape
    xd = x.new_zeros(b, c, (t - 1) * stride + 1)
    xd[..., ::stride] = x
    lp = k - 1 - torch_padding
    return _conv_matmul(F.pad(xd, (lp, lp)), w.flip(-1), p["b"].to(x.dtype),
                        1)


def group_norm(p: dict, x: torch.Tensor, n_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """x (B, C, T): torch GroupNorm semantics with fp32 statistics."""
    b, c, t = x.shape
    xg = x.float().reshape(b, n_groups, c // n_groups, t)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    y = y * p["scale"].float()[None, :, None] \
        + p["bias"].float()[None, :, None]
    return y.to(x.dtype)


def _init_conv_block(gen, c_in, c_out, k, device, dtype) -> dict:
    return {"conv": _init_conv1d(gen, c_in, c_out, k, device, dtype),
            "gn": {"scale": torch.ones(c_out, device=device, dtype=dtype),
                   "bias": torch.zeros(c_out, device=device, dtype=dtype)}}


def conv_block(p: dict, x: torch.Tensor, n_groups: int) -> torch.Tensor:
    return mish(group_norm(p["gn"], conv1d(p["conv"], x), n_groups))


def _init_res_block(gen, c_in, c_out, cond_dim, cfg: DiffusionConfig, device,
                    dtype) -> dict:
    cond_channels = c_out * 2 if cfg.cond_predict_scale else c_out
    p = {
        "block0": _init_conv_block(gen, c_in, c_out, cfg.kernel_size, device,
                                   dtype),
        "block1": _init_conv_block(gen, c_out, c_out, cfg.kernel_size, device,
                                   dtype),
        "cond": init_linear(gen, cond_dim, cond_channels, True, device, dtype),
    }
    if c_in != c_out:
        p["res"] = _init_conv1d(gen, c_in, c_out, 1, device, dtype)
    return p


def res_block(p: dict, x: torch.Tensor, cond: torch.Tensor,
              cfg: DiffusionConfig) -> torch.Tensor:
    """ConditionalResidualBlock1D: FiLM from ``cond``, bias only unless
    ``cond_predict_scale``."""
    out = conv_block(p["block0"], x, cfg.n_groups)
    embed = linear(p["cond"], mish(cond))[:, :, None]  # (B, C[, 2C], 1)
    if cfg.cond_predict_scale:
        c = out.shape[1]
        out = embed[:, :c] * out + embed[:, c:]
    else:
        out = out + embed
    out = conv_block(p["block1"], out, cfg.n_groups)
    res = conv1d(p["res"], x) if "res" in p else x
    return out + res


def init_unet(gen, cfg: DiffusionConfig, device="cpu",
              dtype=torch.float32) -> dict:
    """ConditionalUnet1D's tree in the JAX package's layout: ``down`` /
    ``up`` lists whose last entry has ``None`` for its resampling conv."""
    all_dims = (cfg.input_dim,) + tuple(cfg.down_dims)
    in_out = list(zip(all_dims[:-1], all_dims[1:]))
    dsed = cfg.diffusion_step_embed_dim
    cond_dim = dsed + (cfg.global_cond_dim or 0)
    p = {
        "time_fc1": init_linear(gen, dsed, dsed * 4, True, device, dtype),
        "time_fc2": init_linear(gen, dsed * 4, dsed, True, device, dtype),
        "down": [], "up": [],
        "mid": [_init_res_block(gen, all_dims[-1], all_dims[-1], cond_dim,
                                cfg, device, dtype) for _ in range(2)],
        "final_block": _init_conv_block(gen, cfg.down_dims[0],
                                        cfg.down_dims[0], cfg.kernel_size,
                                        device, dtype),
        "final_conv": _init_conv1d(gen, cfg.down_dims[0], cfg.input_dim, 1,
                                   device, dtype),
    }
    for i, (ci, co) in enumerate(in_out):
        is_last = i == len(in_out) - 1
        p["down"].append({
            "res0": _init_res_block(gen, ci, co, cond_dim, cfg, device, dtype),
            "res1": _init_res_block(gen, co, co, cond_dim, cfg, device, dtype),
            "down": None if is_last else _init_conv1d(gen, co, co, 3, device,
                                                      dtype),
        })
    for i, (ci, co) in enumerate(reversed(in_out[1:])):
        is_last = i == len(in_out) - 1
        p["up"].append({
            "res0": _init_res_block(gen, co * 2, ci, cond_dim, cfg, device,
                                    dtype),
            "res1": _init_res_block(gen, ci, ci, cond_dim, cfg, device, dtype),
            "up": None if is_last else _init_conv1d(gen, ci, ci, 4, device,
                                                    dtype),
        })
    return p


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    emb = torch.exp(torch.arange(half, device=t.device) * -emb)
    emb = t[..., None].float() * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], -1)


def unet_forward(p: dict, sample: torch.Tensor, timestep: torch.Tensor,
                 cfg: DiffusionConfig,
                 global_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sample (B, H, input_dim), timestep (B,) -> (B, H, input_dim)."""
    x = sample.transpose(1, 2)  # (B, C, H)
    t_emb = sinusoidal_pos_emb(timestep, cfg.diffusion_step_embed_dim)
    t_emb = linear(p["time_fc2"], mish(linear(p["time_fc1"], t_emb)))
    cond = t_emb if global_cond is None else torch.cat(
        [t_emb, global_cond.to(t_emb.dtype)], -1)
    h = []
    for dm in p["down"]:
        x = res_block(dm["res0"], x, cond, cfg)
        x = res_block(dm["res1"], x, cond, cfg)
        h.append(x)
        if dm["down"] is not None:
            x = conv1d(dm["down"], x, stride=2)
    for m in p["mid"]:
        x = res_block(m, x, cond, cfg)
    for um in p["up"]:
        x = torch.cat([x, h.pop()], dim=1)
        x = res_block(um["res0"], x, cond, cfg)
        x = res_block(um["res1"], x, cond, cfg)
        if um["up"] is not None:
            x = conv1d_transpose(um["up"], x, stride=2)
    x = conv_block(p["final_block"], x, cfg.n_groups)
    x = conv1d(p["final_conv"], x)
    return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# DDPM decoder
# ---------------------------------------------------------------------------

Step = Union[int, torch.Tensor]


def _coef(buf: dict, key: str, t: Step):
    """buf[key] at timestep t: an fp32 scalar for a host int (the samplers'
    shared timestep, read from the host buffers without a device sync),
    else a (B, 1, 1) column on t's device."""
    if isinstance(t, int):
        return float(buf[key][t])
    return buf[key].to(t.device)[t][:, None, None]


def predict_start_from_noise(buf: dict, x_t: torch.Tensor, t: Step,
                             noise: torch.Tensor,
                             cfg: DiffusionConfig) -> torch.Tensor:
    if cfg.predict_epsilon:
        return (_coef(buf, "sqrt_recip_alphas_cumprod", t) * x_t
                - _coef(buf, "sqrt_recipm1_alphas_cumprod", t) * noise)
    return noise


def q_posterior(buf: dict, x_start: torch.Tensor, x_t: torch.Tensor,
                t: Step):
    mean = (_coef(buf, "posterior_mean_coef1", t) * x_start
            + _coef(buf, "posterior_mean_coef2", t) * x_t)
    return mean, _coef(buf, "posterior_log_variance_clipped", t)


def q_sample(buf: dict, x_start: torch.Tensor, t: Step,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward noising for training (action_head.py:1081-1089)."""
    return (_coef(buf, "sqrt_alphas_cumprod", t) * x_start
            + _coef(buf, "sqrt_one_minus_alphas_cumprod", t) * noise)


def ddim_timesteps(cfg: DiffusionConfig, steps: int):
    """The DDIM subsequence, descending, and each entry's predecessor (-1
    after the last)."""
    steps = int(min(max(1, steps), cfg.n_timesteps))
    taus = np.unique(np.round(np.linspace(0, cfg.n_timesteps - 1, steps))
                     ).astype(np.int32)[::-1]
    taus_prev = np.concatenate([taus[1:], [-1]]).astype(np.int32)
    return [int(t) for t in taus], [int(t) for t in taus_prev]


def sampler_steps(cfg: DiffusionConfig, sample_steps: int = 0) -> int:
    """U-Net evaluations of one plan: the DDIM subsequence's length for
    ``sample_steps`` > 0, else the full DDPM chain."""
    if sample_steps and sample_steps > 0:
        return len(ddim_timesteps(cfg, sample_steps)[0])
    return cfg.n_timesteps


def sampler_noise(gen: torch.Generator, shape, cfg: DiffusionConfig,
                  sample_steps: int = 0, device=None) -> torch.Tensor:
    """One plan's standard-normal draws from ``gen``: (1 + steps, *shape),
    the initial sample then one row a U-Net evaluation."""
    n = 1 + sampler_steps(cfg, sample_steps)
    z = torch.randn((n,) + tuple(shape), generator=gen, device=gen.device)
    return z if device is None else z.to(device)


def _inpaint(cond_mask, cond_data, x):
    return torch.where(cond_mask, cond_data, x)


def conditional_sample(params: dict, buf: dict, cond_data: torch.Tensor,
                       cond_mask: torch.Tensor, cfg: DiffusionConfig,
                       global_cond: Optional[torch.Tensor] = None, *,
                       noise: torch.Tensor) -> torch.Tensor:
    """Reverse diffusion over the full DDPM chain (p_sample_loop,
    action_head.py:1028-1060).  ``noise`` (1 + n_timesteps, *x.shape) holds
    standard normals: row 0 the initial sample, row 1 + i the noise of the
    i-th step (timestep n_timesteps - 1 - i), scaled by 0.5 as the
    reference does; the last step (t = 0) adds none.  cond_mask positions
    are clamped to cond_data after every step."""
    b = cond_data.shape[0]
    x = _inpaint(cond_mask, cond_data, noise[0].to(cond_data.dtype))
    for i, t in enumerate(range(cfg.n_timesteps - 1, -1, -1)):
        tt = torch.full((b,), t, dtype=torch.int64, device=x.device)
        eps = unet_forward(params, x, tt, cfg, global_cond)
        x_recon = predict_start_from_noise(buf, x, t, eps, cfg)
        if cfg.clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean, log_var = q_posterior(buf, x_recon, x, t)
        if t > 0:
            std = float(torch.exp(_f32(0.5) * _f32(log_var)))
            x = mean + std * (0.5 * noise[1 + i].to(x.dtype))
        else:
            x = mean
        x = _inpaint(cond_mask, cond_data, x)
    return x


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def conditional_sample_ddim(params: dict, buf: dict, cond_data: torch.Tensor,
                            cond_mask: torch.Tensor, cfg: DiffusionConfig,
                            global_cond: Optional[torch.Tensor] = None, *,
                            noise: torch.Tensor, steps: int = 10,
                            eta: float = 0.0) -> torch.Tensor:
    """DDIM (Song et al. 2021) over ``ddim_timesteps``: ``steps`` U-Net
    evaluations; eta = 0 is the deterministic limit.  ``noise``
    (1 + len(subsequence), *x.shape): row 0 the initial sample, row 1 + i
    the i-th step's noise.  At t_prev = -1 the sample collapses to x0.
    The step's coefficients are fp32 scalars, computed as the JAX package
    computes them."""
    b = cond_data.shape[0]
    taus, taus_prev = ddim_timesteps(cfg, steps)
    ac = buf["alphas_cumprod"].float().cpu()
    ac_ext = torch.cat([torch.ones(1), ac])
    x = _inpaint(cond_mask, cond_data, noise[0].to(cond_data.dtype))
    for i, (t, t_prev) in enumerate(zip(taus, taus_prev)):
        tt = torch.full((b,), t, dtype=torch.int64, device=x.device)
        model_out = unet_forward(params, x, tt, cfg, global_cond)
        x0 = predict_start_from_noise(buf, x, t, model_out, cfg)
        if cfg.clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        a_t, a_prev = ac_ext[t + 1], ac_ext[t_prev + 1]
        sqrt_a_t = float(torch.sqrt(a_t))
        rs = float(torch.rsqrt(1.0 - a_t))
        sigma = (_f32(eta) * torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
                 * torch.sqrt(1.0 - a_t / a_prev))
        dir_c = float(torch.sqrt(torch.clamp(1.0 - a_prev - sigma * sigma,
                                             min=0.0)))
        eps = (x - sqrt_a_t * x0) * rs
        x = (float(torch.sqrt(a_prev)) * x0 + dir_c * eps
             + float(sigma) * noise[1 + i].to(x.dtype))
        x = _inpaint(cond_mask, cond_data, x)
    return x


def diffusion_loss(params: dict, buf: dict, x_start: torch.Tensor,
                   cfg: DiffusionConfig,
                   global_cond: Optional[torch.Tensor] = None,
                   cond_mask: Optional[torch.Tensor] = None, *,
                   t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Epsilon-prediction MSE (the standard DDPM objective) at the caller's
    timesteps ``t`` (B,) and standard-normal ``noise`` of x_start's
    shape."""
    x_noisy = q_sample(buf, x_start, t, noise)
    if cond_mask is not None:
        x_noisy = torch.where(cond_mask, x_start, x_noisy)
    pred = unet_forward(params, x_noisy, t, cfg, global_cond)
    target = noise if cfg.predict_epsilon else x_start
    err = (pred - target).square()
    if cond_mask is not None:
        err = torch.where(cond_mask, 0.0, err)
    return err.mean()


def loss_draws(gen: torch.Generator, batch: int, shape,
               cfg: DiffusionConfig, device=None):
    """The loss's draws from ``gen``: timesteps (B,) in [0, n_timesteps)
    and standard-normal noise of ``shape``."""
    t = torch.randint(0, cfg.n_timesteps, (batch,), generator=gen,
                      device=gen.device)
    noise = torch.randn(tuple(shape), generator=gen, device=gen.device)
    if device is not None:
        t, noise = t.to(device), noise.to(device)
    return t, noise
