"""The plain reference of the DeeR policy, in fp32 PyTorch.

It imports nothing of the program: every layer is written out here from
the published description (OpenFlamingo's CLIP ViT-L/14, perceiver
resampler and gated cross-attention; MPT blocks with ALiBi; RoboFlamingo's
LSTM action head; DeeR's exit rule and threshold solver) over the raw
parameter tree that ``weights.draw_params`` makes, with the tree's (in,
out) linear layout.  The TF32 path is off (``strict_fp32``), so a float32
product is a float32 product.

Departures from a straightforward forward, each one the program's
documented semantics: the head pools every text position (padding
included) by max; the first exit of a step is compared with the action
of the layer below it, and each later exit with the previous exit's;
calibration compares the first exit with layer 0 (value_net.py:134-160).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
NEG = -1e9


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, at |x|."""
    return np.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                    np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of an antialiased cubic resize along one axis
    (the kernel widened by the downscale factor, each column normalized)."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    centers = (np.arange(n_out) + 0.5) * inv - 0.5
    w = _cubic(np.abs(centers[None, :] - np.arange(n_in)[:, None]) / width)
    return (w / w.sum(axis=0, keepdims=True)).astype(np.float32)


def preprocess(u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> CLIP-normalized (N, 3, size, size) fp32."""
    x = u8.float() / 255.0
    _, h, w, _ = x.shape
    if h != size:
        x = torch.einsum("nhwc,ho->nowc", x, torch.from_numpy(
            resize_matrix(h, size)).to(x.device))
    if w != size:
        x = torch.einsum("nhwc,wp->nhpc", x, torch.from_numpy(
            resize_matrix(w, size)).to(x.device))
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


# the control's precision: None (fp32), or "fp8" for products of e4m3
# operands, each tensor scaled to the format's range
LOW: Optional[str] = None


def _low(x: torch.Tensor) -> torch.Tensor:
    if LOW is None:
        return x
    if LOW != "fp8":
        raise ValueError(f"no {LOW!r} products")
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"], p.get("bias"), 1e-5)


def lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = _low(x) @ _low(p["w"])
    return y + p["b"] if p.get("b") is not None else y


def attend(q, k, v, scale: float, bias=None) -> torch.Tensor:
    """(B, H, Sq, D) x (B, H, Sk, D) softmax attention in fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", _low(q), _low(k)) * scale
    if bias is not None:
        s = s + bias
    return torch.einsum("bhqk,bhkd->bhqd", _low(torch.softmax(s, -1)),
                        _low(v))


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n, d // n).transpose(1, 2)


def unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


# ---------------------------------------------------------------------------
# vision: CLIP ViT-L/14 and the perceiver resampler
# ---------------------------------------------------------------------------


def vit_tokens(p: dict, c: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) -> patch tokens (N, P, width) after ln_post."""
    v = c["vit"]
    ps = v["patch_size"]
    n, ch, h, w = x.shape
    patches = x.reshape(n, ch, h // ps, ps, w // ps, ps).permute(
        0, 2, 4, 1, 3, 5).reshape(n, (h // ps) * (w // ps), ch * ps * ps)
    t = _low(patches) @ _low(p["patch_embed"]["w"])
    cls = p["class_embedding"].expand(n, 1, -1)
    t = ln(p["ln_pre"], torch.cat([cls, t], 1) + p["positional_embedding"])
    nh = v["heads"]
    scale = (v["width"] // nh) ** -0.5
    for blk in p["blocks"]:
        q, k, vv = lin(blk["qkv"], ln(blk["ln_1"], t)).chunk(3, -1)
        t = t + lin(blk["out"], unheads(attend(heads(q, nh), heads(k, nh),
                                                heads(vv, nh), scale)))
        h1 = lin(blk["mlp_fc"], ln(blk["ln_2"], t))
        t = t + lin(blk["mlp_proj"], h1 * torch.sigmoid(1.702 * h1))
    return ln(p["ln_post"], t)[:, 1:]


def ff(p: dict, x: torch.Tensor) -> torch.Tensor:
    return lin(p["fc2"], F.gelu(lin(p["fc1"], ln(p["ln"], x))))


def perceiver(p: dict, c: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(N, v, d) tokens -> (N, num_latents, d) latents."""
    pc = c["perceiver"]
    nh, dh = pc["heads"], pc["dim_head"]
    lat = p["latents"].expand(tokens.shape[0], -1, -1)
    for layer in p["layers"]:
        xm = ln(layer["norm_media"], tokens)
        lt = ln(layer["norm_latents"], lat)
        q = lin(layer["to_q"], lt)
        k, v = lin(layer["to_kv"], torch.cat([xm, lt], 1)).chunk(2, -1)
        lat = lat + lin(layer["to_out"], unheads(attend(
            heads(q, nh), heads(k, nh), heads(v, nh), dh ** -0.5)))
        lat = lat + ff(layer["ff"], lat)
    return ln(p["norm"], lat)


def media(p: dict, c: dict, static: torch.Tensor,
          gripper: torch.Tensor) -> torch.Tensor:
    """Both cameras' normalized frames (N, 3, S, S) -> (N, 1, 2n, d): each
    camera's latents through the shared perceiver, concatenated."""
    rgb = perceiver(p["perceiver"], c, vit_tokens(p["vit"], c, static))
    grip = perceiver(p["perceiver"], c, vit_tokens(p["vit"], c, gripper))
    return torch.cat([rgb, grip], 1)[:, None]


# ---------------------------------------------------------------------------
# the MPT decoder with gated cross-attention
# ---------------------------------------------------------------------------


def alibi_slopes(n_heads: int, bias_max: float) -> torch.Tensor:
    n = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n + 1, dtype=torch.float64) * (bias_max / n)
    s = 1.0 / torch.pow(2.0, m)
    if n != n_heads:
        s = torch.cat([s[1::2], s[::2]])[:n_heads]
    return s.float()


def self_bias(mask: torch.Tensor, c: dict) -> torch.Tensor:
    """(B, H, S, S): ALiBi + causal + key padding (finite -1e9)."""
    m = c["mpt"]
    s = mask.shape[-1]
    dev = mask.device
    slopes = alibi_slopes(m["n_heads"], m["alibi_bias_max"]).to(dev)
    alibi = torch.arange(1 - s, 1, device=dev).float()[None, :] \
        * slopes[:, None]
    allowed = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None]
               & mask[:, None, :].bool())
    return alibi[None, :, None, :] + torch.where(allowed, 0.0, NEG)[:, None]


def xattn(p: dict, c: dict, x: torch.Tensor, med: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """Gated cross-attention to the media of the one image: a text token
    attends to it once an image token precedes it (only immediate media);
    rows before any image token get zeros."""
    nh, dh = c["xattn_heads"], c["xattn_dim_head"]
    b, s, _ = x.shape
    mf = med.reshape(b, -1, med.shape[-1])
    q = lin(p["to_q"], ln(p["norm"], x))
    k, v = lin(p["to_kv"], mf).chunk(2, -1)
    text_time = torch.cumsum((ids == c["media_token_id"]).int(), -1)
    bias = torch.where(text_time == 1, 0.0, NEG)[:, None, :, None]
    out = unheads(attend(heads(q, nh), heads(k, nh), heads(v, nh), dh ** -0.5,
                         bias.expand(b, 1, s, mf.shape[1])))
    out = out.masked_fill((text_time == 0)[:, :, None], 0.0)
    x = lin(p["to_out"], out) * torch.tanh(p["attn_gate"]) + x
    return ff(p["ff"], x) * torch.tanh(p["ff_gate"]) + x


def mpt_block(p: dict, c: dict, x: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    m = c["mpt"]
    nh = m["n_heads"]
    q, k, v = lin(p["wqkv"], ln(p["ln_1"], x)).chunk(3, -1)
    x = x + lin(p["out_proj"], unheads(attend(
        heads(q, nh), heads(k, nh), heads(v, nh),
        (m["d_model"] // nh) ** -0.5, bias)))
    return x + lin(p["mlp_down"], F.gelu(lin(p["mlp_up"], ln(p["ln_2"], x))))


def decoder_layers(p: dict, c: dict, ids: torch.Tensor, mask: torch.Tensor,
                   med: torch.Tensor) -> torch.Tensor:
    """Every layer's output (L, B, S, D) (no final LayerNorm: the exit
    heads read the raw outputs)."""
    dec = p["decoder"]
    x = dec["wte"]["w"][ids]
    bias = self_bias(mask, c)
    outs = []
    for i, blk in enumerate(dec["blocks"]):
        if dec["xattn"][i] is not None:
            x = xattn(dec["xattn"][i], c, x, med, ids)
        x = mpt_block(blk, c, x, bias)
        outs.append(x)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# the LSTM action head
# ---------------------------------------------------------------------------


def lstm_cell(p: dict, x, h, cc):
    i, f, g, o = (_low(x) @ _low(p["wi"]) + _low(h) @ _low(p["wh"])
                  + p["bi"] + p["bh"]).chunk(4, -1)
    cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(cc), cc


def mlp(p: dict, y: torch.Tensor) -> torch.Tensor:
    for layer in p["layers"][:-1]:
        y = torch.relu(lin(layer, y))
    return lin(p["layers"][-1], y)


def head_step(hp: dict, feat: torch.Tensor, carry):
    """One streaming step from (B, S, D) features and carry (h, c) each
    (layers, B, H): (arm (B, 6), gripper probability (B, 1), new carry)."""
    x = feat.amax(-2)
    hs, cs = [], []
    for li, lp in enumerate(hp["rnn"]["layers"]):
        x, cc = lstm_cell(lp, x, carry[0][li], carry[1][li])
        hs.append(x)
        cs.append(cc)
    return (torch.tanh(mlp(hp["actions"], x)),
            torch.sigmoid(mlp(hp["gripper"], x)),
            (torch.stack(hs), torch.stack(cs)))


def zero_carry(hp: dict, b: int, device) -> tuple:
    layers = hp["rnn"]["layers"]
    hid = layers[0]["wh"].shape[0]
    z = torch.zeros(len(layers), b, hid, device=device)
    return z, z


def head_window_last(hp: dict, feats: torch.Tensor) -> torch.Tensor:
    """(B, T, S, D) from a zero carry -> the last step's arm (B, 6)."""
    carry = zero_carry(hp, feats.shape[0], feats.device)
    for t in range(feats.shape[1]):
        arm, _, carry = head_step(hp, feats[:, t], carry)
    return arm


def rms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).square().mean(-1).sqrt()


# ---------------------------------------------------------------------------
# calibration (DeeR's threshold solver)
# ---------------------------------------------------------------------------


def calibration_deltas(p: dict, c: dict, static_u8, gripper_u8, ids, mask,
                       rand_layer_ids: torch.Tensor,
                       exits: Sequence[int]) -> torch.Tensor:
    """(n_exit, B * n_positions) deltas of one batch of B windows of W
    frames: at window positions W/2-1 .. W-2 the extra exit's action after
    a prefix of features from randomly drawn exit layers, at [0] + exits;
    the delta of exit k is its action's distance to entry k - 1's."""
    w = c["window_size"]
    size = c["vit"]["image_size"]
    med = media(p, c, preprocess(static_u8, size),
                preprocess(gripper_u8, size))
    hid = decoder_layers(p, c, ids, mask, med)  # (L, B*W, S, D)
    bw, s, d = hid.shape[1:]
    b = bw // w
    rows = torch.arange(bw, device=hid.device)
    rand = hid[rand_layer_ids.reshape(-1), rows].reshape(b, w, s, d)
    ids_all = [0] + list(exits)
    feats = hid[ids_all].reshape(len(ids_all), b, w, s, d)
    hp = p["extra_exit"]
    per_pos = []
    for pos in range(max(w // 2 - 1, 0), max(w - 1, 1)):
        acts = [head_window_last(hp, torch.cat(
            [rand[:, :pos], feats[k][:, pos:pos + 1]], 1))
            for k in range(len(ids_all))]
        per_pos.append(torch.stack([rms(acts[k + 1], acts[k])
                                    for k in range(len(exits))]))
    return torch.stack(per_pos, -1).reshape(len(exits), -1)


def exit_probs(n: int, ratio: float, dist: str, registry: str) -> np.ndarray:
    if dist != "exp":
        raise ValueError(f"exit distribution {dist!r} is not modelled")
    probs = ratio ** np.arange(1, n + 1, dtype=np.float64)
    if "mpt_9b" in registry:
        probs[0] = 0.0  # the 9B schedule gives its first exit no share
    return probs / probs.sum()


def solve_thresholds(values: np.ndarray, ratio: float, exits: Sequence[int],
                     dist: str, registry: str) -> Dict[int, float]:
    """Per-exit thresholds whose exit shares over the calibration samples
    follow the target schedule: exit k takes the next floor(n * p_k) of
    the samples not yet taken, in order of their delta at k."""
    n_exit, n = values.shape
    probs = exit_probs(n_exit, ratio, dist, registry)
    order = np.argsort(values, axis=1)
    taken = np.zeros(n, bool)
    thr = np.full(n_exit, -1e8)
    for k in range(n_exit - 1):
        want = math.floor(n * probs[k])
        free = [i for i in order[k] if not taken[i]]
        if 0 < want <= len(free):
            thr[k] = values[k][free[want - 1]]
        taken |= values[k] <= thr[k]
    thr[-1] = 1e8
    return {int(e): float(t) for e, t in zip(exits, thr)}


# ---------------------------------------------------------------------------
# the served step, followed from the served carry
# ---------------------------------------------------------------------------


def follow_subtask(p: dict, c: dict, exits: Sequence[int], static_u8,
                   gripper_u8, ids, mask, carry_in: np.ndarray,
                   block: int = 64) -> List[dict]:
    """One subtask of one stream (T steps of frames, one instruction),
    step by step from the served carry before each step (``carry_in``
    (T, 2, layers, hidden)).  Returns per step, on the host, every exit's
    arm action (n_exit, 6), gripper probability (n_exit, 1), delta
    (n_exit,) and the carry it would commit (n_exit, 2, layers,
    hidden)."""
    size = c["vit"]["image_size"]
    t_all = static_u8.shape[0]
    hid = []
    for a in range(0, t_all, block):
        z = slice(a, min(t_all, a + block))
        med = media(p, c, preprocess(static_u8[z], size),
                    preprocess(gripper_u8[z], size))
        n = med.shape[0]
        hid.append(decoder_layers(p, c, ids.expand(n, -1),
                                  mask.expand(n, -1), med))
    hid = torch.cat(hid, 1)  # (L, T, S, D)
    hp = p["extra_exit"]
    first = exits[0]
    cin = torch.as_tensor(carry_in, device=hid.device)
    out = []
    for t in range(t_all):
        feats = torch.stack([hid[first - 1, t]] + [hid[e, t] for e in exits])
        rep = tuple(x[:, None].expand(-1, feats.shape[0], -1).contiguous()
                    for x in cin[t])
        arm, grip, cand = head_step(hp, feats, rep)
        out.append({"arm": arm[1:].cpu().numpy(),
                    "grip": grip[1:].cpu().numpy(),
                    "delta": rms(arm[1:], arm[:-1]).cpu().numpy(),
                    "carry_at": torch.stack([cand[0][:, 1:], cand[1][:, 1:]]
                                            ).permute(2, 0, 1, 3
                                                      ).cpu().numpy()})
    return out


def served_by_reference(follow: List[dict], exits: Sequence[int],
                        thr: Dict[int, float]) -> dict:
    """What the served step gives when the reference is put in the
    program's place (the control): at each followed step the first exit
    whose delta is at or below its threshold, or the last, with its arm
    action, gripper sign and carry; a record in the form the window logs
    the program's steps in."""
    thr_list = [thr[e] for e in exits]
    rec = {"exits": [], "actions": [], "carry_out": []}
    for f in follow:
        k = next((i for i in range(len(exits) - 1)
                  if f["delta"][i] <= thr_list[i]), len(exits) - 1)
        sign = 1.0 if f["grip"][k][0] > 0.5 else -1.0
        rec["exits"].append(exits[k])
        rec["actions"].append(np.append(f["arm"][k], sign))
        rec["carry_out"].append(f["carry_at"][k])
    return rec


def exit_violation(delta: np.ndarray, thr: Sequence[float], k_taken: int,
                   last: bool) -> float:
    """How far (relative to the threshold) the reference's deltas lie on
    the wrong side of the thresholds the step was served with, for the
    exit it took: an earlier exit whose delta is at or below its
    threshold, or the taken exit (unless the last) whose delta is above
    it."""
    worst = 0.0
    for k in range(k_taken):
        if thr[k] > 0 and delta[k] <= thr[k]:
            worst = max(worst, (thr[k] - delta[k]) / thr[k])
    if not last:
        t = thr[k_taken]
        if t <= 0:
            return math.inf
        if delta[k_taken] > t:
            worst = max(worst, (delta[k_taken] - t) / t)
    return worst


def compare_steps(follow: List[dict], rec: dict, exits: Sequence[int],
                  thr: Dict[int, float]) -> Dict[str, float]:
    """The gaps of one followed subtask (``rec``: the served frames' exits,
    actions, carries; ``thr``: the thresholds they were served with): the
    arm action against the reference's at the exit taken (max abs); the
    gripper sign against the reference's probability (how far past 0.5
    on the wrong side); the exit rule (``exit_violation``); the committed
    carry against the one the reference commits at that exit (the L2 of
    the difference over the reference's)."""
    thr_list = [thr[e] for e in exits]
    arm = grip = ex = carry = 0.0
    for f, act, e, cout in zip(follow, rec["actions"], rec["exits"],
                               rec["carry_out"]):
        k = list(exits).index(int(e))
        arm = max(arm, float(np.abs(f["arm"][k] - act[:6]).max()))
        pg = float(f["grip"][k][0])
        grip = max(grip, 0.5 - pg if act[6] > 0 else pg - 0.5, 0.0)
        ex = max(ex, exit_violation(f["delta"], thr_list, k,
                                    k == len(exits) - 1))
        ref_c = f["carry_at"][k]
        carry = max(carry, float(np.linalg.norm(ref_c - cout)
                                 / max(np.linalg.norm(ref_c), 1e-12)))
    return {"arm_gap": float(arm), "grip_gap": float(grip),
            "exit_gap": float(ex), "carry_gap": carry}


def threshold_gaps(thr: Dict[int, float], thr_ref: Dict[int, float],
                   values_ref: np.ndarray, exits: Sequence[int]
                   ) -> Dict[str, float]:
    """The calibration against the reference's, over the exits that can
    fire: ``threshold_gap``, the worst relative gap of a threshold, and
    ``threshold_share_gap``, the worst share of the reference's
    calibration samples whose delta at that exit lies between the two
    thresholds (the samples that would exit on the other side)."""
    gap = share = 0.0
    for i, e in enumerate(exits[:-1]):
        t, t_ref = float(thr[e]), thr_ref[e]
        if t_ref > 0:
            gap = max(gap, abs(t - t_ref) / t_ref)
        elif t > 0:
            gap = math.inf
        lo, hi = min(t, t_ref), max(t, t_ref)
        v = values_ref[i]
        share = max(share, float(((v > lo) & (v <= hi)).mean()))
    return {"threshold_gap": gap, "threshold_share_gap": share}
