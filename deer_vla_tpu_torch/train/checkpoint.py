"""Checkpoints in the JAX package's format (its ``train/checkpoint.py``),
read and written without flax:

  * ``<stem>.ckpt``: msgpack (``train/msgpack_io``) of
    ``{"params": {"decoder/xattn/0/to_q/w": array, ...}}``, only the leaves
    of a mask when one is given (a delta checkpoint), and the optimizer
    state under ``"opt_state"`` in the layout of the JAX package's optax
    state (``train/optimizer.GroupedAdamW.state_dict``), so each package
    restores the other's moments;
  * ``<stem>.json``: the config and a ``meta`` record (epoch, phase, seed,
    and for the port's trainer how its backbone was drawn);
  * ``<stem>.values.npz``: cached calibration deltas with the settings
    they were made under.

Loading is non-strict: the file's leaves overwrite the template's, the rest
keep the template's values (the base + delta composition,
eval_calvin.py:543-577).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.models.flamingo import init_deer
from deer_vla_tpu_torch.ops.layers import (flat_key, tree_leaves_with_path,
                                           tree_map, tree_map_with_path)
from deer_vla_tpu_torch.train import msgpack_io
from deer_vla_tpu_torch.train.optimizer import moments_of_state_dict

# the package a meta["init"] record names when the port drew the backbone
INIT_PACKAGE = "deer_vla_tpu_torch"


def _stem(path: str) -> str:
    """Drop a trailing '.ckpt' so sidecar paths derive from one stem."""
    return path[:-5] if path.endswith(".ckpt") else path


def to_numpy(t: torch.Tensor):
    """A tensor as the codec stores it: numpy, or ``Bf16Array`` for bf16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return msgpack_io.Bf16Array(t.view(torch.int16).numpy()
                                    .view(np.uint16))
    return t.numpy()


def _stored(tree):
    """A state dict with its tensors as the codec stores them."""
    if isinstance(tree, dict):
        return {k: _stored(v) for k, v in tree.items()}
    return to_numpy(tree) if isinstance(tree, torch.Tensor) else tree


def to_tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    """A stored array (numpy or ``Bf16Array``) as a ``dtype`` tensor on
    ``device``."""
    if isinstance(a, msgpack_io.Bf16Array):
        t = torch.from_numpy(a.bits.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def backbone_record(cfg: DeerConfig) -> Dict:
    """The parts of ``cfg`` that decide which backbone ``init_deer`` draws:
    the ViT, perceiver and decoder configs (arch, widths, depth) and the
    cross-attention layout.  ToMe (``vit.tome_r``) merges tokens and draws
    no weights, so it is left out."""
    vit = dataclasses.asdict(cfg.vit)
    vit.pop("tome_r")
    return {"vit": vit, "perceiver": dataclasses.asdict(cfg.perceiver),
            "decoder": dataclasses.asdict(cfg.mpt),
            "xattn": [cfg.cross_attn_every_n_layers, cfg.xattn_dim_head,
                      cfg.xattn_heads, cfg.xattn_ff_mult]}


def init_record(seed: int, device, cfg: DeerConfig) -> Dict:
    """The sidecar's ``meta["init"]`` for a backbone that
    ``init_deer(cfg, seed=seed, device=device)`` drew.  A seed draws other
    numbers on the CPU, on the card and in the JAX package, so the
    generator's device is part of the record, and so is the model
    (``backbone_record``): a deer_3b, deer_9b and bc_llama backbone differ
    at one seed."""
    return {"package": INIT_PACKAGE, "seed": int(seed),
            "generator_device": torch.device(device).type,
            "backbone": backbone_record(cfg)}


def rebuild_backbone(init: Optional[Dict], cfg: DeerConfig,
                     device) -> Optional[dict]:
    """The params drawn as the record ``init`` says, on ``device``; None
    when ``init`` is not a record of the port's (a delta checkpoint over
    such a backbone cannot be rebuilt)."""
    if not init or init.get("package") != INIT_PACKAGE:
        return None
    gen_dev = torch.device(init["generator_device"])
    if gen_dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("its backbone was drawn on a CUDA device; "
                           "rebuilding it needs one")
    return tree_map(lambda t: t.to(device),
                    init_deer(cfg, seed=int(init["seed"]), device=gen_dev))


def check_init(recorded: Optional[Dict], own: Optional[Dict],
               path: str) -> None:
    """Refuse to overlay the delta checkpoint at ``path``, trained over the
    backbone ``recorded``, on a backbone drawn as ``own`` (None: weights
    the caller gave)."""
    if (recorded or None) != own:
        raise ValueError(
            f"checkpoint {path} was trained over the backbone {recorded}, "
            f"this run's is {own}: resume with the model, the seed and on "
            "the device the run started with")


def save_checkpoint(path: str, params: dict, cfg: DeerConfig,
                    meta: Optional[Dict] = None,
                    trainable_mask: Optional[dict] = None,
                    opt_state: Optional[dict] = None) -> str:
    """Write ``<path>.ckpt`` and ``<path>.json``, each through a temporary
    file and a rename, so a crash never leaves a truncated checkpoint for
    ``find_latest_checkpoint`` to pick.  With ``trainable_mask`` only the
    leaves it marks True are stored (train_utils.py:631-638).
    ``opt_state`` is an optax-layout state dict
    (``GroupedAdamW.state_dict``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    keep = (None if trainable_mask is None
            else {p for p, m in tree_leaves_with_path(trainable_mask) if m})
    payload = {"params": {flat_key(p): to_numpy(v)
                          for p, v in tree_leaves_with_path(params)
                          if keep is None or p in keep}}
    if opt_state is not None:
        payload["opt_state"] = _stored(opt_state)
    tmp = path + ".ckpt.tmp"
    with open(tmp, "wb") as f:
        msgpack_io.dump(payload, f)
    os.replace(tmp, path + ".ckpt")
    tmp_j = path + ".json.tmp"
    with open(tmp_j, "w") as f:
        json.dump({"config": json.loads(cfg.to_json()), "meta": meta or {}},
                  f, indent=2)
    os.replace(tmp_j, path + ".json")
    return path + ".ckpt"


def load_checkpoint(path: str, params_template: dict,
                    opt_state_template: Optional[dict] = None
                    ) -> Tuple[dict, Optional[dict], Dict]:
    """(params, opt_state, sidecar).  Every template leaf the file holds is
    replaced by the file's value, in the template leaf's dtype and on its
    device; the others are the template's own tensors.  The sidecar's
    ``meta`` gains ``loaded_keys`` (how many were replaced) and
    ``unconsumed_keys`` (stored leaves the template has no place for, also
    warned about).  ``opt_state`` is the port's optimizer state shaped like
    ``opt_state_template`` (``{"count", "mu", "nu"}``), read from the
    file's optax-layout state, written by either package, when both are
    there."""
    path = _stem(path)
    loaded = msgpack_io.load(path + ".ckpt")
    stored = dict(loaded.get("params", {}))
    consumed = set()

    def overlay(p, leaf):
        key = flat_key(p)
        if key not in stored:
            return leaf
        consumed.add(key)
        return to_tensor(stored[key], leaf.device, leaf.dtype)

    params = tree_map_with_path(overlay, params_template)
    sidecar = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            sidecar = json.load(f)
    meta = sidecar.setdefault("meta", {})
    meta["loaded_keys"] = len(consumed)
    unconsumed = sorted(set(stored) - consumed)
    meta["unconsumed_keys"] = unconsumed
    if unconsumed:
        warnings.warn(
            f"checkpoint {path}: {len(unconsumed)} stored params not "
            f"matched by the model template (first: {unconsumed[:3]})")
    opt_state = None
    if opt_state_template is not None and "opt_state" in loaded:
        opt_state = _restore_opt_state(loaded["opt_state"],
                                       opt_state_template, path)
    return params, opt_state, sidecar


def _restore_opt_state(stored: dict, template: dict, path: str) -> dict:
    count, mu, nu = moments_of_state_dict(stored)
    moments = {"mu": mu, "nu": nu}
    for m, leaves in moments.items():
        if set(leaves) != set(template[m]):
            raise ValueError(f"checkpoint {path}: its optimizer state does "
                             "not cover the phase's trainable leaves")
    return {"count": count,
            **{m: {k: to_tensor(leaves[k], t.device, t.dtype)
                   for k, t in template[m].items()}
               for m, leaves in moments.items()}}


def find_latest_checkpoint(
        run_dir: str,
        pattern: str = r".*_(\d+)(?:_it(\d+))?\.ckpt$") -> Optional[str]:
    """The newest checkpoint in a run dir, for auto-resume
    (train_calvin_post_strategy.py:589-629).  ``deer_{E}.ckpt`` is the end
    of epoch E, ``deer_{E}_it{N}.ckpt`` a save N steps into it; an
    end-of-epoch save outranks the same epoch's mid-epoch saves, and later
    steps outrank earlier ones."""
    if not os.path.isdir(run_dir):
        return None
    best, best_key = None, (-1, 0, -1)
    for fn in os.listdir(run_dir):
        m = re.match(pattern, fn)
        if not m:
            continue
        ep, it = int(m.group(1)), m.group(2)
        key = (ep, 0, int(it)) if it is not None else (ep, 1, 0)
        if key > best_key:
            best_key, best = key, os.path.join(run_dir, fn)
    return best


def save_calibration_values(path: str, values: np.ndarray,
                            info: Optional[Dict] = None) -> None:
    """Write ``{stem}.values.npz`` (the reference mutated ckpt['values'] in
    place, eval_calvin.py:608-611).  Values are stored as fp32."""
    np.savez(_stem(path) + ".values.npz",
             values=np.asarray(values).astype(np.float32),
             info=json.dumps(info or {}))


def load_calibration_info(path: str) -> Dict:
    """The settings recorded beside the cached values (exit_ratio,
    calib_warm, calib_streamed), {} when there is no sidecar."""
    f = _stem(path) + ".values.npz"
    if not os.path.exists(f):
        return {}
    z = np.load(f, allow_pickle=False)
    if "info" not in z.files:
        return {}
    return json.loads(str(z["info"]))


def load_calibration_values(path: str) -> Optional[np.ndarray]:
    f = _stem(path) + ".values.npz"
    if not os.path.exists(f):
        return None
    v = np.load(f, allow_pickle=False)["values"]
    if v.dtype.kind == "V":
        raise ValueError(f"{f} holds raw bf16 bytes (a legacy sidecar); "
                         "recompute the values")
    return v
