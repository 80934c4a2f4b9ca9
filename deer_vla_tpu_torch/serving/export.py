"""Ahead-of-time export of the dynamic-exit serving step (``torch.export``):
the port of the JAX package's ``serving/export.py``.

The JAX artifact is the fused step lowered once to StableHLO.  The port's
engine is a host loop over exit segments (``eval/scan_policy``:
``decode_segments``, one host read of "has every stream exited?" after each
segment), so its artifact is a set of programs: one for the encode prefix
(vision towers, perceiver, token embedding) and one for each exit segment,
each traced by ``torch.export.export`` from the very functions the live
engine runs (``build_scan_step``).  The loaded programs run in the same
loop, so the artifact is bit-exact against the live engine by
construction.  The kernels K1-K4 are ``deer::`` operators
(``ops/kernels``), so each appears in a program as one node, and the loaded
program launches the same kernel on the card (and runs its plain version
on the CPU).

Weights stay OUT of the artifact: every program takes the packed serving
trees ``(params, stacked)`` as its first two arguments and holds no
parameters or buffers, so one artifact serves every checkpoint of the same
config.  The batch size and the (n_layers,) threshold row are baked into
the programs' shapes, as in JAX.

Artifact layout: ``<path>/`` holds one ``torch.export.save`` file a program
(``encode.pt2``, ``segment_0.pt2``, ...) and ``<path>.json`` the config,
batch and exit geometry, argument order, the device the programs were
traced on and the torch version.  A program traced on the CPU loads onto
the card (and back) through ``torch.export.passes.move_to_device_pass``.
A bundle (``save_bundle``) adds ``<path>.weights``: the packed trees in
JAX's payload layout ``{"spec", "leaves"}``, written by the port's own
msgpack writer (``train/msgpack_io``), so ``BundledScanPolicy`` serves
with no checkpoint and no model-building Python.

    python -m deer_vla_tpu_torch.cli.export --model deer_3b \\
        --out runs/d/deer_3b.step --platforms gpu --bundle --check
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.core.device import resolve_device
from deer_vla_tpu_torch.eval.scan_policy import (ScanDeerPolicy,
                                                 decode_segments,
                                                 folded_window)
from deer_vla_tpu_torch.models.alt_heads import GPTCarry
from deer_vla_tpu_torch.models.heads import any_zero_carry
from deer_vla_tpu_torch.train import msgpack_io
from deer_vla_tpu_torch.train.checkpoint import to_numpy

# the arguments of each program, in order (JAX's ``meta["arg_order"]`` for
# its one program); segment j >= 1 takes what segment 0 returned
ARG_ORDER = {
    "encode": ["params", "stacked", "image", "gripper", "input_ids",
               "state"],
    "segment_0": ["params", "stacked", "media", "media_locations", "x",
                  "attention_mask", "carry", "thresholds_full", "state"],
    "segment": ["params", "stacked", "media", "media_locations", "ctx",
                "thresholds_full", "x", "exit_state"],
}

# --platforms names -> the platform an artifact records
PLATFORMS = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}


def _register_carry_types() -> None:
    """The gpt head's carry crosses the programs' boundary: its namedtuple
    needs a name in the saved tree specs."""
    try:
        torch.utils._pytree._register_namedtuple(
            GPTCarry, serialized_type_name="deer_vla_tpu_torch.GPTCarry")
    except ValueError:
        pass  # already registered


_register_carry_types()


def check_platforms(platforms: Sequence[str]) -> List[str]:
    """``--platforms`` as the artifact records them ("cpu", "gpu").  The
    port serves on the GPU or the CPU: "tpu" raises SystemExit."""
    out: List[str] = []
    for p in platforms:
        if p == "tpu":
            raise SystemExit(
                "--platforms tpu: the PyTorch port serves on the GPU (gpu / "
                "cuda) or the CPU; a TPU artifact is the JAX package's "
                "(deer_vla_tpu.cli.export)")
        if p not in PLATFORMS:
            raise SystemExit(f"--platforms {p}: one of cpu, gpu, cuda")
        if PLATFORMS[p] not in out:
            out.append(PLATFORMS[p])
    if not out:
        raise SystemExit("--platforms needs at least one of cpu, gpu")
    return out


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


class _Program(nn.Module):
    """One function as a module with no parameters or buffers: the program
    traced from it takes the weights as arguments."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _unaliased(tree):
    """``tree`` with each tensor leaf its own copy: the LSTM's zero carry
    is one tensor twice, and a program traced from aliased example inputs
    reads one of them for both (h for c) when they differ."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, GPTCarry):
        return GPTCarry(*(_unaliased(t) for t in tree))
    if isinstance(tree, dict):
        return {k: _unaliased(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unaliased(v) for v in tree)
    return tree


def example_inputs(policy: ScanDeerPolicy, batch_size: int) -> dict:
    """Each program's example arguments at ``batch_size`` streams, in
    ``ARG_ORDER`` (the values are zeros: the export reads shapes and
    types).  The later segments' come from running segment 0 once."""
    cfg, dev = policy.cfg, policy.device
    rows = batch_size * folded_window(cfg)
    text_rows = rows if cfg.use_hist else batch_size
    hw = cfg.vit.image_size
    ghw = cfg.gripper_res or hw
    img = torch.zeros(rows, 1, 1, 3, hw, hw, device=dev)
    grip = torch.zeros(rows, 1, 1, 3, ghw, ghw, device=dev)
    ids = torch.full((text_rows, cfg.text_len), 1, dtype=torch.int64,
                     device=dev)
    ids[:, 0] = cfg.media_token_id
    mask = torch.ones(text_rows, cfg.text_len, dtype=torch.int32,
                      device=dev)
    state = None
    if cfg.use_state or cfg.head.use_state:
        state = torch.zeros(rows, 1, 1, cfg.state_dim, device=dev)
    carry = _unaliased(any_zero_carry(cfg, batch_size, device=dev))
    th = policy.thresholds
    params, stacked = policy.params, policy.stacked
    step = policy.scan_step
    with torch.no_grad():
        media, x, mloc = step.encode(params, stacked, img, grip, ids, state)
        out = {"encode": (params, stacked, img, grip, ids, state),
               "segment_0": (params, stacked, media, mloc, x, mask, carry,
                             th, state)}
        x1, ctx, st = step.first_segment(*out["segment_0"])
        for j in range(1, len(policy.exits)):
            out[f"segment_{j}"] = (params, stacked, media, mloc,
                                   _unaliased(ctx), th, x1, _unaliased(st))
    return out


def drop_no_op_casts(ep: torch.export.ExportedProgram
                     ) -> torch.export.ExportedProgram:
    """Remove, in place, the dtype check ``torch.export`` records beside
    every ``.to`` and each ``.to`` of a tensor to its own dtype and device
    (eager returns the tensor itself): about a third of a program's nodes
    and none of its arithmetic, which the save and the load pay for node
    by node.  What the checks held stays held: a loaded program checks its
    arguments whenever they may have changed (``_LoadedProgram``), and the
    graph fixes the dtype of every tensor it makes."""
    g = ep.graph
    for node in list(g.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            g.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype
              and all(u.op != "output" for u in node.users)):
            src, out = node.args[0].meta["val"], node.meta["val"]
            if src.dtype == out.dtype and src.device == out.device:
                node.replace_all_uses_with(node.args[0])
                g.erase_node(node)
    ep.graph_module.recompile()
    return ep


def trace_programs(policy: ScanDeerPolicy, batch_size: int
                   ) -> Dict[str, torch.export.ExportedProgram]:
    """``torch.export`` of the policy's encode prefix and each exit
    segment at ``batch_size`` streams, on the policy's device."""
    step = policy.scan_step
    fns = {"encode": step.encode, "segment_0": step.first_segment}
    fns.update({f"segment_{j + 1}": seg
                for j, seg in enumerate(step.segments)})
    args = example_inputs(policy, batch_size)
    programs = {}
    with torch.no_grad():
        for name, fn in fns.items():
            ep = torch.export.export(_Program(fn), args[name], strict=False)
            ep.example_inputs = None  # never save the weights with it
            programs[name] = drop_no_op_casts(ep)
    return programs


def export_policy(params: dict, cfg: DeerConfig, *, batch_size: int = 1,
                  platforms: Tuple[str, ...] = ("gpu",),
                  threshold_type: str = "L2",
                  max_layer: Optional[int] = None,
                  exit_ids: Optional[List[int]] = None,
                  quantize: Optional[str] = None,
                  return_policy: bool = False, device=None):
    """Trace the dynamic-exit step into weight-free programs.

    Returns (programs: {name: ExportedProgram}, meta: dict), and the live
    policy whose packed trees the programs take with ``return_policy``.
    The programs are traced on ``device`` (the card unless given) through
    the layer-indexed kernels for an MPT decoder (K2, or K3 / K4 with
    ``quantize`` "int8" / "int4"); ``platforms`` lists where the artifact
    may be loaded ("cpu", "gpu"; "tpu" raises SystemExit).  ``quantize``
    bakes the quantized stacked layout into the argument shapes: the host
    side (``ExportedScanPolicy``) quantizes the checkpoint to match."""
    plats = check_platforms(platforms)
    dev = resolve_device(device)
    indexed_mm = cfg.mpt.arch == "mpt"
    policy = ScanDeerPolicy(params, cfg, exit_ids=exit_ids,
                            threshold_type=threshold_type,
                            max_layer=max_layer, quantize=quantize,
                            indexed_mm=indexed_mm, device=dev)
    programs = trace_programs(policy, batch_size)
    meta = {
        "config": json.loads(cfg.to_json()),
        "batch_size": batch_size,
        "platforms": plats,
        "device": _platform(dev),
        "threshold_type": threshold_type,
        "max_layer": max_layer,
        "quantize": quantize,
        "indexed_mm": indexed_mm,
        "exits": [int(e) for e in policy.exits],
        "programs": list(programs),
        "arg_order": {name: ARG_ORDER.get(name, ARG_ORDER["segment"])
                      for name in programs},
        "torch_version": torch.__version__,
    }
    if return_policy:  # for save_bundle: the packed trees just exported
        return programs, meta, policy
    return programs, meta


def save_exported(path: str, programs: dict, meta: dict) -> None:
    """``<path>/<name>.pt2`` a program and ``<path>.json``."""
    os.makedirs(path, exist_ok=True)
    for name, ep in programs.items():
        torch.export.save(ep, os.path.join(path, f"{name}.pt2"))
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def artifact_bytes(path: str) -> int:
    """The bytes of an artifact's program files."""
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def load_exported(path: str, device=None):
    """Returns ({name: ExportedProgram}, meta dict), the programs on
    ``device`` (the card unless given): moved there when they were traced
    on the other one.  A device whose platform the artifact does not list
    raises ValueError."""
    dev = resolve_device(device)
    meta = load_meta(path)
    if _platform(dev) not in meta["platforms"]:
        raise ValueError(f"artifact exported for {meta['platforms']}, "
                         f"not for {_platform(dev)} ({dev})")
    programs = {}
    for name in meta["programs"]:
        ep = torch.export.load(os.path.join(path, f"{name}.pt2"))
        if _platform(dev) != meta["device"]:
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, dev)
        programs[name] = ep
    return programs, meta


def _not_exported(*args, **kwargs):
    raise NotImplementedError(
        "the serving artifact exports the per-step encode and the exit "
        "segments; the rolling frame cache (encode_frame / "
        "step_from_tokens) serves from the live engine")


class _LoadedProgram:
    """A loaded program, called as the live function it was traced from.
    ``ExportedProgram.module()`` checks every call's argument tree and
    shapes against the export's, which costs the host milliseconds a call
    (PERF.md section 6), and no dtype; here that check, and one of every
    tensor leaf's dtype and device, run on the first call and again
    whenever they may have changed: the weight leaves (``weights()``, the
    identities of the policy's buffers, which a new tree or a leaf put in
    place of another changes) or the shape, dtype or device of any other
    argument leaf.  Not seen: a leaf whose storage is swapped under the
    same tensor object (``t.data = ...``)."""

    def __init__(self, ep: torch.export.ExportedProgram, weights):
        self.module = ep.module()
        self.weights = weights
        self.types = [
            (v.dtype, v.device.type) if isinstance(v, torch.Tensor) else None
            for v in (n.meta.get("val") for n in
                      self.module.graph.find_nodes(op="placeholder"))]
        self.checked = None

    def check_types(self, args) -> None:
        """Raise ValueError for a tensor leaf of another dtype or device
        than the program's (a tree of another structure is left to the
        module's own check)."""
        leaves, spec = pytree.tree_flatten_with_path((args, {}))
        if spec != self.module._in_spec:
            return
        for (path, t), want in zip(leaves, self.types):
            if (want is not None and isinstance(t, torch.Tensor)
                    and (t.dtype, t.device.type) != want):
                raise ValueError(f"the program takes {want[0]} on "
                                 f"{want[1]} at {pytree.keystr(path)}, got "
                                 f"{t.dtype} on {t.device}")

    def __call__(self, *args):
        key = (self.weights(), tuple(
            (t.shape, t.dtype, t.device) if isinstance(t, torch.Tensor)
            else type(t) for t in pytree.tree_leaves(args[2:])))
        fresh = key != self.checked
        if fresh:
            self.check_types(args)
        self.module.validate_inputs = fresh
        out = self.module(*args)
        self.checked = key
        return out


def use_programs(policy: ScanDeerPolicy, programs: dict, meta: dict) -> None:
    """Point ``policy``'s encode and decode at the loaded programs; the
    decode walks them in ``decode_segments``, as the live engine walks its
    segment functions."""
    def weights():
        return tuple(map(id, policy._buffers.values()))

    run = {name: _LoadedProgram(ep, weights)
           for name, ep in programs.items()}
    segments = [run[f"segment_{j}"] for j in range(1, len(meta["exits"]))]
    rows = meta["batch_size"] * folded_window(policy.cfg)

    def encode(params, stacked, img, grip, ids, state=None):
        if img.shape[0] != rows:
            raise ValueError(f"the artifact was exported for "
                             f"{meta['batch_size']} streams ({rows} image "
                             f"rows), got {img.shape[0]} image rows")
        return run["encode"](params, stacked, img, grip, ids, state)

    def first_segment(params, stacked, media, mloc, x, mask, carry,
                      thresholds, state=None):
        if thresholds.ndim != 1:
            raise ValueError("the artifact takes one (n_layers,) threshold "
                             "row for every stream")
        # the program takes JAX's int32 mask; hosts may send any ints
        return run["segment_0"](params, stacked, media, mloc, x,
                                mask.to(torch.int32), carry, thresholds,
                                state)

    policy._encode = encode
    policy._decode = functools.partial(decode_segments, first_segment,
                                       segments)
    policy._encode_frame = policy._decode_tokens = _not_exported
    policy.programs, policy.meta = programs, meta


# ---------------------------------------------------------------------------
# self-contained bundles: artifact + the exact packed weight trees
# ---------------------------------------------------------------------------
#
# ExportedScanPolicy still rebuilds the weight trees from a checkpoint
# (stacking, quantizing): model-building Python.  A BUNDLE ships the
# policy's packed (params, stacked) trees next to the artifact, with an
# explicit structure spec (the programs check their argument trees:
# list against tuple and dict key order matter).


def _flatten_with_spec(node, leaves: list):
    if node is None:
        return {"t": "none"}
    if isinstance(node, dict):
        return {"t": "dict",
                "items": {k: _flatten_with_spec(v, leaves)
                          for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "items": [_flatten_with_spec(v, leaves) for v in node]}
    leaves.append(to_numpy(node))
    return {"t": "leaf", "i": len(leaves) - 1}


def _leaf_tensor(a) -> torch.Tensor:
    """A stored leaf (numpy or ``msgpack_io.Bf16Array``) as a CPU tensor."""
    if isinstance(a, msgpack_io.Bf16Array):
        return torch.from_numpy(a.bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rebuild_from_spec(spec, leaves, device):
    t = spec["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _rebuild_from_spec(v, leaves, device)
                for k, v in spec["items"].items()}
    if t in ("list", "tuple"):
        out = [_rebuild_from_spec(v, leaves, device) for v in spec["items"]]
        return out if t == "list" else tuple(out)
    return _leaf_tensor(leaves[str(spec["i"])]).to(device)


def save_bundle(path: str, programs: dict, meta: dict, policy) -> None:
    """Artifact + meta (``save_exported``) + ``<path>.weights`` holding the
    policy's packed (params, stacked) argument trees."""
    save_exported(path, programs, meta)
    save_weights(path, policy)


def save_weights(path: str, policy) -> None:
    """``<path>.weights``: ``policy``'s packed (params, stacked) trees
    beside an artifact of the same config and mode, which makes it a
    bundle."""
    leaves: list = []
    spec = {"params": _flatten_with_spec(policy.params, leaves),
            "stacked": _flatten_with_spec(policy.stacked, leaves)}
    payload = {"spec": json.dumps(spec),
               "leaves": {str(i): x for i, x in enumerate(leaves)}}
    with open(path + ".weights", "wb") as f:
        msgpack_io.dump(payload, f)


class BundledScanPolicy(ScanDeerPolicy):
    """The fully self-contained serving host: the exported programs and the
    packed weight trees from a bundle; no checkpoint, no ``init_deer``, no
    ``build_scan_step``.  Shares every host-side method with
    ScanDeerPolicy (stepping, thresholds, stage reuse, postprocess); only
    construction differs.  ``device``: the card unless given."""

    def __init__(self, path: str, steps_per_stage: int = 1, device=None):
        nn.Module.__init__(self)
        self.device = resolve_device(device)
        programs, meta = load_exported(path, self.device)
        payload = msgpack_io.load(path + ".weights")
        spec = json.loads(payload["spec"])
        self._params_def = self._register_tree("params", _rebuild_from_spec(
            spec["params"], payload["leaves"], self.device))
        self._stacked_def = self._register_tree(
            "stacked", _rebuild_from_spec(spec["stacked"], payload["leaves"],
                                          self.device))
        self.cfg = DeerConfig.from_json(json.dumps(meta["config"]))
        self.exits = [int(e) for e in meta["exits"]]
        self.quantize = meta.get("quantize")
        self.tp, self.check_tp_exits = None, False
        use_programs(self, programs, meta)
        self.steps_per_stage = steps_per_stage
        self._init_dispatch()
        self.set_thresholds([1e8] * len(self.exits))
        self._carry_rows = None
        self.reset()


class ExportedScanPolicy(ScanDeerPolicy):
    """ScanDeerPolicy whose encode and exit segments come from a loaded
    artifact: the serving-host side.  The engine's Python still does the
    cheap host logic (carry, threshold staging, postprocess) and the
    checkpoint's packing; the model programs are the exported ones, so no
    retrace can change what runs in production.  ``device``: the card
    unless given."""

    def __init__(self, artifact_path: str, params: dict, cfg: DeerConfig,
                 device=None, **kw):
        dev = resolve_device(device)
        meta = load_meta(artifact_path)
        # the artifact's argument layout is authoritative: an int8 export
        # needs the host to quantize the checkpoint stacks identically
        kw.setdefault("quantize", meta.get("quantize"))
        if kw.get("quantize") != meta.get("quantize"):
            raise ValueError(
                f"artifact was exported with quantize={meta.get('quantize')!r}"
                f" but the host requested {kw.get('quantize')!r}")
        kw.setdefault("indexed_mm", meta["indexed_mm"])
        super().__init__(params, cfg, device=dev, **kw)
        if [int(e) for e in self.exits] != list(meta["exits"]):
            raise ValueError(
                f"artifact exits {meta['exits']} != config exits "
                f"{self.exits}: wrong checkpoint/config for this artifact")
        use_programs(self, load_exported(artifact_path, dev)[0], meta)
