"""Multi-process helpers over ``torch.distributed`` (the JAX package's
``parallel/multihost.py``).

They replace the reference's collectives outside the model: the
``all_gather`` of calibration deltas (value_net.py:195-201) and the
``gather_object`` of rollout results (eval_utils.py:565-568).  Without a
process group, or with a group of one, they are the identity.

``initialize`` is the counterpart of ``jax.distributed.initialize``: NCCL
when every rank on this host has a card of its own, gloo otherwise (NCCL
refuses two ranks on one device).  The ranks on this host are those that
torchrun's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` name; without them every
process of the group is taken to run on this host.  Gloo reduces and
broadcasts CUDA tensors but gathers host tensors only, so the gathers here
go through host tensors whatever the backend.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional

import numpy as np
import torch


def is_initialized() -> bool:
    d = torch.distributed
    return d.is_available() and d.is_initialized()


def _dist():
    return torch.distributed if is_initialized() else None


def process_count() -> int:
    """Processes of the torch.distributed group, 1 without one."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def process_index() -> int:
    """This process's rank in the group, 0 without one."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def local_ranks(num_processes: int, process_id: int) -> tuple:
    """(this process's index among the ranks on its host, how many ranks
    run on its host): torchrun's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``,
    else the whole group on one host."""
    env = os.environ
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    return process_id, num_processes


def pick_backend(local_world: int, device: Optional[str] = None) -> str:
    """'nccl' when the processes run on cards and this host has a card for
    each of its ``local_world`` ranks, else 'gloo'."""
    on_card = (device is None or torch.device(device).type == "cuda")
    if (on_card and torch.cuda.is_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


# how long a collective waits for the other ranks
TIMEOUT_S = 600.0


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: Optional[str] = None) -> str:
    """Join the process group at ``coordinator`` (``host:port``, or a
    ``tcp://`` / ``file://`` URL) as rank ``process_id`` of
    ``num_processes``; returns the backend.  On the card each rank takes
    the card of its index on its host (``local_ranks``), modulo the
    host's cards."""
    import datetime

    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    local_rank, local_world = local_ranks(num_processes, process_id)
    backend = pick_backend(local_world, device)
    if ((device is None or torch.device(device).type == "cuda")
            and torch.cuda.is_available()):
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if _dist() is not None:
        torch.distributed.destroy_process_group()


def all_ranks(flag: bool) -> bool:
    """Whether ``flag`` holds on every process (``flag`` itself without a
    group or with a group of one)."""
    if process_count() == 1:
        return flag
    dev = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return bool(t.item())


def _all_gather_host(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's host tensor ``t`` (one shape on every rank), in rank
    order, as host tensors; staged through the card under NCCL."""
    if torch.distributed.get_backend() == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(out, t)
    return [o.cpu() for o in out]


def all_gather_values(values: np.ndarray, axis: int = 1) -> np.ndarray:
    """Every process's calibration array, concatenated along ``axis`` in
    rank order (the reference's all_gather of (n_exit, n_samples) deltas).
    The arrays may differ in length along ``axis`` only."""
    values = np.ascontiguousarray(values)
    if process_count() == 1:
        return values
    n = torch.tensor([values.shape[axis]], dtype=torch.int64)
    sizes = [int(s) for s in torch.cat(_all_gather_host(n))]
    pad = [(0, 0)] * values.ndim
    pad[axis] = (0, max(sizes) - values.shape[axis])
    padded = torch.from_numpy(np.ascontiguousarray(np.pad(values, pad)))
    parts = [p.numpy() for p in _all_gather_host(padded)]
    return np.concatenate([np.take(p, np.arange(s), axis=axis)
                           for p, s in zip(parts, sizes)], axis=axis)


def gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj``, in rank order, on every process."""
    if process_count() == 1:
        return [obj]
    payload = np.frombuffer(pickle.dumps(obj), np.uint8)
    n = torch.tensor([payload.size], dtype=torch.int64)
    sizes = [int(s) for s in torch.cat(_all_gather_host(n))]
    padded = torch.zeros(max(sizes), dtype=torch.uint8)
    padded[:payload.size] = torch.from_numpy(payload.copy())
    return [pickle.loads(p[:s].numpy().tobytes())
            for p, s in zip(_all_gather_host(padded), sizes)]
