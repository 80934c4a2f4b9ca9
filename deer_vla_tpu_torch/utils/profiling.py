"""Profiling and metric logging (the JAX package's ``utils/profiling.py``,
which the port does not import):

  * ``trace(logdir)`` - ``torch.profiler`` over the CPU and, where there is
                        one, the CUDA device; the Chrome trace is written
                        to ``logdir/trace.json`` when the block ends;
  * ``Timer``         - a block timer on the host clock that waits for the
                        device first when ``sync_on`` holds CUDA tensors;
  * ``MetricLogger``  - a JSONL metrics sink with an optional wandb mirror
                        (the reference logs per-exit losses to wandb,
                        train_utils.py:589-615).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "deer_trace"):
    """Profile the block; yields the ``torch.profiler.profile`` object
    (``key_averages()`` for sums by operator and kernel).  The trace lands
    in ``logdir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tensor or a nested
    list / tuple / dict of them."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


class Timer:
    """``with Timer("vit", sync_on=out) as t: out = ...; t.ms``.

    ``sync_on`` (a tensor or a nested list / tuple / dict of them) is read
    when the block ends, so it may be bound inside the block: its CUDA
    devices are synchronized before the clock is read."""

    def __init__(self, name: str = "", sync_on=None):
        self.name = name
        self.sync_on = sync_on
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for dev in _cuda_devices(self.sync_on):
            torch.cuda.synchronize(dev)
        self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False


class MetricLogger:
    """Appends one JSON object a ``log`` call to ``path``; tensors and
    numpy scalars are written as floats."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            self._f = open(path, "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None  # optional; the JSONL is the record
            if wandb is not None:
                wandb.init(**(wandb_kwargs or {}))
                self.wandb = wandb

    def log(self, metrics: Dict) -> None:
        rec = {k: (float(v) if hasattr(v, "item") else v)
               for k, v in metrics.items()}
        rec.setdefault("ts", time.time())
        if self._f:
            self._f.write(json.dumps(rec, default=float) + "\n")
            self._f.flush()
        if self.wandb is not None:
            self.wandb.log(rec)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
