"""The benchmark's own spans and the traced slice of a ``--trace 1`` run.

Spans are ``record_function`` ranges named after the calls the benchmark
makes into the program or serves it from (``engine.step_batch``,
``rollout.env.step`` and the like); they cost nothing while no profiler
runs.  ``Tracer.start`` / ``stop`` put ``torch.profiler`` (host and CUDA
activity) around a slice of the window and hook the kernels' observers,
so every K1 / K2 launch in the slice is seen with the shapes it was called
with.  ``reduce`` turns the slice into what the per-layer readers take:
device busy time (the union of kernel, copy and set intervals), the idle
gaps named by the innermost benchmark span open on the host at the gap,
kernel time by name, and the launches' least times (``roofline``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from roofline import k1_launch, k2_launch

PREFIXES = ("rollout.", "engine.")
K1_NAMES = ("flash_attention_bf16",)
K2_NAMES = ("indexed_matmul_bf16", "indexed_matmul_wgmma")


class Tracer:
    """``slice_name``: the span that covers the traced slice, under which
    an idle gap falls where no deeper benchmark span is open (the driving
    loop's own host code)."""

    def __init__(self, slice_name: str):
        self.slice_name = slice_name
        self.done = False
        self.prof = None
        self.k1: List[dict] = []
        self.k2: List[dict] = []
        self._slice = None
        self._saved = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.autograd.profiler.record_function(name)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        from deer_vla_tpu_torch.ops.kernels import flash_attention as fa
        from deer_vla_tpu_torch.ops.kernels import indexed_matmul as im
        self._saved = (fa.flash_attention.observer,
                       im.indexed_matmul.observer)
        fa.flash_attention.observer = \
            lambda *a: self.k1.append(k1_launch(*a))
        im.indexed_matmul.observer = \
            lambda x, w: self.k2.append(k2_launch(x, w))
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._slice = torch.autograd.profiler.record_function(
            self.slice_name)
        self._slice.__enter__()

    def stop(self) -> None:
        from deer_vla_tpu_torch.ops.kernels import flash_attention as fa
        from deer_vla_tpu_torch.ops.kernels import indexed_matmul as im
        torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        self.prof.stop()
        self.done = True
        fa.flash_attention.observer, im.indexed_matmul.observer = self._saved

    def reduce(self) -> dict:
        """The slice as numbers (seconds throughout)."""
        events = self.prof.profiler.kineto_results.events()
        dev, spans, window = [], [], None
        for e in events:
            name = e.name()
            t0, t1 = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            ours = name == self.slice_name or name.startswith(PREFIXES)
            if str(e.device_type()).endswith("CUDA"):
                if not ours:  # the spans' projection onto the stream
                    dev.append((t0, t1, name))
            elif name == self.slice_name:
                window = (t0, t1)
            elif name.startswith(PREFIXES):
                spans.append((t0, t1, name))
        if window is None:
            raise RuntimeError("the traced slice's own span is missing")
        w0, w1 = window
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
        dev.sort()
        busy, gaps, end = 0.0, [], w0
        for a, b, _ in dev:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if w1 > end:
            gaps.append((end, w1))
        kernels = [(a, b, n) for a, b, n in dev
                   if not n.startswith(("Memcpy", "Memset"))]
        by_name: Dict[str, float] = {}
        for a, b, n in kernels:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        return {"window_s": w1 - w0, "busy_s": busy,
                "launches": len(kernels), "kernel_s": by_name,
                "k1_s": _sum(by_name, K1_NAMES), "k2_s": _sum(by_name,
                                                              K2_NAMES),
                "k1_launches": self.k1, "k2_launches": self.k2,
                "k1_count": _count(kernels, K1_NAMES),
                "k2_count": _count(kernels, K2_NAMES),
                "idle_by_span": _name_gaps(gaps, spans, self.slice_name)}


def _sum(by_name: Dict[str, float], keys) -> float:
    return sum(v for n, v in by_name.items() if any(k in n for k in keys))


def _count(kernels, keys) -> int:
    return sum(1 for _, _, n in kernels if any(k in n for k in keys))


def _name_gaps(gaps, spans, outer: str) -> Dict[str, float]:
    """Each idle gap's seconds under the innermost benchmark span that is
    open at its middle (``outer``, the slice's own, where none is).  The
    spans are one thread's, so they nest: one sweep with a stack."""
    spans = sorted(spans)
    out: Dict[str, float] = {}
    stack: list = []
    j = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else outer
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def breakdown(red: dict, top: int = 10) -> Optional[dict]:
    ops = sorted(red["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
