"""One worker thread an engine, for its asynchronous ``dispatch_batch``.

JAX dispatches a step's program and returns at once; the host reads the
results later.  The port's decode reads the host once per exit segment
(``scan_policy.decode_segments``), so a step run on the calling thread
returns only after its last segment.  ``StepWorker`` runs the steps an
engine dispatches on a thread of its own, in the order they were
dispatched, and ``dispatch_batch`` returns a ``Dispatched`` handle at once:
the caller steps other envs while the step's layers run on the card, and
``finish_batch`` waits on the handle.

The thread-local state a step depends on is the caller's: the worker runs
it under the caller's grad mode, inference mode and intra-op thread count
and, on the card, on the caller's device and current CUDA stream, so its
kernels queue behind the caller's earlier work on that stream.  The host read that ends a segment
(``bool`` of a CUDA tensor) releases the GIL while it waits on the card.

The thread is a daemon, started at the first dispatch; ``close`` stops it
after the steps already queued, and a later dispatch starts a new one.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import torch


class Dispatched:
    """A dispatched step: ``wait()`` gives its result or raises its error.
    ``started`` / ``ended`` are the worker's ``time.perf_counter()`` around
    the step (None until then)."""

    __slots__ = ("future", "started", "ended")

    def __init__(self):
        self.future: Future = Future()
        self.started: Optional[float] = None
        self.ended: Optional[float] = None

    def done(self) -> bool:
        return self.future.done()

    def wait(self):
        return self.future.result()


def _caller_state(device: torch.device) -> tuple:
    """The calling thread's grad mode, inference mode, intra-op thread
    count (OpenMP keeps one a thread: the CPU's sums split by it) and, on
    the card, its current stream on ``device``."""
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
            torch.get_num_threads(), stream)


def _run(fn: Callable, state: tuple, handle: Dispatched) -> None:
    grad, inference, threads, stream = state
    if not handle.future.set_running_or_notify_cancel():
        return
    handle.started = time.perf_counter()
    if torch.get_num_threads() != threads:
        torch.set_num_threads(threads)
    try:
        with contextlib.ExitStack() as stack:
            if stream is not None:
                stack.enter_context(torch.cuda.device(stream.device))
                stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.inference_mode(inference))
            stack.enter_context(torch.set_grad_enabled(grad))
            result = fn()
    except BaseException as e:  # noqa: BLE001 - handed to the waiter
        handle.ended = time.perf_counter()
        handle.future.set_exception(e)
    else:
        handle.ended = time.perf_counter()
        handle.future.set_result(result)


def run_inline(fn: Callable, device: torch.device) -> Dispatched:
    """``fn()`` run on the calling thread, as a finished handle (its error,
    if it raised, is raised by ``wait``): a synchronous step that goes
    through the same ``finish_batch`` as a dispatched one."""
    handle = Dispatched()
    _run(fn, _caller_state(device), handle)
    return handle


def _serve(jobs: queue.SimpleQueue) -> None:
    """The worker's loop; it holds the queue only, never an engine."""
    while True:
        job = jobs.get()
        if job is None:
            return
        _run(*job)
        del job  # drop the step's closure (and its engine) before waiting


class StepWorker:
    """The thread that runs one engine's dispatched steps in order.  Shallow
    copies of the engine share it, so their steps reach the card in the
    order they were dispatched."""

    def __init__(self, name: str = "deer-step"):
        self.name = name
        self._lock = threading.Lock()
        self._jobs: Optional[queue.SimpleQueue] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def alive(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def submit(self, fn: Callable, device: torch.device) -> Dispatched:
        """Queue ``fn()`` under the calling thread's state (module
        docstring); returns its handle at once."""
        handle = Dispatched()
        job = (fn, _caller_state(device), handle)
        with self._lock:
            if not self.alive:
                self._jobs = queue.SimpleQueue()
                self._thread = threading.Thread(
                    target=_serve, args=(self._jobs,), name=self.name,
                    daemon=True)
                self._thread.start()
            self._jobs.put(job)
        return handle

    def close(self) -> None:
        """Stop the thread once the steps already queued have run."""
        with self._lock:
            thread, jobs = self._thread, self._jobs
            self._thread = self._jobs = None
        if thread is None:
            return
        jobs.put(None)
        if thread is not threading.current_thread():
            thread.join()
