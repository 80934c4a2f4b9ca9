"""Crash records for the port's entry points (a copy of the JAX package's
``utils/errors.record``, which the port does not import).

The reference decorates its mains with torch.distributed.elastic's
``@record`` (train_calvin_post_strategy.py:29, eval_calvin.py:33).  This
``@record`` appends a structured crash record (host, pid, entry, argv,
error, traceback, and the process's rank when ``torch.distributed`` is
initialized) to a JSONL file, then re-raises, so a failed worker can be
told apart afterwards.  ``KeyboardInterrupt`` and ``SystemExit`` pass
through unrecorded.  The JAX package's hook for XLA's persistent compile
cache has no counterpart: the port's kernels are cached by their build
(``ops/kernels/build.py``).
"""

from __future__ import annotations

import functools
import json
import os
import socket
import sys
import time
import traceback
from typing import Callable, Optional

# the crash log when neither the decorator nor DEER_ERROR_FILE names one
DEFAULT_ERROR_FILE = "deer_crash.jsonl"


def process_index() -> Optional[int]:
    """This process's rank in an initialized ``torch.distributed`` group,
    else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return None


def record(fn: Optional[Callable] = None, *,
           error_file: Optional[str] = None):
    """Decorator: on an exception, append a crash record and re-raise.

    The file is, in order, ``error_file``, the DEER_ERROR_FILE environment
    variable, or ./deer_crash.jsonl."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            try:
                return f(*args, **kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                path = (error_file or os.environ.get("DEER_ERROR_FILE")
                        or DEFAULT_ERROR_FILE)
                rec = {
                    "ts": time.time(),
                    "host": socket.gethostname(),
                    "pid": os.getpid(),
                    "entry": f"{f.__module__}.{f.__qualname__}",
                    "argv": sys.argv,
                    "error": repr(e),
                    "traceback": traceback.format_exc(),
                }
                rank = process_index()
                if rank is not None:
                    rec["process_index"] = rank
                try:
                    with open(path, "a") as fh:
                        fh.write(json.dumps(rec) + "\n")
                    print(f"[deer] crash record appended to {path}",
                          file=sys.stderr)
                except OSError:
                    pass
                raise
        return inner

    return wrap(fn) if fn is not None else wrap
