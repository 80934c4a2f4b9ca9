"""Training heartbeat: a liveness file for an elastic launcher (a copy of
the JAX package's ``utils/heartbeat.py``, which the port does not import).

A launcher that watches the file restarts a worker that crashed or hung (no
beat within its timeout); checkpoint auto-resume
(``train/checkpoint.find_latest_checkpoint``) makes the restart cheap.
File-based, so it works on a filesystem shared across hosts.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class Heartbeat:
    """Rate-limited liveness file writer.

    beat() writes {ts, pid, **info} to ``path`` at most every
    ``min_interval`` seconds; atomic rename so readers never see a torn
    file.  A no-op when ``path`` is falsy (heartbeating disabled).
    """

    def __init__(self, path: Optional[str], min_interval: float = 5.0):
        self.path = path
        self.min_interval = min_interval
        self._last = 0.0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, **info) -> bool:
        if not self.path:
            return False
        now = time.time()
        if now - self._last < self.min_interval:
            return False
        self._last = now
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"ts": now, "pid": os.getpid(), **info}, f)
        os.replace(tmp, self.path)
        return True


def read_heartbeat(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def age_seconds(path: str) -> Optional[float]:
    hb = read_heartbeat(path)
    if hb is None or "ts" not in hb:
        return None
    return time.time() - float(hb["ts"])
