"""Host time of a lockstep step outside the engine's call: the window's
wall time less the time spent inside ``step_batch``, over the steps (ms)."""


def read(r):
    steps = r.get("step_s")
    if not steps or "dispatch_exits" not in r:
        return None
    return (r["window_s"] - sum(steps)) / len(steps) * 1e3
