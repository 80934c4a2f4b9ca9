"""CUDA kernels launched a lockstep step, from the traced slice."""


def read(r):
    t = r.get("trace")
    if t is None or not r.get("traced_exits"):
        return None
    return t["launches"] / len(r["traced_exits"])
