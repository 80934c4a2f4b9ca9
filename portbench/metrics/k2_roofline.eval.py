"""K2's share of its roofline (%): the least time of the traced launches
(``roofline.k2_launch`` from the observer's shapes) over K2's device time
by kernel name in the trace."""


def read(r):
    t = r.get("trace")
    if t is None or not t["k2_launches"] or t["k2_s"] <= 0:
        return None
    bound = sum(x["seconds"] for x in t["k2_launches"])
    # the observer sees every launch in the slice; where the trace kept a
    # different number of K2 kernels, scale the bound to the trace's count
    bound *= t["k2_count"] / len(t["k2_launches"])
    return 100.0 * bound / t["k2_s"]
