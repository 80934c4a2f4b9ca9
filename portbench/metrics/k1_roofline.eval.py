"""K1's share of its roofline (%): the least time of the traced launches
(``roofline.k1_launch`` from the observer's shapes) over K1's device time
by kernel name in the trace."""


def read(r):
    t = r.get("trace")
    if t is None or not t["k1_launches"] or t["k1_s"] <= 0:
        return None
    bound = sum(x["seconds"] for x in t["k1_launches"])
    # the observer sees every launch in the slice; where the trace kept a
    # different number of K1 kernels, scale the bound to the trace's count
    bound *= t["k1_count"] / len(t["k1_launches"])
    return 100.0 * bound / t["k1_s"]
