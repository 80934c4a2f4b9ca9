"""Model FLOPs of the traced lockstep steps, each lane counted at its own
exit (``flops.served_step_flops``), over the traced slice's length and
989 TFLOP/s (bf16, dense) (%)."""

from roofline import PEAK_FLOPS


def read(r):
    t = r.get("trace")
    if t is None or not r.get("traced_exits"):
        return None
    per = r["flops_by_exit"]
    work = sum(per[int(e)] for ex in r["traced_exits"] for e in ex)
    return 100.0 * work / (t["window_s"] * PEAK_FLOPS["bfloat16"])
