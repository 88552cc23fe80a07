"""DiffuEraser's attention against its roofline, %: the least time of
every attention call the model makes in one request (the reference's
count, `counts/roofline.py`) over the device time of the attention-class
kernels launched inside `vv.stage=diffueraser_denoise`. Calls the port
sends to its plain path (none of its kernels) are in the least time and
not in the device time."""
from benchmark.counts.roofline import least_seconds


def read(t):
    calls = t.counts.get("attention", {}).get("diffueraser")
    ks = t.of_class("attention", t.in_stage("diffueraser_denoise"))
    if not calls or not ks:
        return None
    least = least_seconds(calls, t.peak_flops, t.peak_bytes)
    return 100.0 * least / (sum(k.us for k in ks) / 1e6)
