"""Wan2.1-VACE's attention against its roofline, %: the least time of
every attention call the model makes in one request (the reference's
count under part "wan", `counts/roofline.py`: the DiT's self- and
cross-attention, the Wan-VAE's mid-block attention) over the device time
of the attention-class kernels launched inside `vv.stage=wan_denoise`
(the flash instances D = 128 and D = 384)."""
from benchmark.counts.roofline import least_seconds


def read(t):
    calls = t.counts.get("attention", {}).get("wan")
    ks = t.of_class("attention", t.in_stage("wan_denoise"))
    if not calls or not ks:
        return None
    least = least_seconds(calls, t.peak_flops, t.peak_bytes)
    return 100.0 * least / (sum(k.us for k in ks) / 1e6)
