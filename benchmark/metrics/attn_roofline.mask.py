"""SAM2's attention against its roofline, %: the least time of every
attention call the model makes in one request (the reference's count,
`counts/roofline.py`) over the device time of every kernel launched inside
the port's attention calls (a `vv.stage=attention` range, any route: the
masked calls' plain f32 matmuls, softmax and casts count with the
hand-written kernels)."""
from benchmark.counts.roofline import least_seconds
from benchmark.trace import STAGE_RANGE

CALL = STAGE_RANGE + "attention"


def read(t):
    calls = t.counts.get("attention", {}).get("sam2")
    ks = [k for k in t.kernels if any(r.startswith(CALL) for r in k.ranges)]
    if not calls or not ks:
        return None
    least = least_seconds(calls, t.peak_flops, t.peak_bytes)
    return 100.0 * least / (sum(k.us for k in ks) / 1e6)
