"""Device ms a frame that one masking request's device waits on the host
after a synchronising copy: of the idle stretches between the first
device operation's start and the last one's end (kernels and copies, by
start time), those where the operation that ended last before the stretch
was launched inside a `vv.stage=sam2.upload` or `vv.stage=sam2.fetch`
range (a copy from pageable host memory, or to the host, waits for the
device), summed over the request's frames."""
from benchmark.trace import STAGE_RANGE

SYNCS = (STAGE_RANGE + "sam2.upload", STAGE_RANGE + "sam2.fetch")


def _syncs(k) -> bool:
    return any(r in SYNCS for r in k.ranges)


def read(t):
    ops = sorted(t.kernels, key=lambda k: k.start)
    if not any(_syncs(k) for k in ops):
        return None
    idle, last = 0.0, None
    for k in ops:
        if last is not None and k.start > last.end and _syncs(last):
            idle += k.start - last.end
        if last is None or k.end > last.end:
            last = k
    return idle / 1e3 / t.frames
