"""The device's idle share of a request, %: one less the union of the
profiled request's compute kernels over the median wall of the
unprofiled requests (the profiler's host cost would swell its own wall),
rank 0. NCCL kernels are not counted as busy: they wait on the device
for the slowest rank, and the profiler's host cost on the other ranks
swells that wait."""


def read(t):
    ks = [k for k in t.kernels if k.cls != "nccl"]
    if not ks:
        return None
    return 100.0 * (1.0 - t.busy_us(ks) / 1e6 / t.wall_s)
