"""Device ms of one masking request's kernels over its frames."""


def read(t):
    return sum(k.us for k in t.kernels) / 1e3 / t.frames \
        if t.kernels else None
