"""Device ms a frame of one masking request's kernels launched inside the
port's `vv.stage=sam2.memory_encode` ranges (the memory encoder: the
high-res mask, the encoder and the bank's writes), over the request's
frames."""


def read(t):
    ks = t.in_stage("sam2.memory_encode")
    return sum(k.us for k in ks) / 1e3 / t.frames if ks else None
