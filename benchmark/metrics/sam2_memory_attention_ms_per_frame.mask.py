"""Device ms a frame of one masking request's kernels launched inside the
port's `vv.stage=sam2.memory_attention` ranges (memory attention: the
bank's keys, values and positions, and the attention layers), over the
request's frames."""


def read(t):
    ks = t.in_stage("sam2.memory_attention")
    return sum(k.us for k in ks) / 1e3 / t.frames if ks else None
