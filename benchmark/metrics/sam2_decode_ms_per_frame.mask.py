"""Device ms a frame of one masking request's kernels launched inside the
port's `vv.stage=sam2.decode` ranges (the decode: prompt encoder, mask
decoder, mask selection, logits resize and threshold), over the
request's frames."""


def read(t):
    ks = t.in_stage("sam2.decode")
    return sum(k.us for k in ks) / 1e3 / t.frames if ks else None
