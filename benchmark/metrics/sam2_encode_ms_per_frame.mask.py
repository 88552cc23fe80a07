"""Device ms a frame of one masking request's kernels launched inside the
port's `vv.stage=sam2.encode` ranges (Hiera's encode: the frames'
upload, I420 to RGB, resize, trunk and neck), over the request's frames."""


def read(t):
    ks = t.in_stage("sam2.encode")
    return sum(k.us for k in ks) / 1e3 / t.frames if ks else None
