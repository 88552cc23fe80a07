"""Device ms of one request's kernels launched inside the port's
`vv.stage=wan.dit` ranges (every DiT forward, its VACE blocks included),
rank 0."""


def read(t):
    ks = t.in_stage("wan.dit")
    return sum(k.us for k in ks) / 1e3 if ks else None
