"""Device ms of one request's kernels launched inside the port's
`vv.stage=wan.vace` ranges (the VACE context blocks of every DiT
forward), rank 0."""


def read(t):
    ks = t.in_stage("wan.vace")
    return sum(k.us for k in ks) / 1e3 if ks else None
