"""Device ms of one request's kernels launched inside the port's
`vv.stage=dn.unet` ranges (each UNet call, motion modules included),
rank 0."""


def read(t):
    ks = t.in_stage("dn.unet")
    return sum(k.us for k in ks) / 1e3 if ks else None
