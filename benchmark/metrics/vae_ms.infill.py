"""Device ms of one request's kernels launched inside the port's
`vv.stage=dn.vae` ranges (every VAE encode and decode, with its pixel
scaling), rank 0."""


def read(t):
    ks = t.in_stage("dn.vae")
    return sum(k.us for k in ks) / 1e3 if ks else None
