"""Device ms of one request's kernels launched inside the port's
`vv.stage=wan.vae_encode` and `vv.stage=wan.vae_decode` ranges (the two
Wan-VAE encodes and the decode), rank 0."""


def read(t):
    ks = t.in_stage("wan.vae_encode") + t.in_stage("wan.vae_decode")
    return sum(k.us for k in ks) / 1e3 if ks else None
