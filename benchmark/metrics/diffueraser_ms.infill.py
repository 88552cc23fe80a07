"""Device ms of one request's kernels launched inside the port's
`vv.stage=diffueraser_denoise` range (VAE, BrushNet, UNet, decode),
rank 0."""


def read(t):
    ks = t.in_stage("diffueraser_denoise")
    return sum(k.us for k in ks) / 1e3 if ks else None
