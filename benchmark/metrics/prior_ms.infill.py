"""Device ms of one request's kernels launched inside the port's
`vv.stage=propainter_prior` range (the ProPainter prior), rank 0."""


def read(t):
    ks = t.in_stage("propainter_prior")
    return sum(k.us for k in ks) / 1e3 if ks else None
