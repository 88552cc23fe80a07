"""Device ms of one request's kernels of no matmul, convolution,
attention, norm or NCCL class (`kernel_classes/`): elementwise work,
casts, layout copies, rank 0."""


def read(t):
    ks = t.of_class("glue")
    return sum(k.us for k in ks) / 1e3 if ks else None
