"""The whole request's share of the chips' dense bf16 peak, %: the FLOPs
of every matmul, convolution and attention product one request makes (the
reference's count, `counts/model.py`) over the median wall of the
unprofiled requests times the peak of all the cell's chips."""


def read(t):
    flops = t.counts.get("flops")
    if not flops:
        return None
    return 100.0 * flops / (t.wall_s * t.peak_flops * t.chips)
