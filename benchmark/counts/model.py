"""What one request computes, counted while the reference runs it: the
FLOPs of every matmul, batched matmul and convolution by the shape
formulas of `torch.utils.flop_counter` (attention's two products
included), and the shape (B, H, Sq, Sk, D) of every attention call, by
the part of the pipeline that makes it. Elementwise work is not counted.
The reference computes what the configuration states (the same layers,
steps and reuse switches) at the request's shapes, so the count is the
model's, whichever kernels the port launches for it."""
from __future__ import annotations

import contextlib

from benchmark.reference.vvref.ops import attention as ref_attention


class Counter:
    def __init__(self):
        self.part = "other"
        self.attention: dict = {}
        self.flops = 0.0

    def _record(self, B, H, Sq, Sk, D):
        self.attention.setdefault(self.part, []).append((B, H, Sq, Sk, D))

    @contextlib.contextmanager
    def counting(self):
        from torch.utils.flop_counter import FlopCounterMode
        mode = FlopCounterMode(display=False)
        ref_attention.RECORDERS.append(self._record)
        try:
            with mode:
                yield self
        finally:
            ref_attention.RECORDERS.remove(self._record)
            self.flops += float(mode.get_total_flops())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "attention": self.attention}


@contextlib.contextmanager
def maybe_counting(on: bool):
    """A Counter counting inside the block, or None."""
    if not on:
        yield None
        return
    c = Counter()
    with c.counting():
        yield c
