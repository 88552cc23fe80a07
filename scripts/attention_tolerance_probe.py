#!/usr/bin/env python3
"""How much room chip_smoke.py's kernel check leaves at the long flash shapes.

    python scripts/attention_tolerance_probe.py [--pairs 3]

For a few (batch, head) pairs of random bf16 q/k/v at the main path's long
self-attention shapes, prints max|plain| (the check's limit is 1e-2 times
it) and the error two plausible kernel faults would show against the plain
version: dropping the ragged key tail past the last full 64-key tile, and
scaling by the zero-padded head dim. Runs the port's plain version on the
CPU; a few GiB of memory at the default of 3 pairs.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from videovanish_tpu_torch.ops.attention import plain_attention  # noqa: E402

SHAPES = [(8160, 40), (8160, 512), (4096, 40)]  # (S, D)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.manual_seed(args.seed)
    for S, D in SHAPES:
        pairs = 1 if D >= 512 else args.pairs
        q, k, v = (torch.randn(1, pairs, S, D).bfloat16().float()
                   for _ in range(3))
        scale = D ** -0.5
        ref = plain_attention(q, k, v, scale, max_score_bytes=1 << 30)
        limit = 1e-2 * ref.abs().max().item()
        keep = S - (S % 64 or 64)
        dropped = plain_attention(q, k[:, :, :keep], v[:, :, :keep], scale,
                                  max_score_bytes=1 << 30)
        padded = -(-D // 16) * 16
        rescaled = plain_attention(q, k, v, padded ** -0.5,
                                   max_score_bytes=1 << 30)

        def err(x):
            return (x - ref).abs().max().item()
        print(f"S={S} D={D} pairs={pairs}: max|plain|={limit * 100:.4g} "
              f"limit={limit:.3g}; dropped key tail ({S - keep} keys) "
              f"err={err(dropped):.3g}; scale by padded D={padded} "
              f"err={err(rescaled):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
