#!/usr/bin/env python3
"""Probe of the small_seq_attn kernel's design choices on the card.

    python3 scripts/small_seq_ablation.py [--shapes d40,d80,d160,d160n135,s64]
        [--variants kernel,stages2,...] [--baseline DIR]

Builds variants of `videovanish_tpu_torch/ops/csrc/small_seq_attn.cu`, each
with one choice of the launch plan changed (the ring depth, the heads per
unit, the consumer warps per CTA or per pair, the shared-memory row
pitch), and times each beside the
unmodified kernel on the token-major main-path shapes. With `--baseline
DIR`, the `small_seq_attn.cu` in DIR (built against the headers in DIR, an
earlier version of `ops/csrc/` with the same C interface) is timed too, as
variant `baseline`. Every variant computes the same function; each is
checked against the plain version on the first sequences. Times are device
times (chip_smoke.device_ms: calls replayed from a CUDA graph, so the host's
launch work is not counted), taken in two passes in opposite orders and
averaged; `call ms` times the kernel and the baseline launched one after
another from Python, host work included. The card's name and power limit
are printed first.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from kernel_variants import ROOT, build, variant_source


def const(name: str, value: int):
    """Edit that sets `constexpr int <name> = ...;` to value."""
    return [(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")]


# (pattern, replacement) pairs applied with re.subn; each must match
VARIANTS = {
    "kernel": [],
    "stages2": const("kSmallMaxStages", 2),  # ring depth
    "stages3": const("kSmallMaxStages", 3),
    "pairs1": const("kSmallMaxPairs", 1),    # heads per unit
    "pairs2": const("kSmallMaxPairs", 2),
    "warps4": const("kSmallWarps", 4),       # consumer warps per CTA
    "wpp1": [(re.escape("int wpp = kSmallWarps / pairs;"),  # warps per pair
              "int wpp = 1;")],
    # shared-memory row pitch: always DP (ldmatrix conflicts), always DP + 8
    "dense_pitch": [(re.escape("dp % 32 == 0 ? dp + 8 : dp;"), "dp;")],
    "pad_pitch": [(re.escape("dp % 32 == 0 ? dp + 8 : dp;"), "dp + 8;")],
}

SHAPES = {  # token-major (N, S, C, heads) as the main path gives them
    "d40": (8160, 22, 320, 8),
    "d80": (2040, 22, 640, 8),
    "d160": (510, 22, 1280, 8),
    "d160n135": (135, 22, 1280, 8),
    "s64": (22, 64, 1280, 8),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory with an earlier small_seq_attn.cu and "
                         "its headers")
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import card_line, device_ms, time_ms
    from videovanish_tpu_torch.ops import attention as A
    if not torch.cuda.is_available():
        print("small_seq_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}", flush=True)
    names = args.variants.split(",")
    if args.baseline is not None:
        names.append("baseline")
    sources = {n: (variant_source("small_seq_attn.cu", VARIANTS[n]), None)
               for n in names if n != "baseline"}
    if args.baseline is not None:
        sources["baseline"] = (
            (args.baseline / "small_seq_attn.cu").read_text(), args.baseline)
    libs = build("small_seq_attn", sources,
                 ROOT / "build" / "small_seq_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in args.shapes.split(","):
        N, S, C, heads = SHAPES[key]
        d = C // heads
        q, k, v = (A._split_heads(torch.randn(
            N, S, C, generator=gen, device="cuda", dtype=torch.bfloat16),
            heads) for _ in range(3))
        out = A._split_heads(torch.empty(N, S, C, device="cuda",
                                         dtype=torch.bfloat16), heads)
        scale = d ** -0.5
        ref = A.small_seq_attention_ref(q[:8].float(), k[:8].float(),
                                        v[:8].float(), scale)

        def run(name):
            return lambda: A._launch(libs[name].vv_small_seq_attn, q, k, v,
                                     out, scale)
        errs, ok = {}, []
        for n in names:
            out.zero_()
            try:
                run(n)()
            except RuntimeError as e:  # report the variant, time the rest
                print(f"[ablation] {key}: variant {n} refused: {e}")
                continue
            errs[n] = (out[:8].float() - ref).abs().max().item()
            ok.append(n)
        ms = {n: [] for n in ok}
        for order in (ok, ok[::-1]):
            for n in order:
                ms[n].append(device_ms(run(n)))
        row = " ".join(f"{n}={sum(t) / len(t):.4f}" for n, t in ms.items())
        # host work included: launches issued one after another from Python
        calls = " ".join(f"{n}={time_ms(run(n)):.4f}" for n in ok
                         if n in ("kernel", "baseline"))
        worst = max(errs.values())
        print(f"[ablation] {key} N={N} S={S} H={heads} D={d} (max err vs "
              f"plain on 8 sequences: {worst:.2e}, limit "
              f"{1e-2 * ref.abs().max().item():.2e}) ms: {row}; call ms: "
              f"{calls}", flush=True)
        del q, k, v, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
