#!/usr/bin/env python3
"""Ablation probe of the flash_attn_fwd kernel on the card.

    python3 scripts/flash_ablation.py [--shapes d40] [--variants ...]
        [--baseline DIR] [--passes 2]

Builds variants of `videovanish_tpu_torch/ops/csrc/flash_attn.cu`, each
with one part of the per-tile work taken out or changed (the exponentials,
the bf16 conversion of P, the whole softmax, the P V products, the
ping-pong hand-over between the consumer warpgroups, the number of
consumer warpgroups, the key-tile width or the ring depth), and times
each beside the unmodified kernel at main-path shapes. The variants that
drop work compute wrong results: they only show what that part costs.
With `--baseline DIR`, the `flash_attn.cu` in DIR (built against the
headers in DIR, an earlier version of `ops/csrc/`; one from before the
optional log-sum-exp output is called without it) is timed too, as
variant `baseline`. Times are CUDA-event means
(chip_smoke.time_ms), taken in `--passes` passes, every other one in
reverse order, and averaged; the card's name and power limit are printed
first.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from kernel_variants import ROOT, build, variant_source

# the dispatch lines of the built instances, as flash_attn.cu has them
D48 = "launch_flash<48, 128, 2, 1, 3>"
D80 = "launch_flash<80, 128, 2, 1, 2>"


def swap(line: str, config: str):
    """Edit that builds instance `line` with template arguments `config`."""
    return [(re.escape(line), line.split("<")[0] + f"<{config}>")]


# (pattern, replacement) pairs applied with re.subn; each must match
VARIANTS = {
    "kernel": [],
    "no_ex2": [(re.escape("ex2_approx(fmaf(acc_s[i], scale_log2e, neg_m[r]))"),
                "fmaf(acc_s[i], scale_log2e, neg_m[r])")],
    "no_convert": [(r"pack_f32\(acc_s\[(8 \* kk \+ \d)\], acc_s\[(8 \* kk \+ \d)\]\)",
                    r"(__float_as_uint(acc_s[\1]) ^ __float_as_uint(acc_s[\2]))")],
    "no_softmax": [(re.escape("auto softmax = [&](int kt) {\n"),
                    "auto softmax = [&](int kt) {\n"
                    "      alpha[0] = alpha[1] = 1.f;\n      return;\n")],
    "no_pv": [(re.escape("WgmmaRS<C::NO>::mma(acc_o, pa[kk], db);"),
               "(void)db;")],
    "no_pingpong": [(re.escape("named_bar_sync(1 + wg, 256);"), ""),
                    (re.escape("if (wg != NWG - 1 || !last) "
                               "named_bar_arrive(1 + (wg + 1) % NWG, 256);"),
                     "(void)last;"),
                    (re.escape("if (wg == NWG - 1) named_bar_arrive(1, 256);"),
                     "")],
    # D = 48: consumer warpgroups, key-tile width, ring depth
    "d48_nwg2": swap(D48, "48, 128, 2, 1, 2"),
    "d48_nwg2_bn64": swap(D48, "48, 64, 2, 1, 2"),
    "d48_nwg2_stages3": swap(D48, "48, 128, 3, 1, 2"),
    "d48_nwg2_stages4": swap(D48, "48, 128, 4, 1, 2"),
    "d48_nwg2_stages6": swap(D48, "48, 128, 6, 1, 2"),
    "d48_nwg2_bn64_stages6": swap(D48, "48, 64, 6, 1, 2"),
    "d48_nwg3_stages3": swap(D48, "48, 128, 3, 1, 3"),
    "d48_nwg3_bn64": swap(D48, "48, 64, 4, 1, 3"),
    "d48_nwg4_bn64": swap(D48, "48, 64, 2, 1, 4"),
    "d48_nwg4_bn64_stages4": swap(D48, "48, 64, 4, 1, 4"),
    "d80_nwg3_bn64": swap(D80, "80, 64, 3, 1, 3"),
}

SHAPES = {
    "d40": [(22, 8, 8160, 8160, 40), (22, 8, 4096, 4096, 40)],
    "d80": [(22, 8, 2040, 2040, 80)],
    "d512": [(8, 1, 8160, 8160, 512)],
    # the training step at 64x64 latents (22 frames)
    "train": [(22, 8, 4096, 4096, 40), (22, 8, 4096, 77, 40),
              (22, 8, 1024, 1024, 80), (22, 8, 1024, 77, 80),
              (22, 8, 256, 256, 160)],
    # SAM2: the mask decoder (D = 16), Hiera's global blocks (D = 72),
    # memory self-attention (D = 256)
    "sam2": [(2, 8, 22, 4096, 16), (8, 8, 4096, 4096, 72),
             (2, 1, 4096, 4096, 256)],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="d40", help="comma list of "
                    + ", ".join(SHAPES))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--baseline", type=Path, default=None,
                    help="directory with an earlier flash_attn.cu and its "
                         "headers")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import card_line, time_ms
    from videovanish_tpu_torch.ops import attention as A
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}", flush=True)
    names = args.variants.split(",")
    sources = {n: (variant_source("flash_attn.cu", VARIANTS[n]), None)
               for n in names}
    if args.baseline is not None:
        sources["baseline"] = ((args.baseline / "flash_attn.cu").read_text(),
                               args.baseline)
        names.append("baseline")
    libs = build("flash_attn", sources, ROOT / "build" / "flash_ablation")
    # the lse argument where the source has it (None: no statistics)
    extra = {n: (None,) for n in names}
    if "baseline" in names and "float* lse" not in sources["baseline"][0]:
        fn = libs["baseline"].vv_flash_attn_fwd
        fn.argtypes = fn.argtypes[:4] + fn.argtypes[5:]
        extra["baseline"] = ()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in args.shapes.split(","):
        for B, H, Sq, Sk, D in SHAPES[key]:
            q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16).permute(0, 2, 1, 3)
                       for S in (Sq, Sk, Sk))
            out = A._bhsd_out(q)
            scale = D ** -0.5

            def run(name):
                return lambda: A._launch(libs[name].vv_flash_attn_fwd, q, k,
                                         v, out, scale, extra=extra[name])
            ref = A.flash_attention_ref(q[:1].float(), k[:1].float(),
                                        v[:1].float(), scale)
            errs = []
            for n in ("kernel", "baseline"):
                if n in names:
                    run(n)()
                    err = (out[:1].float() - ref).abs().max().item()
                    errs.append(f"{n} {err:.2e}")
            ms = {n: [] for n in names}
            for p in range(args.passes):
                for n in (names if p % 2 == 0 else names[::-1]):
                    ms[n].append(time_ms(run(n)))
            row = " ".join(f"{n}={sum(t) / len(t):.4f}" for n, t in ms.items())
            print(f"[ablation] B={B} H={H} Sq={Sq} Sk={Sk} D={D} "
                  f"(err vs plain on batch 0: {', '.join(errs)}) ms: {row}",
                  flush=True)
            del q, k, v, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
