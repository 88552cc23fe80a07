#!/usr/bin/env python3
"""Times the backward attention kernels on the card, beside variants and
earlier versions of them.

    python3 scripts/bwd_ablation.py [--variants kernel,no_pingpong]
        [--baseline NAME=DIR ...] [--passes 4]

Builds `flash_attn_bwd.cu` and `small_seq_attn_bwd.cu` from
`videovanish_tpu_torch/ops/csrc/` (variant `kernel`), variants of
flash_attn_bwd.cu with one part changed or taken out (`no_pingpong`: no
hand-over of turns between the consumer warpgroups; `dq_nwg2`,
`dq80_nwg2`, `kv_nwg3`: two warpgroups in the dQ pass at D = 40 or 80,
three in the dK/dV pass at D = 40; `no_ex2`: no exponentials, which
gives wrong results and shows only what they cost; `fused_dq`: dQ folded
into the dK/dV pass, from scripts/bwd_variants/), and with each
`--baseline NAME=DIR` the same files in DIR against DIR's headers (an
earlier `ops/csrc/` with the same C interface, unpacked with
`git archive <commit> videovanish_tpu_torch/ops/csrc` into the git-ignored
`build/`). At each backward instance the training step launches
(chip_smoke's train_cases), with bf16 q, k, v and dO from a seed and O
(and flash's log-sum-exp) from the port's forward kernel, it holds every
variant's dq, dk and dv to 1e-2 * max|plain| of attention_backward_ref
(printed, not enforced), times each by CUDA events (chip_smoke.time_ms)
in `--passes` passes, every other one in reverse order, and splits each
variant's call by kernel with torch.profiler (device ms a call). Prints
the card's name and power limit first, then a line an instance with each
variant's mean ms, and a line a variant with the split.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from kernel_variants import ROOT, build, variant_source

SOURCES = {"flash_attn_bwd": "flash_attn_bwd.cu",
           "small_seq_attn_bwd": "small_seq_attn_bwd.cu"}
# (pattern, replacement) edits of flash_attn_bwd.cu; small_seq_attn_bwd.cu
# is built unchanged under every name
VARIANTS = {
    "kernel": [],
    "no_pingpong": [(re.escape("PingPong<NWG> pp(wg);"),
                     "PingPong<1> pp(wg);")],
    "dq_nwg2": [(re.escape("flash_bwd<48, 40, 3, 64,"),
                 "flash_bwd<48, 40, 2, 64,")],
    "dq80_nwg2": [(re.escape("flash_bwd<80, 80, 3, 64,"),
                   "flash_bwd<80, 80, 2, 64,")],
    "kv_nwg3": [(re.escape("flash_bwd<48, 40, 3, 64, 3, 2, 64, 3>"),
                 "flash_bwd<48, 40, 3, 64, 3, 3, 64, 3>")],
    "no_ex2": [(re.escape("ex2_approx("), "(")],
    # dQ folded into the dK/dV pass in key-block order (D = 40 and 80)
    "fused_dq": [
        (re.escape("}  // namespace vv"),
         lambda m: (ROOT / "scripts" / "bwd_variants" /
                    "flash_attn_bwd_fused_dq.cuh").read_text() + m.group(0)),
        (re.escape("vv::launch_flash_bwd<48, 40, 3, 64, 3, 2, 64, 3>"),
         "vv::flash_bwd_fused<48, 40, 2, 3>"),
        (re.escape("vv::launch_flash_bwd<80, 80, 3, 64, 3, 2, 64, 3>"),
         "vv::flash_bwd_fused<80, 80, 2, 2>")],
}


def split_by_kernel(fn, calls: int = 5) -> dict:
    """Device ms a call of each CUDA kernel fn() launches (torch.profiler
    over `calls` calls)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        m = re.search(r"\d+([a-z_]+_kernel)", evt.key)
        name = m.group(1) if m else evt.key[:40]
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="kernel")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=DIR: earlier backward sources and their "
                         "headers in DIR, timed as variant NAME")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import TOL, backward_cases, card_line, time_ms
    from videovanish_tpu_torch.ops import attention as A
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}", flush=True)
    libs = {}
    baselines = dict(b.split("=", 1) for b in args.baseline)
    for lib, cu in SOURCES.items():
        sources = {n: (variant_source(cu, VARIANTS[n] if lib ==
                                      "flash_attn_bwd" else []), None)
                   for n in args.variants.split(",")}
        for name, d in baselines.items():
            sources[name] = ((Path(d) / cu).read_text(), Path(d))
        libs[lib] = build(lib, sources, ROOT / "build" / "bwd_ablation" / lib)
    names = list(libs["flash_attn_bwd"])

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    for key, route, shape in backward_cases():
        if route == "flash":
            B, H, Sq, Sk, D = shape
            heads = 0
            q, k, v, dout = (randn(B, S, H, D).permute(0, 2, 1, 3)
                             for S in (Sq, Sk, Sk, Sq))
            out, lse = A._flash_forward(q, k, v, D ** -0.5, with_lse=True)
            lib = "flash_attn_bwd"
        else:
            N, S, C, H = shape
            B, Sq, Sk, D = N, S, S, C // H
            heads = H if route == "tokenmajor" else 0
            q, k, v, dout = (randn(N, S, C) for _ in range(4))
            out, lse = A._small_seq_forward(q, k, v, D ** -0.5, heads), None
            lib = "small_seq_attn_bwd"
        scale = D ** -0.5
        grads = [torch.empty_like(t) if heads else A._bhsd_out(t)
                 for t in (q, k, v)]
        ts = (q, k, v, out, dout, *grads)
        ops = [A._operand(t, "op", heads) for t in ts]
        dims = (B, H, Sq, Sk, D)
        # delta, and for fused_dq its f32 dQ and hand-over counters
        delta = torch.empty(B * H * (Sq * (1 + D) + -(-Sq // 64)),
                            dtype=torch.float32, device="cuda")
        extra = (lse.data_ptr(), delta.data_ptr()) if lse is not None else ()

        entry = "vv_flash_attn_bwd" if lse is not None \
            else "vv_small_seq_attn_bwd"

        def run(name):
            fn = getattr(libs[lib][name], entry)
            return lambda: A._run(fn, ops, dims, scale, *ts, extra=extra,
                                  flops_per=10)

        def split(t):
            return A._split_heads(t, heads) if heads else t
        ref = A.attention_backward_ref(*(split(t).float()
                                         for t in (q, k, v, out, dout)), scale)
        errs = []
        for n in names:
            run(n)()
            torch.cuda.synchronize()
            worst = max((split(g).float() - r).abs().max().item()
                        / (TOL * r.abs().max().item())
                        for g, r in zip(grads, ref))
            errs.append(f"{n} {worst:.2f}")
        del ref
        ms = {n: [] for n in names}
        for p in range(args.passes):
            for n in (names if p % 2 == 0 else names[::-1]):
                ms[n].append(time_ms(run(n)))
        row = " ".join(f"{n}={sum(t) / len(t):.4f}" for n, t in ms.items())
        print(f"[bwd] {key} (worst err / limit of dq, dk, dv: "
              f"{', '.join(errs)}) ms: {row}", flush=True)
        for n in names:
            parts = split_by_kernel(run(n))
            print(f"[bwd-split] {key} {n}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(parts.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
