#!/usr/bin/env python3
"""Where the card's time goes in one request of the PyTorch/CUDA port.

    python3 scripts/profile_port_infill.py [--frames 22] [--height 720]
        [--width 1280] [--computed-prior]

Builds the port's DiffuEraser at the default (full SD1.5) width with seeded
random weights, runs one `run_infill_on_frames` request with the prior
passed in (chip_smoke.py's synthetic scene), or with --computed-prior
without it (the port's Propainter computes the prior at the published
widths), to warm up, twice timed on the host clock, once under
torch.profiler and once more under it with_flops. Prints one
JSON line: the request's wall time in two runs without the profiler and in
the profiled run, the summed kernel time by kernel class (the port's two
attention kernels, convolutions, matmuls, normalisation, gathers, the
rest; `videovanish_tpu_torch.utils.profiling.classify`) and the share of
the profiled run's wall time the card was busy, both from the run without
with_flops, and the device ms, share and MFU by stage
(`rows_from_profiler`, `aggregate_programs`) from the run with it.
The full kernel table goes to
build/profiles/profile_port_infill_<frames>x<height>x<width>[_prior].txt
under the checkout (git-ignored). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=22)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--computed-prior", action="store_true",
                    help="no prior passed in: the Propainter computes it")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_port_infill: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, synthetic_request
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.pipeline import infill
    from videovanish_tpu_torch.utils.profiling import (
        aggregate_programs, kernel_table, rows_from_profiler,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    infill.set_config(default_config())
    infill.get_model("2-Step", device="cuda")
    frames, masks, prior = synthetic_request(args.frames, args.height,
                                             args.width, 0)
    prior = None if args.computed_prior else list(prior)

    def request():
        infill.run_infill_on_frames(list(frames), list(masks),
                                    propainer_frames=prior, device="cuda")
        torch.cuda.synchronize()

    request()  # warm-up: kernel builds, cuDNN plans, allocator
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        request()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        request()
        wall = time.perf_counter() - t0
    # the stage split's flop counts need the ops' shapes, whose recording
    # slows the host: a second profiled run, apart from the busy share's
    with torch.profiler.profile(activities=acts, with_flops=True) as prof_f:
        t0 = time.perf_counter()
        request()
        wall_f = time.perf_counter() - t0

    # the kernels alone: the device-side copies of the stage and flop
    # ranges are not device work
    rows = kernel_table(rows_from_profiler(prof))
    by_class = defaultdict(float)
    for ms, _, cls, _ in rows:
        by_class[cls] += ms
    busy_ms = sum(by_class.values())
    out_dir = os.path.join(ROOT, "build", "profiles")
    os.makedirs(out_dir, exist_ok=True)
    name = (f"profile_port_infill_{args.frames}x{args.height}x{args.width}"
            f"{'_prior' if args.computed_prior else ''}.txt")
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"{card_line()}\n{args.frames}x{args.height}x{args.width}, "
                f"wall {wall * 1e3:.3f} ms\n")
        for ms, count, cls, key in rows:
            f.write(f"{ms:12.3f} ms {count:7d}  {cls:15s} {key}\n")
    print(json.dumps({
        "card": card_line(),
        "request": [args.frames, args.height, args.width],
        "prior": "computed" if args.computed_prior else "passed in",
        "wall_ms_unprofiled": [w * 1e3 for w in walls],
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "busy_share": busy_ms / (wall * 1e3) if busy_ms else "not measured",
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
        # device ms, share and MFU by stage (utils/profiling), from the
        # run under with_flops
        "wall_ms_with_flops": wall_f * 1e3,
        "stage_split": aggregate_programs(rows_from_profiler(prof_f)),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
