#!/usr/bin/env python3
"""Where the card's time goes in one SAM2 masking request of the port.

    python3 scripts/profile_port_sam2.py [--frames 24] [--height 720]
        [--width 1280]

Builds the port's SAM2 predictor at the default Sam2Config (Hiera-L at
1024x1024) with seeded random weights, runs chip_smoke.py's SAM2 request
(`run_sam2_on_frames` on its synthetic scene, two objects: a click and a
box on frame 0, a negative click on frame 8) once to warm up, twice timed
on the host clock, and once under torch.profiler. Prints one JSON line:
the wall times, the summed kernel time by kernel class (the classes of
scripts/profile_port_infill.py), and the share of the profiled run's wall
time the card was busy. The full kernel table goes to
build/profiles/profile_port_sam2_<frames>x<height>x<width>.txt under the
checkout (git-ignored). Needs a CUDA device.
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
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_port_sam2: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from chip_smoke import card_line, sam2_annotations, synthetic_request
    from profile_port_infill import classify
    from videovanish_tpu_torch.pipeline import masker

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    masker._get_predictor("cuda")
    T, H, W = args.frames, args.height, args.width
    frames = list(synthetic_request(T, H, W, 3)[0])
    ann = sam2_annotations(H, W)

    def request():
        masker.run_sam2_on_frames(frames, ann, device="cuda")
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

    by_class = defaultdict(float)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_class[classify(evt.key)] += us / 1e3
        rows.append((us / 1e3, evt.count, evt.key))
    busy_ms = sum(by_class.values())
    out_dir = os.path.join(ROOT, "build", "profiles")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_port_sam2_{T}x{H}x{W}.txt"),
              "w") as f:
        f.write(f"{card_line()}\n{T}x{H}x{W}, 2 objects, wall "
                f"{wall * 1e3:.3f} ms\n")
        for ms, count, key in sorted(rows, reverse=True):
            f.write(f"{ms:12.3f} ms {count:7d}  {classify(key):15s} {key}\n")
    print(json.dumps({
        "card": card_line(),
        "request": [T, H, W],
        "objects": 2,
        "wall_ms_unprofiled": [w * 1e3 for w in walls],
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "busy_share": busy_ms / (wall * 1e3) if busy_ms else "not measured",
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels": [{"ms": ms, "count": n, "name": key[:120]}
                        for ms, n, key in sorted(rows, reverse=True)[:15]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
