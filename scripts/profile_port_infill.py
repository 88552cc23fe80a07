#!/usr/bin/env python3
"""Where the card's time goes in one request of the PyTorch/CUDA port.

    python3 scripts/profile_port_infill.py [--frames 22] [--height 720]
        [--width 1280]

Builds the port's DiffuEraser at the default (full SD1.5) width with seeded
random weights, runs one `run_infill_on_frames` request with the prior
passed in (chip_smoke.py's synthetic scene) to warm up, then runs it again
under torch.profiler. Prints one JSON line: the request's wall time in two
runs without the profiler and in the profiled run, the summed kernel time
by kernel class (the port's two attention kernels, convolutions, matmuls,
normalisation, the rest), and the share of the profiled run's wall time
the card was busy. The full kernel table goes to
build/profiles/profile_port_infill_<frames>x<height>x<width>.txt under
the checkout (git-ignored). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSES = [  # (class, substrings of the kernel name), first match wins
    ("flash_attn_fwd", ("flash_fwd_kernel",)),
    ("small_seq_attn", ("small_seq_attn_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "winograd")),
    ("matmul", ("gemm", "cutlass", "nvjet", "cublas", "xmma")),
    ("norm", ("group_norm", "GroupNorm", "layer_norm", "LayerNorm",
              "welford", "Welford")),
    ("softmax", ("softmax", "Softmax")),
]


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=22)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_port_infill: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, synthetic_request
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.pipeline import infill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    infill.set_config(default_config())
    infill.get_model("2-Step", device="cuda")
    frames, masks, prior = synthetic_request(args.frames, args.height,
                                             args.width, 0)

    def request():
        infill.run_infill_on_frames(list(frames), list(masks),
                                    propainer_frames=list(prior),
                                    device="cuda")
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
    name = f"profile_port_infill_{args.frames}x{args.height}x{args.width}.txt"
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"{card_line()}\n{args.frames}x{args.height}x{args.width}, "
                f"wall {wall * 1e3:.3f} ms\n")
        for ms, count, key in sorted(rows, reverse=True):
            f.write(f"{ms:12.3f} ms {count:7d}  {classify(key):15s} {key}\n")
    print(json.dumps({
        "card": card_line(),
        "request": [args.frames, args.height, args.width],
        "wall_ms_unprofiled": [w * 1e3 for w in walls],
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "busy_share": busy_ms / (wall * 1e3) if busy_ms else "not measured",
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
