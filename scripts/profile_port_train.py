#!/usr/bin/env python3
"""Where the card's time goes in one training step of the PyTorch/CUDA
port.

    python3 scripts/profile_port_train.py [--csrc DIR] [--seed 0]

Builds chip_smoke's training phase (the default config's UNet with motion
modules and BrushNet at full width, seeded; one clip of TRAIN_CLIP
latents, 1 x 22 x 40 x 40), runs one warm-up step of `make_train_step`
with remat, two steps timed on the host clock, one under torch.profiler
and one more under it with_flops. Prints one JSON line: the card, the
steps' wall times, the
summed kernel time by kernel class (the attention kernels forward and
backward, convolutions, matmuls, normalisation, AdamW, the rest:
elementwise, casts, layout; `videovanish_tpu_torch.utils.profiling
.classify`), the share of the profiled step's wall time the card was busy
and the attention kernels' launches per step, from the step without
with_flops, and the device ms, share and MFU by stage
(`rows_from_profiler`, `aggregate_programs`) from the step with it.
`--csrc DIR` builds the attention kernels from another copy of
`ops/csrc/` (an earlier version unpacked into the git-ignored `build/`),
so two versions can be profiled in one call. The full kernel table goes
to build/profiles/profile_port_train[_<DIR name>].txt under the checkout
(git-ignored). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="build the attention kernels from this directory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_port_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import TRAIN_CLIP, TRAIN_LR, card_line, train_setup
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.ops import kernels
    from videovanish_tpu_torch.train import make_train_step
    from videovanish_tpu_torch.utils.profiling import (
        aggregate_programs, kernel_table, rows_from_profiler,
    )

    if args.csrc is not None:
        kernels.CSRC = args.csrc.resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unet, brushnet, batch, t, noise = train_setup(args.seed)
    init_fn, step_fn = make_train_step(unet, brushnet, None,
                                       learning_rate=TRAIN_LR, remat=True)
    state = init_fn()

    def step():
        nonlocal state
        state, loss = step_fn(state, batch, t=t, noise=noise)
        torch.cuda.synchronize()
        return float(loss)

    step()  # warm-up: kernel builds, cuDNN plans, allocator
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    A.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    # the stage split's flop counts need the ops' shapes, whose recording
    # slows the host: a second profiled run, apart from the busy share's
    with torch.profiler.profile(activities=acts, with_flops=True) as prof_f:
        t0 = time.perf_counter()
        step()
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
    tag = f"_{args.csrc.parent.parent.parent.name}" if args.csrc else ""
    with open(os.path.join(out_dir, f"profile_port_train{tag}.txt"),
              "w") as f:
        f.write(f"{card_line()}\nclip {TRAIN_CLIP}, kernels from "
                f"{kernels.CSRC}, wall {wall * 1e3:.3f} ms\n")
        for ms, count, cls, key in rows:
            f.write(f"{ms:12.3f} ms {count:7d}  {cls:18s} {key}\n")
    print(json.dumps({
        "card": card_line(),
        "clip_B_T_h_w": list(TRAIN_CLIP),
        "kernels_from": str(kernels.CSRC),
        "step_ms_unprofiled": [w * 1e3 for w in walls],
        "step_ms": wall * 1e3,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "busy_share": busy_ms / (wall * 1e3) if busy_ms else "not measured",
        "device_ms_by_class": dict(sorted(by_class.items(),
                                          key=lambda kv: -kv[1])),
        # device ms, share and MFU by stage (utils/profiling), from the
        # run under with_flops
        "wall_ms_with_flops": wall_f * 1e3,
        "stage_split": aggregate_programs(rows_from_profiler(prof_f)),
        "attention_launches_per_step": launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
