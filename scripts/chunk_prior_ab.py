#!/usr/bin/env python3
"""Time the port's chunked pipeline against another version of its
`pipeline/chunking.py`, on the card, in alternating pairs.

    python3 scripts/chunk_prior_ab.py --variant PATH [--frames 88]
        [--pairs 4] [--out build/chunk_prior_ab.json]

Writes chip_smoke.py's synthetic scene (--frames frames at 1280x720, the
color video and its mask video) with the port's writer, then runs
`vanish_video_chunked` at the default config (chunks of 48 overlapping by 8)
from the package's module ("package") and from the file at --variant
("variant", loaded as a module of its own beside the package's; it drives
the same `pipeline/infill.py` and the same model singletons). One warm-up
run of each, then --pairs pairs in mirrored order (package, variant,
variant, package, ...). Each run is timed on the host clock from the call to
the written file, the card synchronized at both ends, and its stage records
are summed by name. Prints the card's line, one line per run and a JSON
summary (each side's runs, mean, min, max and spread, the mean difference,
whether every file equals the first bitwise); the summary also goes to
--out. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", required=True,
                    help="a chunking.py to time beside the package's")
    ap.add_argument("--frames", type=int, default=88)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chunk_prior_ab.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, synthetic_request
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.pipeline import chunking
    from videovanish_tpu_torch.utils.observability import collect_stages
    from videovanish_tpu_torch.video import io as vio

    spec = importlib.util.spec_from_file_location("chunking_variant",
                                                  args.variant)
    variant = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variant)
    sides = {"package": chunking, "variant": variant}

    print(card_line(), flush=True)
    cfg = default_config()
    T, H, W = args.frames, 720, 1280
    tmp = os.path.join(ROOT, "build", "chunk_prior_ab")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        frames, masks, _ = synthetic_request(T, H, W, 7)
        color = os.path.join(tmp, "color.mkv")
        mask = os.path.join(tmp, "mask.mkv")
        vio.write_video_frames_to_path(color, list(frames), 24.0, H, W)
        vio.write_video_frames_to_path(
            mask, list(np.repeat(masks[..., None], 3, axis=-1)), 24.0, H, W)
        del frames, masks

        first = None
        same = True
        times = {k: [] for k in sides}
        stages_of = {k: [] for k in sides}

        def run(side, timed):
            nonlocal first, same
            out = os.path.join(tmp, f"{side}.mkv")
            stages = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with collect_stages(stages):
                sides[side].vanish_video_chunked(
                    color, mask, out,
                    mask_dilation_iter=cfg.infill.mask_dilation_iter,
                    max_img_size=cfg.infill.max_img_size, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = np.stack(vio.load_video_frames_from_path(out)[0])
            if first is None:
                first = got
            else:
                same = same and np.array_equal(got, first)
            split = {}
            for name, s, _ in stages:
                split[name] = split.get(name, 0.0) + s
            print(f"[ab] {side}{'' if timed else ' (warm-up)'}: {secs:.3f} s; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
                  flush=True)
            if timed:
                times[side].append(secs)
                stages_of[side].append(split)

        run("package", False)
        run("variant", False)
        order = []
        for i in range(args.pairs):
            order += ["package", "variant"] if i % 2 == 0 \
                else ["variant", "package"]
        for side in order:
            run(side, True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def summary(xs):
        return {"runs": xs, "mean": sum(xs) / len(xs), "min": min(xs),
                "max": max(xs), "spread": max(xs) - min(xs)}
    report = {"card": card_line(), "frames": [T, H, W],
              "variant": os.path.relpath(os.path.abspath(args.variant), ROOT),
              "order": order,
              **{k: summary(v) for k, v in times.items()},
              "stages": stages_of,
              "variant_minus_package_s":
                  sum(times["variant"]) / len(times["variant"])
                  - sum(times["package"]) / len(times["package"]),
              "files_bitwise_equal": same}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in report if k != "stages"}),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
