"""CLI: PSNR / SSIM between two videos, one JSON line (port of
videovanish_tpu/cli/compare.py). The metrics run on the card
(`utils/quality.py`), or on the CPU under VV_PLATFORM=cpu.

    python -m videovanish_tpu_torch.cli.compare --a ours.mkv --b reference.mkv
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from videovanish_tpu_torch.cli import device_from_env
from videovanish_tpu_torch.utils.quality import video_metrics
from videovanish_tpu_torch.video import load_video_frames_from_path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="PSNR/SSIM between two videos (quality parity gate).")
    ap.add_argument("--a", required=True, type=str, help="First video.")
    ap.add_argument("--b", required=True, type=str,
                    help="Second (reference) video.")
    ap.add_argument("--start_frame", type=int, default=0,
                    help="Index of first frame to compare (default: 0).")
    ap.add_argument("--max_frames", type=int, default=-1,
                    help="Max number of frames to compare.")
    ap.add_argument("--min_psnr", type=float, default=None,
                    help="Exit nonzero if mean PSNR falls below this.")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_from_env()
    assert os.path.isfile(args.a), f"missing video: {args.a}"
    assert os.path.isfile(args.b), f"missing video: {args.b}"

    fa, _ = load_video_frames_from_path(args.a, args.start_frame,
                                        args.max_frames)
    fb, _ = load_video_frames_from_path(args.b, args.start_frame,
                                        args.max_frames)
    n = min(len(fa), len(fb))
    if len(fa) != len(fb):
        print(f"[compare] frame count differs ({len(fa)} vs {len(fb)}); "
              f"comparing first {n}", file=sys.stderr)

    def on_device(frames):
        return [torch.from_numpy(f).to(device) for f in frames[:n]]

    m = video_metrics(on_device(fa), on_device(fb))
    print(json.dumps({"a": args.a, "b": args.b, **m}))
    if args.min_psnr is not None and m["psnr"] < args.min_psnr:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
