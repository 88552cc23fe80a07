"""CLI: a colored mask video with SAM2 (one color per object, black
background); port of videovanish_tpu/cli/sam2_masker.py, flag for flag,
with the default output name `<input>_sam2_mask.mkv`.

    python -m videovanish_tpu_torch.cli.sam2_masker --color_video in.mkv \\
        --annotations keyframes.json
"""
from __future__ import annotations

import argparse
import json
import os

from videovanish_tpu_torch.cli import device_from_env
from videovanish_tpu_torch.pipeline.masker import run_sam2_on_frames
from videovanish_tpu_torch.video import (
    load_video_frames_from_path, write_video_frames_to_path,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Create colored mask video with SAM2 "
                    "(one color per object, black background).")
    ap.add_argument("--color_video", required=True, type=str,
                    help="Input color video path.")
    ap.add_argument("--annotations", required=True, type=str,
                    help="JSON annotation file.")
    ap.add_argument("--start_frame", type=int, default=0,
                    help="Index of first frame to process (default: 0).")
    ap.add_argument("--max_frames", type=int, default=-1,
                    help="Max number of frames to process after start_frame.")
    ap.add_argument("--out", type=str, default=None,
                    help="Output video path (default: <input>_sam2_mask.mkv)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = device_from_env()
    assert os.path.isfile(args.color_video), "input video missing"
    out_video = args.out or (args.color_video + "_sam2_mask.mkv")

    frames, fps = load_video_frames_from_path(
        args.color_video, args.start_frame, args.max_frames)
    H0, W0 = frames[0].shape[:2]
    with open(args.annotations, "r") as f:
        ann = json.load(f)

    mask_frames = run_sam2_on_frames(frames, ann, device=device)
    write_video_frames_to_path(out_video, mask_frames, fps, H0, W0)


if __name__ == "__main__":
    main()
