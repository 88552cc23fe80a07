"""CLI: remove masked objects from a video (flow prior + diffusion
inpainting); port of videovanish_tpu/cli/diffuerase.py, flag for flag,
with the default output name `<input>_vanished.mkv`. The prior video is
loaded only when one is given. Long videos (more than twice the chunk
length, or --chunked on) stream through the chunked pipeline when no prior
video is given.

    python -m videovanish_tpu_torch.cli.diffuerase --color_video in.mkv \\
        --mask_video mask.mkv

On N cards, one process per card:

    torchrun --nproc_per_node=N -m videovanish_tpu_torch.cli.diffuerase ...

Every rank computes (the frames shard over the mesh of
`pipeline/infill.py`) and rank 0 alone writes the output.

`--model vace` (the port's one flag beyond the JAX CLI's) removes with
Wan2.1-VACE in place of the ProPainter prior and DiffuEraser: one pass on
one card, so it refuses --chunked on, a prior video and a mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from videovanish_tpu_torch.cli import device_from_env
from videovanish_tpu_torch.core.mesh import (
    barrier, initialize_distributed, is_writer,
)
from videovanish_tpu_torch.pipeline import infill
from videovanish_tpu_torch.video import (
    load_video_frames_from_path, probe_video, write_video_frames_to_path,
)

# the removers of `--model`, the default first
MODELS = ("diffueraser", "vace")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Remove masked objects from a video "
                    "(flow prior + diffusion inpainting).")
    ap.add_argument("--color_video", required=True, type=str,
                    help="Input color video path.")
    ap.add_argument("--mask_video", required=True, type=str,
                    help="Input mask video path.")
    ap.add_argument("--prior_video", required=False, type=str,
                    help="Input prior video path.")
    ap.add_argument("--start_frame", type=int, default=0,
                    help="Index of first frame to process (default: 0).")
    ap.add_argument("--max_frames", type=int, default=-1,
                    help="Max number of frames to process after start_frame.")
    ap.add_argument("--out", type=str, default=None,
                    help="Output video path (default: <input>_vanished.mkv)")
    ap.add_argument("--max_img_size", type=int, default=960,
                    help="Inference resolution, long side (default: 960).")
    ap.add_argument("--mask_dilation_iter", type=int, default=8,
                    help="Mask dilation iterations (default: 8).")
    ap.add_argument("--chunked", choices=["auto", "on", "off"], default="auto",
                    help="Stream long videos through overlapped chunks with "
                         "resume support (auto: on for long videos when no "
                         "prior video is given).")
    ap.add_argument("--model", choices=list(MODELS), default=MODELS[0],
                    help="Remover: diffueraser (ProPainter prior + "
                         "DiffuEraser) or vace (Wan2.1-VACE; one pass on "
                         "one card).")
    return ap


def _use_model(model: str) -> None:
    """Install the config with `infill.model` set, where it differs."""
    cfg = infill._get_config()
    if cfg.infill.model != model:
        infill.set_config(dataclasses.replace(
            cfg, infill=dataclasses.replace(cfg.infill, model=model)))


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = device_from_env()
    initialize_distributed(device_type=device)
    assert os.path.isfile(args.color_video), "input video missing"
    out_video = args.out or (args.color_video + "_vanished.mkv")
    _use_model(args.model)
    if args.model == "vace" and args.chunked == "on":
        raise SystemExit("--model vace runs a clip in one pass: "
                         "--chunked on is DiffuEraser's")

    if args.chunked != "off" and args.prior_video is None \
            and args.model != "vace":
        from videovanish_tpu_torch.pipeline.chunking import (
            vanish_video_chunked,
        )
        n, _, _, _ = probe_video(args.color_video)
        if args.max_frames > 0:
            n = min(n, args.max_frames)
        chunk = infill._get_config().chunking.chunk_frames
        if args.chunked == "on" or n > 2 * chunk:
            vanish_video_chunked(
                args.color_video, args.mask_video, out_video,
                start_frame=args.start_frame, max_frames=args.max_frames,
                mask_dilation_iter=args.mask_dilation_iter,
                max_img_size=args.max_img_size, device=device)
            return

    frames, fps = load_video_frames_from_path(
        args.color_video, args.start_frame, args.max_frames)
    H0, W0 = frames[0].shape[:2]
    mask_frames, _ = load_video_frames_from_path(
        args.mask_video, args.start_frame, args.max_frames)
    Hm, Wm = mask_frames[0].shape[:2]

    prior_frames = None
    if args.prior_video is not None:
        prior_frames, _ = load_video_frames_from_path(
            args.prior_video, args.start_frame, args.max_frames)
        Hp, Wp = prior_frames[0].shape[:2]
        assert (H0 == Hp and W0 == Wp), \
            "prior and color video are diffrent sizes"
    assert (H0 == Hm and W0 == Wm), "mask and color video are diffrent sizes"

    out_frames = infill.run_infill_on_frames(
        frames, mask_frames, mask_dilation_iter=args.mask_dilation_iter,
        propainer_frames=prior_frames, max_img_size=args.max_img_size,
        device=device)
    if is_writer():
        write_video_frames_to_path(out_video, out_frames, fps, H0, W0)
    barrier()


if __name__ == "__main__":
    main()
