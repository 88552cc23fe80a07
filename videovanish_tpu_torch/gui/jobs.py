"""The four jobs of the interactive app, without Qt.

The JAX package defines them inline in its window
(videovanish_tpu/gui/main_window.py:278-375); here they are functions, so
that the Qt window, scripts and tests run the same code. Each factory
returns `job(report, is_canceled)`, the callable the window's worker runs
on its own thread: `report(pct, status)` receives the pipeline's progress,
and the job checks `is_canceled()` where the JAX package's job does,
returning None, and writing no file, once it is set.

- `generate_mask_job`: SAM2 over the whole color video; writes
  `<color>_sam2_mask.mkv` and returns its path.
- `make_vanish_job`: inpainting over the whole file; writes
  `<color>_vanished.mkv` and returns its path.
- `preview_mask_job`: the cursor's frame alone, with its keyframe remapped
  to frame 0 (`AnnotationStore.annotations_dict(only_frame,
  remap_to_zero=True)`); returns its colored mask as a list of one frame.
- `preview_infill_job`: INFILL_PREVIEW_FRAMES frames from the cursor (fewer
  at the end of the file) at the preview resolution
  (`run_infill_on_frames(..., preview=True)`); returns the frames.

`device` is where the pipelines run: "cuda" unless the caller asks for
"cpu". A job asked for the card raises without one; it never falls back to
the CPU.
"""
from __future__ import annotations

INFILL_PREVIEW_FRAMES = 22  # reference videovanish.py:1572


def _device(device) -> str:
    import torch
    device = str(device)
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; ask for device='cpu' to run on "
                           "the CPU")
    return device


def generate_mask_job(color_path: str, annotations: dict, device="cuda"):
    """SAM2 over every frame of `color_path` with `annotations` (the
    pipeline's dict, `AnnotationStore.annotations_dict()`)."""
    out_path = color_path + "_sam2_mask.mkv"

    def job(report, is_canceled):
        dev = _device(device)
        from videovanish_tpu_torch.pipeline.masker import run_sam2_on_frames
        from videovanish_tpu_torch.video import (
            load_video_frames_from_path, write_video_frames_to_path,
        )
        frames, fps = load_video_frames_from_path(color_path)
        if is_canceled():
            return None
        masks = run_sam2_on_frames(frames, annotations, device=dev,
                                   prog=report)
        if is_canceled():
            return None
        H0, W0 = frames[0].shape[:2]
        write_video_frames_to_path(out_path, masks, fps, H0, W0)
        return out_path
    return job


def make_vanish_job(color_path: str, mask_path: str, max_img_size: int = 960,
                    mask_dilation_iter: int = 8,
                    keep_unmasked_original: bool = True, device="cuda"):
    """run_infill_on_frames over every frame of `color_path` under the
    masks of `mask_path`, with the dock's settings."""
    out_path = color_path + "_vanished.mkv"

    def job(report, is_canceled):
        dev = _device(device)
        from videovanish_tpu_torch.pipeline.infill import run_infill_on_frames
        from videovanish_tpu_torch.video import (
            load_video_frames_from_path, write_video_frames_to_path,
        )
        frames, fps = load_video_frames_from_path(color_path)
        if is_canceled():
            return None
        masks, _ = load_video_frames_from_path(mask_path)
        if is_canceled():
            return None
        out = run_infill_on_frames(
            frames, masks, mask_dilation_iter=mask_dilation_iter,
            max_img_size=max_img_size,
            keep_unmasked_original=keep_unmasked_original, prog=report,
            device=dev)
        H0, W0 = frames[0].shape[:2]
        write_video_frames_to_path(out_path, out, fps, H0, W0)
        return out_path
    return job


def preview_mask_job(color_path: str, frame: int, annotations: dict,
                     device="cuda"):
    """SAM2 on frame `frame` alone; `annotations` hold that frame's
    keyframe remapped to 0."""

    def job(report, is_canceled):
        dev = _device(device)
        from videovanish_tpu_torch.pipeline.masker import run_sam2_on_frames
        from videovanish_tpu_torch.video import load_video_frames_from_path
        frames, _ = load_video_frames_from_path(color_path, frame, 1)
        return run_sam2_on_frames(frames, annotations, device=dev,
                                  prog=report)
    return job


def preview_infill_job(color_path: str, mask_path: str, frame: int,
                       max_img_size: int = 960, mask_dilation_iter: int = 8,
                       keep_unmasked_original: bool = True, device="cuda"):
    """run_infill_on_frames(..., preview=True) on INFILL_PREVIEW_FRAMES
    frames from `frame`."""

    def job(report, is_canceled):
        dev = _device(device)
        from videovanish_tpu_torch.pipeline.infill import run_infill_on_frames
        from videovanish_tpu_torch.video import load_video_frames_from_path
        frames, _ = load_video_frames_from_path(color_path, frame,
                                                INFILL_PREVIEW_FRAMES)
        masks, _ = load_video_frames_from_path(mask_path, frame,
                                               INFILL_PREVIEW_FRAMES)
        return run_infill_on_frames(
            frames, masks, mask_dilation_iter=mask_dilation_iter,
            max_img_size=max_img_size,
            keep_unmasked_original=keep_unmasked_original, prog=report,
            preview=True, device=dev)
    return job
