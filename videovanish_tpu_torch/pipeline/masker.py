"""run_sam2_on_frames: interactive masks and their propagation, PyTorch.

Port of videovanish_tpu/pipeline/masker.py with the same signature,
annotation schema, coordinate rules and colored-mask rendering:
normalized [0..1] or absolute pixel coordinates (a value in [0, 1] is
always read as normalized), clicks batched per (frame, object), rects as
xywh -> xyxy, masks thresholded at logit 0, one HSV color per object with
higher ids painted over lower. `device` (None means "cuda") picks where
the predictor runs; the CPU only when asked for. With VV_PROFILE_DIR set,
each call leaves a torch.profiler trace there (`utils/observability`),
the colouring on the host named `masker.render`.
"""
from __future__ import annotations

import numpy as np

from videovanish_tpu_torch.checkpoint import checkpoint_present
from videovanish_tpu_torch.pipeline.colors import render_colored_masks
from videovanish_tpu_torch.utils.observability import (
    maybe_profile, stage_timer,
)

predictor = None  # built at first use, like the reference's global
_predictor_key = None


def _null_prog(*_a, **_k):
    return None


def _get_predictor(device=None):
    """The module's predictor for the installed config (pipeline.infill's)
    on `device`, built on first use and again when either changes, with
    the weights of the config's checkpoint file (seeded random when it
    does not exist)."""
    global predictor, _predictor_key
    from videovanish_tpu_torch.models.sam2 import build_sam2_video_predictor
    from videovanish_tpu_torch.pipeline.infill import _get_config
    cfg = _get_config().sam2
    key = (cfg, str(device or "cuda"))
    if predictor is None or key != _predictor_key:
        predictor = None  # the old predictor's memory goes first
        predictor = build_sam2_video_predictor(
            config=cfg, device=device or "cuda",
            ckpt_path=cfg.checkpoint if checkpoint_present(cfg.checkpoint)
            else None)
        _predictor_key = key
    return predictor


def reset_predictor() -> None:
    global predictor, _predictor_key
    predictor, _predictor_key = None, None


def run_sam2_on_frames(frames_rgb, annotations, device=None, prog=None):
    """Segment the annotated objects and propagate them through the video.

    frames_rgb: list of (H, W, 3) RGB uint8 frames.
    annotations: {"keyframes": [{"frame_idx", "pos_clicks": [{x, y, obj}],
                  "neg_clicks": [...], "rects": [{x, y, w, h, obj}]}]}
    Returns a list of (H, W, 3) uint8 colored-mask frames (black
    background)."""
    prog = prog or _null_prog
    assert isinstance(frames_rgb, (list, tuple)) and len(frames_rgb) > 0, \
        "frames must be a non-empty list"
    H0, W0 = frames_rgb[0].shape[:2]

    with maybe_profile():
        prog(1, "Setting up sam2")
        pred = _get_predictor(device)

        prog(25, "Loading frames in to sam2")
        state = pred.init_state(video_path=frames_rgb)

        def _to_px_x(x):
            return float(x) * W0 if 0.0 <= x <= 1.0 else float(x)

        def _to_px_y(y):
            return float(y) * H0 if 0.0 <= y <= 1.0 else float(y)

        def denorm_point(x, y):
            return np.array([_to_px_x(x), _to_px_y(y)], dtype=np.float32)

        def denorm_rect(x, y, w, h):
            x1, y1 = _to_px_x(x), _to_px_y(y)
            x2 = _to_px_x(x + w) if 0.0 <= w <= 1.0 else (x1 + float(w))
            y2 = _to_px_y(y + h) if 0.0 <= h <= 1.0 else (y1 + float(h))
            return np.array([min(x1, x2), min(y1, y2), max(x1, x2),
                             max(y1, y2)], dtype=np.float32)

        keyframes = sorted(annotations.get("keyframes", []),
                           key=lambda k: int(k["frame_idx"]))
        for kf in keyframes:
            frame_idx = int(kf["frame_idx"])
            clicks_by_obj: dict[int, dict] = {}

            def _add_click(obj_id, x, y, label):
                d = clicks_by_obj.setdefault(int(obj_id),
                                             {"pts": [], "labels": []})
                d["pts"].append(denorm_point(x, y))
                d["labels"].append(label)

            for c in kf.get("pos_clicks", []):
                _add_click(c.get("obj", 1), c["x"], c["y"], 1)
            for c in kf.get("neg_clicks", []):
                _add_click(c.get("obj", 1), c["x"], c["y"], 0)

            for obj_id, d in clicks_by_obj.items():
                pred.add_new_points_or_box(
                    inference_state=state, frame_idx=frame_idx,
                    obj_id=int(obj_id),
                    points=np.vstack(d["pts"]).astype(np.float32),
                    labels=np.array(d["labels"], dtype=np.int32))
            for r in kf.get("rects", []):
                pred.add_new_points_or_box(
                    inference_state=state, frame_idx=frame_idx,
                    obj_id=int(r.get("obj", 1)),
                    box=denorm_rect(r["x"], r["y"], r["w"], r["h"]))

        prog(45, "Infering masks with sam2")
        video_segments = {}
        # binary masks taken on the device (logit > 0, the reference's
        # threshold)
        for out_frame_idx, out_obj_ids, out_masks in \
                pred.propagate_in_video(state, yield_binary=True):
            video_segments[out_frame_idx] = {
                int(obj_id): np.asarray(out_masks[i] > 0)
                for i, obj_id in enumerate(out_obj_ids)}

        prog(80, "Creating color mask from sam2 data")
        with stage_timer("masker.render", frames=len(frames_rgb)):
            return [render_colored_masks(video_segments.get(idx, {}), H0, W0)
                    for idx in range(len(frames_rgb))]
