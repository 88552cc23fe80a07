"""The masking request on the reference: the port's
`pipeline.masker.run_sam2_on_frames` (annotation schema, coordinate rules,
clicks batched per frame and object, masks at logit 0, one colour per
object), copied with the predictor passed in: the reference's f32
predictor, or the control's."""
from __future__ import annotations

import numpy as np

from benchmark.reference.vvref.pipeline.colors import render_colored_masks


def run_sam2_on_frames(pred, frames_rgb, annotations):
    """Segment the annotated objects and propagate them through the video.

    frames_rgb: list of (H, W, 3) RGB uint8 frames.
    annotations: {"keyframes": [{"frame_idx", "pos_clicks": [{x, y, obj}],
                  "neg_clicks": [...], "rects": [{x, y, w, h, obj}]}]}
    Returns a list of (H, W, 3) uint8 colored-mask frames (black
    background)."""
    H0, W0 = frames_rgb[0].shape[:2]
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
        return np.array([min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)],
                        dtype=np.float32)

    keyframes = sorted(annotations.get("keyframes", []),
                       key=lambda k: int(k["frame_idx"]))
    for kf in keyframes:
        frame_idx = int(kf["frame_idx"])
        clicks_by_obj: dict[int, dict] = {}

        def _add_click(obj_id, x, y, label):
            d = clicks_by_obj.setdefault(int(obj_id), {"pts": [], "labels": []})
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

    video_segments = {}
    # binary masks taken on the device (logit > 0, the reference's threshold)
    for out_frame_idx, out_obj_ids, out_masks in \
            pred.propagate_in_video(state, yield_binary=True):
        video_segments[out_frame_idx] = {
            int(obj_id): np.asarray(out_masks[i] > 0)
            for i, obj_id in enumerate(out_obj_ids)}

    return [render_colored_masks(video_segments.get(idx, {}), H0, W0)
            for idx in range(len(frames_rgb))]
