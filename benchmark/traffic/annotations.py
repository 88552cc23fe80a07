"""SAM2 annotations for a clip of `traffic/clip.py`, in the shape of
chip_smoke's `sam2_annotations`: object 1 gets a positive click on its
centre in the first frame and a negative click on the background in
frame `negative_frame`; every further object gets its box in the first
frame. Clicks are normalized, boxes in pixels.

Parameters (a workload's "traffic" object): those of `clip.py`, and
  negative_frame          the frame of object 1's negative click
"""
from __future__ import annotations


def make_annotations(params: dict, boxes: list) -> dict:
    H, W = params["height"], params["width"]
    y0, x0, h, w = boxes[0][0]
    first = {"frame_idx": 0,
             "pos_clicks": [{"x": (x0 + w / 2) / W, "y": (y0 + h / 2) / H,
                             "obj": 1}],
             "rects": [{"x": b[0][1], "y": b[0][0], "w": b[0][3],
                        "h": b[0][2], "obj": i + 2}
                       for i, b in enumerate(boxes[1:])]}
    neg_t = params["negative_frame"]
    # the background: the corner farthest from object 1 in that frame
    y, x, h, w = boxes[0][neg_t]
    nx = 0.05 if x + w / 2 > W / 2 else 0.95
    ny = 0.05 if y + h / 2 > H / 2 else 0.95
    return {"keyframes": [
        first,
        {"frame_idx": neg_t, "neg_clicks": [{"x": nx, "y": ny, "obj": 1}]},
    ]}
