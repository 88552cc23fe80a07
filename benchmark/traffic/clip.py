"""Synthetic clips: a smooth moving scene with rectangular objects that
move across it, and the objects' masks. A copy of chip_smoke's
`synthetic_request` (one object) widened to any number of objects, each
with its own size, colour and path, all drawn from the seed.

Parameters (a workload's "traffic" object):
  frames, height, width   the clip
  objects                 [{"area": share of the frame, "aspect": w / h,
                            "travel": share of the width crossed}, ...]
"""
from __future__ import annotations

import numpy as np


def object_boxes(params: dict, rng: np.random.Generator) -> list:
    """Per object, per frame (y0, x0, h, w) in pixels."""
    T, H, W = params["frames"], params["height"], params["width"]
    boxes = []
    for ob in params["objects"]:
        area = ob["area"] * H * W
        h = int(round(np.sqrt(area / ob["aspect"])))
        w = int(round(h * ob["aspect"]))
        # from 2 px: a coordinate in [0, 1] would read as normalized
        y0 = int(rng.integers(2, H - h))
        travel = int(ob["travel"] * W)
        x_start = int(rng.integers(2, max(3, W - w - travel)))
        boxes.append([(y0, x_start + travel * t // max(1, T - 1), h, w)
                      for t in range(T)])
    return boxes


def make_clip(params: dict, rng: np.random.Generator, device="cpu"):
    """(frames (T, H, W, 3) uint8, masks (T, H, W) uint8 in {0, 255},
    boxes) of one clip, numpy; the pixels are computed on `device`."""
    import torch
    T, H, W = params["frames"], params["height"], params["width"]
    phase = rng.uniform(0, 2 * np.pi, 3)
    boxes = object_boxes(params, rng)
    colors = rng.integers(0, 256, (len(boxes), 3))
    f32 = dict(dtype=torch.float32, device=device)
    # sin(a(x) + b(y, t)) as sin a cos b + cos a sin b
    a = torch.arange(W, **f32)[:, None] / torch.tensor([37.0, 48.0, 59.0],
                                                       **f32)
    b = (torch.arange(H, **f32)[None, :, None] / 53
         + torch.tensor(phase, **f32)
         + 0.1 * torch.arange(T, **f32)[:, None, None])
    frames = (127 + 100 * (torch.cos(b)[:, :, None] * torch.sin(a)
                           + torch.sin(b)[:, :, None] * torch.cos(a))
              ).to(torch.uint8).cpu().numpy()
    masks = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        for ob, color in zip(boxes, colors):
            y0, x0, h, w = ob[t]
            frames[t, y0:y0 + h, x0:x0 + w] = color
            masks[t, y0:y0 + h, x0:x0 + w] = 255
    return frames, masks, boxes
