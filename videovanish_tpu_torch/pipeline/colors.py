"""Per-object mask colors.

A copy of videovanish_tpu/pipeline/colors.py (the port imports nothing of
the JAX package). Reproduces the reference's HSV-cycling color map exactly
(sam2_masker.py:27-37): h=(obj_id*37)%180, s=200, v=255 in OpenCV's
uint8 HSV space, converted to a (B,G,R) tuple. The reference paints that
BGR tuple into RGB-ordered in-memory frames (SURVEY.md §2b#5) — output
files must match byte-for-byte, so we keep the identical tuple order.
Implemented in pure numpy (OpenCV HSV2BGR math) so the color map works
on hosts without cv2.
"""
from __future__ import annotations

import numpy as np


def _hsv_to_bgr_u8(h: int, s: int, v: int) -> tuple[int, int, int]:
    """OpenCV cvtColor(HSV2BGR) for uint8 pixels: H in [0,180), S,V in [0,255]."""
    hf = h * 2.0  # degrees
    sf = s / 255.0
    vf = v / 255.0
    c = vf * sf
    x = c * (1.0 - abs((hf / 60.0) % 2.0 - 1.0))
    m = vf - c
    sector = int(hf // 60.0) % 6
    rgb = [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x)][sector]
    r, g, b = (int(round((u + m) * 255.0)) for u in rgb)
    return (b, g, r)


def color_for_obj(obj_id: int) -> tuple[int, int, int]:
    """Deterministic bright color for obj_id; (B,G,R) like the reference."""
    h = int((obj_id * 37) % 180)
    return _hsv_to_bgr_u8(h, 200, 255)


def render_colored_masks(masks_by_obj: dict[int, np.ndarray],
                         H0: int, W0: int) -> np.ndarray:
    """Render per-object boolean masks into a colored frame: black
    background, higher obj_id overwrites lower (sam2_masker.py:151-175).

    masks_by_obj: {obj_id: (H, W) bool}; returns (H0, W0, 3) uint8.
    """
    out = np.zeros((H0, W0, 3), dtype=np.uint8)
    for obj_id in sorted(masks_by_obj.keys()):
        m = masks_by_obj[obj_id]
        if m is None or m.size == 0:
            continue
        m = np.asarray(m)
        if m.ndim > 2:
            m = m.squeeze()
        if m.shape != (H0, W0):
            # nearest-neighbor resize without cv2 (matches INTER_NEAREST)
            ys = np.clip((np.arange(H0) * (m.shape[0] / H0)).astype(int), 0,
                         m.shape[0] - 1)
            xs = np.clip((np.arange(W0) * (m.shape[1] / W0)).astype(int), 0,
                         m.shape[1] - 1)
            m = m[ys[:, None], xs[None, :]]
        out[m.astype(bool)] = color_for_obj(int(obj_id))
    return out
