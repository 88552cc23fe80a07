"""Resizes with OpenCV semantics, on the tensor's own device.

Port of videovanish_tpu/ops/resize.py:
  - nearest: src = floor(dst * in / out) (cv2 INTER_NEAREST);
  - bilinear: half-pixel centres, taps clamped at the border (cv2
    INTER_LINEAR).
The JAX package resizes its uploads on the host with cv2; the machine with
the card has no cv2, so the port's `host_resize_*` run these gathers on
whatever device the frames lie on. The uint8 bilinear result is within 1 of
cv2's (cv2 rounds fixed-point weights).
"""
from __future__ import annotations

import torch


def plan_long_side(H: int, W: int, max_long_side: int, multiple_of: int = 8):
    """(out_h, out_w) capping the long side at `max_long_side`, each
    rounded to a multiple of `multiple_of`."""
    scale = min(1.0, max_long_side / max(H, W))
    out_h = max(multiple_of, int(round(H * scale / multiple_of)) * multiple_of)
    out_w = max(multiple_of, int(round(W * scale / multiple_of)) * multiple_of)
    return out_h, out_w


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    idx = torch.floor(torch.arange(n_out, device=device, dtype=torch.float64)
                      * (n_in / n_out)).long()
    return idx.clamp_(0, n_in - 1)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_NEAREST resize of (..., H, W, C)."""
    H, W = img.shape[-3], img.shape[-2]
    ys = _nearest_index(H, out_h, img.device)
    xs = _nearest_index(W, out_w, img.device)
    return img.index_select(-3, ys).index_select(-2, xs)


def resize_nearest_2d(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_NEAREST resize of a channel-less (..., H, W) map."""
    return resize_nearest(img[..., None], out_h, out_w)[..., 0]


def _linear_taps(n_in: int, n_out: int, device):
    f = (torch.arange(n_out, device=device, dtype=torch.float64) + 0.5) \
        * (n_in / n_out) - 0.5
    f0 = torch.floor(f)
    w = (f - f0).float()
    if n_in > 1:
        # cv2 border handling: clamp the tap pair and zero the fractional
        # weight when the source coordinate falls outside the image
        w = torch.where(f0 < 0, torch.zeros_like(w),
                        torch.where(f0 > n_in - 2, torch.ones_like(w), w))
    else:
        w = torch.zeros_like(w)
    i0 = f0.long().clamp(0, max(n_in - 2, 0))
    i1 = (i0 + 1).clamp(0, n_in - 1)
    return i0, i1, w


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_LINEAR resize of (..., H, W, C); returns f32."""
    H, W = img.shape[-3], img.shape[-2]
    x = img.float()
    y0, y1, wy = _linear_taps(H, out_h, img.device)
    x0, x1, wx = _linear_taps(W, out_w, img.device)
    wy = wy[:, None, None]
    top = x.index_select(-3, y0) * (1 - wy) + x.index_select(-3, y1) * wy
    wx = wx[:, None]
    return top.index_select(-2, x0) * (1 - wx) + top.index_select(-2, x1) * wx


def host_resize_bilinear_u8(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """INTER_LINEAR resize of (T, H, W, 3) uint8 frames, on their device."""
    out = resize_bilinear(frames, h, w)
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def host_resize_nearest_2d(masks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """INTER_NEAREST resize of (T, H, W) masks, on their device."""
    return resize_nearest_2d(masks, h, w)
