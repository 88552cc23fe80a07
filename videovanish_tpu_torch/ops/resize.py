"""Resizes with OpenCV semantics, on the tensor's own device.

Port of videovanish_tpu/ops/resize.py:
  - nearest: src = floor(dst * in / out) (cv2 INTER_NEAREST);
  - bilinear: half-pixel centres, taps clamped at the border (cv2
    INTER_LINEAR).
The JAX package resizes its uploads on the host with cv2; the machine with
the card has no cv2, so the port's `host_resize_*` run these gathers on
whatever device the frames lie on. The uint8 bilinear result is within 1 of
cv2's (cv2 rounds fixed-point weights).

The ProPainter modules' channel-first resizes (torch's own bilinear
semantics, align_corners True and False) are `F.interpolate` in f32.
`resize_bicubic_torch` is torch's bicubic (a = -0.75, half-pixel centres,
edge-clamped taps) on channel-last input, as Hiera's position embedding
takes it. SAM2's frame and mask resizes are `resize_bilinear` (cv2
INTER_LINEAR), as the JAX predictor's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def resize_bicubic_torch(img: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Bicubic resize of channel-last (..., H, W, C) through
    F.interpolate(mode="bicubic", align_corners=False): half-pixel centres,
    a = -0.75, taps clamped at the edges. Returns f32."""
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    x = img.float().reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bicubic",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, C)


def host_resize_bilinear_u8(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """INTER_LINEAR resize of (T, H, W, 3) uint8 frames, on their device."""
    out = resize_bilinear(frames, h, w)
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def host_resize_nearest_2d(masks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """INTER_NEAREST resize of (T, H, W) masks, on their device."""
    return resize_nearest_2d(masks, h, w)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """torch bilinear resize with align_corners=True of (N, C, H, W) (the
    ProPainter decoders' 2x upsample), computed in f32, dtype kept."""
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=True)
    return y.to(x.dtype)


def resize_bilinear_torch_half_pixel(x: torch.Tensor, out_h: int,
                                     out_w: int) -> torch.Tensor:
    """torch bilinear resize with half-pixel centres (align_corners=False,
    edges clamped) of (N, C, H, W), computed in f32, dtype kept."""
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    return y.to(x.dtype)
