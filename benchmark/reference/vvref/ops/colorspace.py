"""YUV 4:2:0 (I420) frames for the SAM2 encoder's input.

Port of videovanish_tpu/ops/colorspace.py. During propagation the SAM2
predictor hands its frames to the encoder as I420 (video-range BT.601: Y in
[16, 235], U/V centred at 128), half the bytes of RGB uint8, and the
encoder converts them back to RGB in [0, 1] on the card.

`rgb_to_yuv420_host` reproduces OpenCV's `cvtColor(COLOR_RGB2YUV_I420)`
byte for byte without cv2 (the card's machine has none): OpenCV's 20-bit
fixed-point coefficients, round half up, and the chroma of each 2x2 block
taken from its top-left pixel.
"""
from __future__ import annotations

import numpy as np
import torch

# OpenCV's ITU-R BT.601 fixed-point coefficients (shift 20)
_SHIFT = 20
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def rgb_to_yuv420_host(frames: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) RGB uint8 -> (N, H*3//2, W) I420 uint8, equal to
    cv2.cvtColor(frame, cv2.COLOR_RGB2YUV_I420) per frame. H and W even."""
    N, H, W = frames.shape[:3]
    if H % 2 or W % 2:
        raise ValueError(f"I420 needs even dimensions, got {H}x{W}")
    f = np.asarray(frames).astype(np.int32)  # sums stay below 2**31
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    half = 1 << (_SHIFT - 1)
    y = (_CRY * r + _CGY * g + _CBY * b + half + (16 << _SHIFT)) >> _SHIFT
    r0, g0, b0 = r[:, 0::2, 0::2], g[:, 0::2, 0::2], b[:, 0::2, 0::2]
    u = (_CRU * r0 + _CGU * g0 + _CBU * b0 + half + (128 << _SHIFT)) >> _SHIFT
    v = (_CBU * r0 + _CGV * g0 + _CBV * b0 + half + (128 << _SHIFT)) >> _SHIFT
    out = np.empty((N, H * W * 3 // 2), np.uint8)
    q = H * W // 4
    out[:, :H * W] = np.clip(y, 0, 255).reshape(N, -1)
    out[:, H * W:H * W + q] = np.clip(u, 0, 255).reshape(N, -1)
    out[:, H * W + q:] = np.clip(v, 0, 255).reshape(N, -1)
    return out.reshape(N, H * 3 // 2, W)


def yuv420_to_rgb01(yuv_u8: torch.Tensor) -> torch.Tensor:
    """(N, h*3//2, w) I420 uint8 -> (N, h, w, 3) f32 RGB in [0, 1], on the
    tensor's device: the video-range BT.601 inverse with chroma upsampled
    nearest (h a multiple of 4)."""
    n, rows, w = yuv_u8.shape
    h = rows * 2 // 3
    y = yuv_u8[:, :h, :].float()
    u = yuv_u8[:, h:h + h // 4, :].reshape(n, h // 2, w // 2).float() - 128.0
    v = yuv_u8[:, h + h // 4:, :].reshape(n, h // 2, w // 2).float() - 128.0
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yf = (y - 16.0) * 1.16438
    r = yf + 1.59603 * v
    g = yf - 0.39176 * u - 0.81297 * v
    b = yf + 2.01723 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0) / 255.0
