"""Binary mask dilation (port of videovanish_tpu/ops/morphology.py).

The reference dilates with `scipy.ndimage.binary_dilation(m, iterations=k)`
and its default 4-connected cross; this is that cross iterated with shifts,
batched over frames, on the tensor's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_dilation(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Iterated 4-connected dilation of a (..., H, W) mask (nonzero =
    foreground); returns bool, equal to scipy's binary_dilation."""
    m = mask > 0 if mask.dtype != torch.bool else mask
    for _ in range(max(0, iterations)):
        p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
        m = (m | p[..., :-2, 1:-1] | p[..., 2:, 1:-1]
             | p[..., 1:-1, :-2] | p[..., 1:-1, 2:])
    return m


def binarize_and_dilate(mask_rgb: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Any channel > 0, then dilate. (..., H, W, 3) uint8 -> (..., H, W)
    uint8 in {0, 255}."""
    m = binary_dilation((mask_rgb > 0).any(dim=-1), iterations)
    return m.to(torch.uint8) * 255
