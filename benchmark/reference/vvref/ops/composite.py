"""Rescale and feathered composite (port of videovanish_tpu/ops/composite.py).

  alpha = clip(0.5 + (d_in - d_out) / (2 * feather_px), 0, 1)
  out   = clip(rint(alpha * inpainted + (1 - alpha) * original), 0, 255)

One batched pass over the frames on the tensors' device.
"""
from __future__ import annotations

import torch

from benchmark.reference.vvref.ops.edt import feather_alpha
from benchmark.reference.vvref.ops.resize import resize_bilinear, resize_nearest_2d


def feathered_composite(inpainted: torch.Tensor, original: torch.Tensor,
                        mask: torch.Tensor, feather_px: float = 3.0,
                        keep_unmasked_original: bool = True) -> torch.Tensor:
    """Composite inpainted frames over the originals with a feathered edge.

    inpainted: (T, Hi, Wi, 3) uint8/f32, any resolution
    original:  (T, H0, W0, 3) uint8
    mask:      (T, Hm, Wm) or (T, Hm, Wm, 3), nonzero = inpaint
    Returns (T, H0, W0, 3) uint8.
    """
    H0, W0 = original.shape[-3], original.shape[-2]
    if inpainted.shape[-3] != H0 or inpainted.shape[-2] != W0:
        inpainted = resize_bilinear(inpainted, H0, W0)
    inpainted = inpainted.float()
    if mask.dim() == original.dim():
        mask = (mask > 0).any(dim=-1)
    m = mask > 0
    if m.shape[-2] != H0 or m.shape[-1] != W0:
        m = resize_nearest_2d(m.to(torch.uint8), H0, W0) > 0
    if not keep_unmasked_original:
        return torch.round(inpainted).clamp(0, 255).to(torch.uint8)
    alpha = feather_alpha(m, feather_px)[..., None]
    out = alpha * inpainted + (1.0 - alpha) * original.float()
    return torch.round(out).clamp(0, 255).to(torch.uint8)
