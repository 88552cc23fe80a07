"""Truncated chamfer distance and the feathered alpha (port of
videovanish_tpu/ops/edt.py).

The reference feathers with two `cv2.distanceTransform(., DIST_L2, 5)`
calls: a 5x5 chamfer with weights 1, 1.4 and 2.1969 (axial, diagonal,
knight moves). The same metric is reached here by min-plus relaxation over
that neighbourhood, truncated at the radius the feather can see: the alpha
saturates once either distance exceeds feather_px.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_A, _B, _C = 1.0, 1.4, 2.1969
_OFFSETS = (
    [(-1, 0, _A), (1, 0, _A), (0, -1, _A), (0, 1, _A)]
    + [(-1, -1, _B), (-1, 1, _B), (1, -1, _B), (1, 1, _B)]
    + [(dy, dx, _C) for dy in (-2, -1, 1, 2) for dx in (-2, -1, 1, 2)
       if abs(dy) != abs(dx)]
)
_INF = 1e9


def chamfer_distance(foreground: torch.Tensor, iterations: int = 4) -> torch.Tensor:
    """Chamfer (cv2 DIST_L2/5) distance of each foreground pixel of a
    (..., H, W) mask to the nearest background pixel, exact below
    2 * iterations px; f32, 0 on background."""
    fg = foreground > 0 if foreground.dtype != torch.bool else foreground
    d = torch.where(fg, torch.tensor(_INF, dtype=torch.float32, device=fg.device),
                    torch.tensor(0.0, dtype=torch.float32, device=fg.device))
    H, W = d.shape[-2], d.shape[-1]
    for _ in range(iterations):
        p = F.pad(d, (2, 2, 2, 2), value=_INF)
        best = d
        for dy, dx, w in _OFFSETS:
            # the neighbour at (y - dy, x - dx), as the JAX shift fills it
            shifted = p[..., 2 - dy:2 - dy + H, 2 - dx:2 - dx + W]
            best = torch.minimum(best, shifted + w)
        d = best
    return torch.clamp(d, max=_INF)


def feather_alpha(mask: torch.Tensor, feather_px: float = 3.0) -> torch.Tensor:
    """Feathered alpha of a (..., H, W) mask: 1 inside, 0 outside, a linear
    ramp of about 2 * feather_px across the edge. f32."""
    m = mask > 0
    if feather_px <= 0:
        return m.float()
    iters = max(2, int(-(-float(feather_px) // 2)) + 1)
    d_in = chamfer_distance(m, iterations=iters)
    d_out = chamfer_distance(~m, iterations=iters)
    alpha = 0.5 + (d_in - d_out) / (2.0 * float(feather_px))
    return alpha.clamp(0.0, 1.0)
