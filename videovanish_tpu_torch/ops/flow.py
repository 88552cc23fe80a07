"""Backward warps by optical flow (port of videovanish_tpu/ops/flow.py).

output(p) = img(p + flow(p)) with zeros outside the image; images are
(B, C, H, W) and flows (B, 2, H, W) as (dx, dy) in pixels. Sample
coordinates are absolute f32 pixel positions, floored (bilinear) or
rounded half to even (nearest) and gathered by index, as the JAX functions
compute them: grid_sample's [-1, 1] normalisation moves a coordinate by
about an ulp, which flips nearest rounding at .5.
"""
from __future__ import annotations

import torch


def _coords(flow: torch.Tensor):
    """Absolute sample coordinates (sx, sy), each (B, H, W) f32."""
    _, _, H, W = flow.shape
    gx = torch.arange(W, device=flow.device, dtype=torch.float32)
    gy = torch.arange(H, device=flow.device, dtype=torch.float32)
    sx = gx.view(1, 1, W) + flow[:, 0].float()
    sy = gy.view(1, H, 1) + flow[:, 1].float()
    return sx, sy


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """img (B, C, H, W) at the integer-valued coordinates (yi, xi) (B, H, W),
    zero where they fall outside."""
    B, C, H, W = img.shape
    inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
    vals = torch.gather(img.reshape(B, C, H * W), 2,
                        idx.view(B, 1, -1).expand(B, C, -1))
    return torch.where(inb.view(B, 1, -1), vals, 0).view(B, C, H, W)


def _bilinear(img, sx, sy):
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]
    out = ((1 - wy) * (1 - wx)) * _gather(img, y0, x0) \
        + ((1 - wy) * wx) * _gather(img, y0, x0 + 1) \
        + (wy * (1 - wx)) * _gather(img, y0 + 1, x0) \
        + (wy * wx) * _gather(img, y0 + 1, x0 + 1)
    return out.to(img.dtype)


def _nearest(img, sx, sy):
    return _gather(img, torch.round(sy), torch.round(sx))


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img by flow, bilinear, zeros outside; dtype kept."""
    sx, sy = _coords(flow)
    return _bilinear(img, sx, sy)


def flow_warp_mode(img: torch.Tensor, flow: torch.Tensor,
                   mode: str = "bilinear") -> torch.Tensor:
    """Backward warp with "bilinear" or "nearest" interpolation (torch
    grid_sample's semantics with align_corners=True and zero padding, on a
    pixel grid plus flow: ProPainter's flow_warp)."""
    if mode == "bilinear":
        return flow_warp(img, flow)
    sx, sy = _coords(flow)
    return _nearest(img, sx, sy)


def prop_warp(feat, mask, chk, flow, feat_mode: str = "nearest"):
    """The image-propagation step's three backward warps at one set of
    coordinates: feat by `feat_mode`, mask and chk (the consistency check's
    flow) bilinear. Returns (feat_warp, mask_warp, chk_warp), dtypes kept."""
    sx, sy = _coords(flow)
    feat_warp = _nearest(feat, sx, sy) if feat_mode == "nearest" \
        else _bilinear(feat, sx, sy)
    return feat_warp, _bilinear(mask, sx, sy), _bilinear(chk, sx, sy)
