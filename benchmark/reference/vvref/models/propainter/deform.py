"""Modulated deformable convolution v2 and ProPainter's second-order
deformable alignment (port of videovanish_tpu/models/propainter/deform.py).

torchvision's layout: offsets ordered (group, tap, [dy, dx]), zeros
outside the image, stride 1. Plain PyTorch: the four bilinear corners of
every (group, tap, pixel) are gathered from a (B*G*H*W, C/G) row table,
weighted, modulated, and contracted over (group, tap, channel) in one
matmul, in f32 as in the JAX function whatever the activation type.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def modulated_deform_conv2d(x, offset, mask, weight, bias, padding: int = 1):
    """x (B, Cin, H, W); offset (B, G, K, 2, H, W) as (dy, dx); mask
    (B, G, K, H, W) in [0, 1]; weight (Cout, Cin, kh, kw); bias (Cout,).
    Returns (B, Cout, H, W) in x's dtype."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    G = mask.shape[1]
    cg = Cin // G
    f32 = torch.float32
    dev = x.device
    ks = torch.arange(K, device=dev)
    ky = (ks // kw - padding).to(f32).view(1, 1, K, 1, 1)
    kx = (ks % kw - padding).to(f32).view(1, 1, K, 1, 1)
    sy = torch.arange(H, device=dev, dtype=f32).view(1, 1, 1, H, 1) + ky \
        + offset[:, :, :, 0].float()
    sx = torch.arange(W, device=dev, dtype=f32).view(1, 1, 1, 1, W) + kx \
        + offset[:, :, :, 1].float()
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    # row (b, g, pixel) holds group g's cg channels of that pixel
    table = x.float().reshape(B, G, cg, H * W).transpose(2, 3) \
        .reshape(B * G * H * W, cg)
    base = (torch.arange(B * G, device=dev) * (H * W)).view(B, G, 1, 1, 1)

    def corner(yi, xi):
        inb = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        idx = base + yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        vals = table.index_select(0, idx.reshape(-1)).view(B, G, K, H, W, cg)
        return torch.where(inb, vals, 0.0)

    v = ((1 - wy) * (1 - wx)) * corner(y0, x0) \
        + ((1 - wy) * wx) * corner(y0, x0 + 1) \
        + (wy * (1 - wx)) * corner(y0 + 1, x0) \
        + (wy * wx) * corner(y0 + 1, x0 + 1)
    v = v * mask.float()[..., None]                       # (B, G, K, H, W, cg)
    v = v.permute(0, 3, 4, 1, 2, 5).reshape(B, H * W, G * K * cg)
    wmat = weight.float().view(Cout, G, cg, K).permute(1, 3, 2, 0) \
        .reshape(G * K * cg, Cout)
    out = torch.matmul(v, wmat) + bias.float()
    return out.view(B, H, W, Cout).permute(0, 3, 1, 2).to(x.dtype)


class SecondOrderDeformableAlignment(nn.Module):
    """A conv head predicts per-group offsets and modulation masks from
    `cond`; a modulated deformable 3x3 conv then aligns `x`. With `flow`
    (B, 2, H, W) as (dx, dy), the flow is added to every offset. Keys as
    the checkpoints': conv_offset.{0,2,4,6}, weight, bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 cond_channels: int, deform_groups: int = 16,
                 max_residue_magnitude: float = 3.0):
        super().__init__()
        self.deform_groups = deform_groups
        self.max_residue_magnitude = max_residue_magnitude
        c = out_channels
        self.conv_offset = nn.Sequential(
            nn.Conv2d(cond_channels, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * deform_groups, 3, 1, 1))
        self.weight = nn.Parameter(torch.empty(c, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, cond, flow=None):
        G, K = self.deform_groups, 9
        raw = self.conv_offset(cond).float()
        B, _, H, W = raw.shape
        offset = self.max_residue_magnitude * torch.tanh(raw[:, :2 * G * K])
        offset = offset.view(B, G, K, 2, H, W)
        if flow is not None:
            offset = offset + flow.float().flip(1).view(B, 1, 1, 2, H, W)
        mask = torch.sigmoid(raw[:, 2 * G * K:]).view(B, G, K, H, W)
        return modulated_deform_conv2d(x, offset, mask, self.weight,
                                       self.bias)
