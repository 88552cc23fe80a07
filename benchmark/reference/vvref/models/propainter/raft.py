"""RAFT optical flow (Teed & Deng 2020), PyTorch, NCHW.

Port of videovanish_tpu/models/propainter/raft.py: the published large
configuration, with the `raft-things.pth` key names (fnet, cnet,
update_block, ...) without the DataParallel "module." prefix. The feature
encoder uses instance norm, the context encoder a frozen batch norm.

The correlation volume is built once per pair in f32 (all pairs, one
matmul) with an average-pooled pyramid; each iteration samples every
query's plane at 81 offsets around its warp target. The lookup gathers
the (2r+2)^2 integer taps around the shared floor of one query's offsets
and blends them with its one pair of bilinear weights: the same products
and sums as the JAX lookup (which contracts one-hot rows on the TPU's
matrix unit instead), zero outside the plane. Channels come level-major,
then x-offset-major (the published CorrBlock builds its offsets with
meshgrid(dy, dx) and applies the first axis to x). The flow accumulates
in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d without affine parameters, f32 statistics."""

    def forward(self, x):
        return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with its running statistics, in
    f32 whatever the activation type. Keys as the checkpoint's (weight,
    bias, running_mean, running_var, num_batches_tracked); a state dict
    without num_batches_tracked loads too."""

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0,
                            self.eps).to(x.dtype)


def _norm(kind: str, planes: int) -> nn.Module:
    if kind == "batch":
        return FrozenBatchNorm2d(planes)
    if kind == "instance":
        return InstanceNorm()
    return nn.Identity()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None if stride == 1 else nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, stride), _norm(norm, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/2 stem and three residual stages (64, 96/2, 128/2), then a 1x1
    head: features at 1/8 resolution."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.norm1 = _norm(norm, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm, 1),
                                    ResidualBlock(64, 64, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2),
                                    ResidualBlock(96, 96, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2),
                                    ResidualBlock(128, 128, norm, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_levels * (2 * corr_radius + 1) ** 2,
                                256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class SepConvGRU(nn.Module):
    """Horizontal (1x5) then vertical (5x1) convolutional GRU; gates in
    f32."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        hi = hidden + input_dim
        for s, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", nn.Conv2d(hi, hidden, k,
                                                       padding=p))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx).float())
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx).float())
            q = torch.tanh(getattr(self, f"convq{s}")(
                torch.cat([r.to(h.dtype) * h, x], 1)).float())
            h = ((1 - z) * h.float() + z * q).to(h.dtype)
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x))).float()


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(128, 128 + 128)
        self.flow_head = FlowHead(128, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        dflow = self.flow_head(net)
        return net, 0.25 * self.mask(net).float(), dflow


# ---------------------------------------------------------------------------
# correlation volume + lookup
# ---------------------------------------------------------------------------
def corr_volume_pyramid(f1: torch.Tensor, f2: torch.Tensor,
                        num_levels: int = 4):
    """All-pairs correlation of (B, C, h, w) features, scaled by 1/sqrt(C),
    and its 2x2 average-pooled pyramid over f2's axes (odd edges dropped;
    a level may come out empty on a small input). Returns num_levels f32
    volumes (B, h*w, Hl, Wl)."""
    B, C, h, w = f1.shape
    corr = torch.bmm(f1.reshape(B, C, h * w).transpose(1, 2).float(),
                     f2.reshape(B, C, h * w).float())
    vols = [(corr / math.sqrt(C)).view(B, h * w, h, w)]
    for _ in range(num_levels - 1):
        v = vols[-1]
        Hl, Wl = v.shape[2] // 2, v.shape[3] // 2
        vols.append(v[:, :, :2 * Hl, :2 * Wl]
                    .reshape(B, h * w, Hl, 2, Wl, 2).mean((3, 5)))
    return vols


def corr_lookup(vols, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample each level's per-query plane at the (2r+1)^2 integer offsets
    around coords / 2^level, bilinear, zero outside. coords (B, 2, h, w) as
    (x, y) in level-0 units; returns (B, levels * (2r+1)^2, h, w) f32."""
    B, _, h, w = coords.shape
    q = h * w
    n = 2 * radius + 2  # integer taps around the shared floor
    taps = torch.arange(-radius, radius + 2, device=coords.device,
                        dtype=torch.float32)
    out = []
    for lvl, V in enumerate(vols):
        Hl, Wl = V.shape[2], V.shape[3]
        if Hl * Wl == 0:  # every offset falls outside an empty level
            out.append(coords.new_zeros(B, q, (n - 1) ** 2))
            continue
        c = coords.float().reshape(B, 2, q) / (2 ** lvl)
        x0 = torch.floor(c[:, 0])
        y0 = torch.floor(c[:, 1])
        wx = (c[:, 0] - x0)[..., None, None]
        wy = (c[:, 1] - y0)[..., None, None]
        yi = y0[..., None] + taps  # (B, q, n)
        xi = x0[..., None] + taps
        inb = (((yi >= 0) & (yi < Hl))[..., :, None]
               & ((xi >= 0) & (xi < Wl))[..., None, :])
        idx = yi.clamp(0, Hl - 1).long()[..., :, None] * Wl \
            + xi.clamp(0, Wl - 1).long()[..., None, :]
        vals = torch.gather(V.reshape(B, q, Hl * Wl), 2,
                            idx.view(B, q, n * n)).view(B, q, n, n)
        t = torch.where(inb, vals, 0).transpose(-1, -2)  # (B, q, x, y)
        t00 = t[..., :-1, :-1]
        t01 = t[..., 1:, :-1]   # x + 1
        t10 = t[..., :-1, 1:]   # y + 1
        t11 = t[..., 1:, 1:]
        vals = ((1 - wy) * (1 - wx) * t00 + (1 - wy) * wx * t01
                + wy * (1 - wx) * t10 + wy * wx * t11)
        out.append(vals.reshape(B, q, (n - 1) ** 2))
    return torch.cat(out, -1).transpose(1, 2).reshape(B, -1, h, w)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor):
    """8x convex upsampling: each fine pixel a softmax-weighted mix of the
    3x3 coarse neighbourhood of 8 * flow. flow (B, 2, h, w); mask
    (B, 576, h, w) ordered (neighbour, 8, 8). Returns (B, 2, 8h, 8w) f32."""
    B, _, h, w = flow.shape
    m = torch.softmax(mask.float().view(B, 1, 9, 8, 8, h, w), dim=2)
    nbr = F.unfold(8.0 * flow.float(), 3, padding=1).view(B, 2, 9, 1, 1, h, w)
    up = (m * nbr).sum(2)  # (B, 2, 8, 8, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """Full RAFT (large: hidden and context 128, 4 levels, radius 4).
    Images (B, 3, H, W) in [-1, 1], H and W multiples of 8; returns the
    f32 flow image1 -> image2, (B, 2, H, W) as (dx, dy)."""

    def __init__(self, iters: int = 20, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(256, "batch")
        self.update_block = BasicUpdateBlock()

    def forward(self, image1, image2):
        B = image1.shape[0]
        f12 = self.fnet(torch.cat([image1, image2]))
        f1, f2 = f12[:B], f12[B:]
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :128].float()).to(image1.dtype)
        inp = F.relu(cnet[:, 128:])
        vols = corr_volume_pyramid(f1, f2, self.corr_levels)

        h8, w8 = f1.shape[-2:]
        gy, gx = torch.meshgrid(
            torch.arange(h8, device=image1.device, dtype=torch.float32),
            torch.arange(w8, device=image1.device, dtype=torch.float32),
            indexing="ij")
        base = torch.stack([gx, gy])[None]
        flow = torch.zeros(B, 2, h8, w8, device=image1.device)
        up_mask = None
        for _ in range(self.iters):
            corr = corr_lookup(vols, base + flow, self.corr_radius) \
                .to(image1.dtype)
            net, up_mask, dflow = self.update_block(net, inp, corr,
                                                    flow.to(image1.dtype))
            flow = flow + dflow
        return upsample_flow_convex(flow, up_mask)
