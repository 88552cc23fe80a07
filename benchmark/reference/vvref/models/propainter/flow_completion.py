"""Recurrent flow completion (ProPainter's RecurrentFlowCompleteNet), PyTorch.

Port of videovanish_tpu/models/propainter/flow_completion.py with the
`recurrent_flow_completion.pth` key names (its training-only edge head
left out): a P3D encoder over (flow, mask) from 1/2 to 1/8 resolution, a
dilated mid stack, second-order deformable propagation backward then
forward over the frames (a Python loop over frames), and a decoder of
bilinear (align_corners) 2x upsamples and convs back to flow.

With a mesh the frames shard over its "data" axis (the JAX package's `_wsc`
constraints): the encoder, the mid stack and the decoder run on the rank's
block of frames and the recurrence runs whole on every rank. The encoder's
four (3, 1, 1) dilation-2 temporal convolutions read 2 frames on each side,
8 in all, which GSPMD supplies by halo exchanges; here each rank runs the
encoder on its block widened by those 8 frames of the input, which every
rank holds, and keeps the block: no traffic before the all-gather that
feeds the recurrence.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.vvref.standins import (
    data_coords, frame_block, gather_blocks,
)
from benchmark.reference.vvref.models.propainter.deform import (
    SecondOrderDeformableAlignment,
)
from benchmark.reference.vvref.ops.resize import resize_bilinear_align_corners
from benchmark.reference.vvref.standins import trace_annotation


def lrelu(x, slope: float = 0.2):
    return F.leaky_relu(x, slope)


class P3DBlock(nn.Module):
    """(1, k, k) spatial conv, then a (3, 1, 1) dilation-2 temporal conv,
    on (B, C, T, H, W)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        p = kernel // 2
        self.conv1 = nn.Sequential(nn.Conv3d(
            in_ch, out_ch, (1, kernel, kernel), (1, stride, stride),
            (0, p, p)))
        self.conv2 = nn.Sequential(nn.Conv3d(
            out_ch, out_ch, (3, 1, 1), 1, (2, 0, 0), dilation=(2, 1, 1)))

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Deconv(nn.Module):
    """2x bilinear upsample (align_corners=True), then a conv; the
    checkpoints' `deconv` helper (keys `<name>.conv.*`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, 1, padding)

    def forward(self, x):
        H, W = x.shape[-2:]
        return self.conv(resize_bilinear_align_corners(x, 2 * H, 2 * W))


class FlowCompBidirectionalPropagation(nn.Module):
    """Second-order deformable propagation without flow guidance: a
    backward pass over the frames, then a forward pass that also reads the
    backward pass's features, fused by a 1x1 conv with a residual."""

    def __init__(self, channel: int):
        super().__init__()
        self.channel = channel
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(("backward_", "forward_")):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                2 * channel, channel, 3 * channel, deform_groups=16)
            self.backbone[name] = nn.Sequential(
                nn.Conv2d((2 + i) * channel, channel, 3, 1, 1),
                nn.LeakyReLU(0.1), nn.Conv2d(channel, channel, 3, 1, 1))
        self.fusion = nn.Conv2d(2 * channel, channel, 1, 1, 0)

    def _run(self, name, feats, extra):
        """feats: frames in propagation order (T, C, H, W); extra: the
        earlier pass's features in the same order, or None."""
        align, backbone = self.deform_align[name], self.backbone[name]
        zero = torch.zeros_like(feats[:1])
        prev1 = prev2 = zero
        out = []
        for i in range(feats.shape[0]):
            cur = feats[i:i + 1]
            if i > 0:
                cond = torch.cat([prev1, cur, prev2], 1)
                feat_prop = align(torch.cat([prev1, prev2], 1), cond)
            else:
                feat_prop = zero
            cat = [cur] + ([] if extra is None else [extra[i:i + 1]]) \
                + [feat_prop]
            feat_prop = feat_prop + backbone(torch.cat(cat, 1))
            prev1, prev2 = feat_prop, prev1
            out.append(feat_prop)
        return torch.cat(out)

    def forward(self, x):
        bwd = self._run("backward_", x.flip(0), None).flip(0)
        fwd = self._run("forward_", x, bwd)
        return self.fusion(torch.cat([bwd, fwd], 1)) + x


class RecurrentFlowCompleteNet(nn.Module):
    """Completes (T, 2, H, W) masked flows given (T, 1, H, W) hole masks;
    H and W multiples of 8. base = 32 is the published width."""

    def __init__(self, base: int = 32):
        super().__init__()
        b1, b2, b4 = base, 2 * base, 4 * base
        self.downsample = nn.Sequential(
            nn.Conv3d(3, b1, (1, 5, 5), (1, 2, 2), (0, 2, 2),
                      padding_mode="replicate"), nn.LeakyReLU(0.2))
        self.encoder1 = nn.Sequential(
            P3DBlock(b1, b1, 3, 1), nn.LeakyReLU(0.2),
            P3DBlock(b1, b2, 3, 2), nn.LeakyReLU(0.2))
        self.encoder2 = nn.Sequential(
            P3DBlock(b2, b2, 3, 1), nn.LeakyReLU(0.2),
            P3DBlock(b2, b4, 3, 2), nn.LeakyReLU(0.2))
        mid = []
        for dil in (3, 2, 1):
            mid += [nn.Conv3d(b4, b4, (1, 3, 3), 1, (0, dil, dil),
                              dilation=(1, dil, dil)), nn.LeakyReLU(0.2)]
        self.mid_dilation = nn.Sequential(*mid)
        self.feat_prop_module = FlowCompBidirectionalPropagation(b4)
        self.decoder2 = nn.Sequential(
            nn.Conv2d(b4, b4, 3, 1, 1), nn.LeakyReLU(0.2),
            Deconv(b4, b2, 3, 1), nn.LeakyReLU(0.2))
        self.decoder1 = nn.Sequential(
            nn.Conv2d(b2, b2, 3, 1, 1), nn.LeakyReLU(0.2),
            Deconv(b2, b1, 3, 1), nn.LeakyReLU(0.2))
        self.upsample = nn.Sequential(
            nn.Conv2d(b1, b1, 3, 1, 1), nn.LeakyReLU(0.2),
            Deconv(b1, 2, 3, 1))

    # frames each side that the encoder's temporal convolutions read: four
    # (3, 1, 1) convolutions at dilation 2
    HALO = 8

    def forward(self, masked_flows, masks, mesh=None):
        """masked_flows (T, 2, H, W), masks (T, 1, H, W) -> completed flow
        (T, 2, H, W) f32. With a mesh every rank holds all T frames and
        returns them all (see the module docstring)."""
        dt = self.downsample[0].weight.dtype
        x = torch.cat([masked_flows, masks], 1).to(dt)
        T = x.shape[0]
        a, b = 0, T
        sharded = data_coords(mesh)[1] > 1
        if sharded:  # this rank's block, widened by the encoder's halo
            a, b = frame_block(T, mesh)
            lo, hi = max(0, a - self.HALO), min(T, b + self.HALO)
            x = x[lo:hi]
        x = x.transpose(0, 1)[None]                      # (1, 3, T, H, W)
        e1 = self.encoder1(self.downsample(x))
        mid = self.mid_dilation(self.encoder2(e1))[0].transpose(0, 1)
        e1 = e1[0].transpose(0, 1)                       # (T, C, h, w)
        if sharded:
            e1, mid = e1[a - lo:b - lo], mid[a - lo:b - lo]
            mid = gather_blocks(mesh, mid, T)
        with trace_annotation("pp.flow_recurrence"):  # whole on every rank
            feat = self.feat_prop_module(mid)            # (T, C, h, w)
        d2 = self.decoder2(feat[a:b]) + e1
        flow = self.upsample(self.decoder1(d2)).float()
        return gather_blocks(mesh, flow, T) if sharded else flow

    def forward_bidirect_flow(self, flows_forward, flows_backward, masks,
                              mesh=None):
        """Mask both directions' flows in the holes, complete them, and keep
        the completed values inside the holes only. flows_* (T-1, 2, H, W)
        (forward t -> t+1, backward t+1 -> t); masks (T, 1, H, W)."""
        m_f, m_b = masks[:-1], masks[1:]
        masked_f = flows_forward * (1.0 - m_f)
        masked_b = flows_backward * (1.0 - m_b)
        pred_f = self(masked_f, m_f, mesh)
        pred_b = self(masked_b, m_b, mesh)
        return (pred_f * m_f + masked_f * (1.0 - m_f),
                pred_b * m_b + masked_b * (1.0 - m_b))
