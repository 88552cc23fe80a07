"""ProPainter's InpaintGenerator, PyTorch, NCHW convolutions and
channel-last token grids.

Port of videovanish_tpu/models/propainter/inpaint_generator.py with the
`ProPainter.pth` key names:

  group-interleave encoder at 1/4 resolution
  -> flow-guided deformable feature propagation over the local frames
  -> SoftSplit (7x7/3 unfold + linear) -> sparse window-attention
     transformer blocks (window (5, 9), expanded-ring keys, pooled global
     tokens, every other frame's keys) -> SoftComp (linear + fold + conv)
  -> 2x-upsampling decoder -> tanh frames in [-1, 1].

Unfold and fold run in the checkpoint's channel-major patch layout
(`F.unfold` / `F.fold`). Attention is a plain batched matmul with an f32
softmax, as the JAX package computes it, and every window attends (the
published model skips windows without a hole; the extra outputs only
touch hole-free pixels).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videovanish_tpu_torch.models.propainter.deform import (
    SecondOrderDeformableAlignment,
)
from videovanish_tpu_torch.models.propainter.flow_completion import (
    Deconv, lrelu,
)
from videovanish_tpu_torch.models.propainter.propagation import (
    fb_consistency_check,
)
from videovanish_tpu_torch.ops.flow import flow_warp
from videovanish_tpu_torch.ops.resize import (
    resize_bilinear_torch_half_pixel, resize_nearest_2d,
)

KERNEL, STRIDE, PAD = 7, 3, 3


def t2t_hw(h: int, w: int):
    """Token grid of the 7x7/3 soft split of an (h, w) map."""
    return ((h + 2 * PAD - KERNEL) // STRIDE + 1,
            (w + 2 * PAD - KERNEL) // STRIDE + 1)


def _unfold(x):
    return F.unfold(x, KERNEL, padding=PAD, stride=STRIDE)


def _fold(x, out_hw):
    return F.fold(x, out_hw, KERNEL, padding=PAD, stride=STRIDE)


class Encoder(nn.Module):
    """After the fourth conv its output is re-concatenated group-wise with
    each later activation (groups 2, 4, 8, 1). Widths are the published
    chain scaled by channel / 128."""

    SPEC = ((64, 2, 1), (64, 1, 1), (128, 2, 1), (256, 1, 1), (384, 1, 1),
            (512, 1, 2), (384, 1, 4), (256, 1, 8), (128, 1, 1))
    GROUP = (1, 2, 4, 8, 1)

    def __init__(self, channel: int = 128):
        super().__init__()
        spec = [(ch * channel // 128, st, g) for ch, st, g in self.SPEC]
        layers, in_ch = [], 5
        for j, (ch, st, g) in enumerate(spec):
            if j > 4:
                in_ch = spec[3][0] + spec[j - 1][0]
            layers += [nn.Conv2d(in_ch, ch, 3, st, 1, groups=g),
                       nn.LeakyReLU(0.2)]
            in_ch = ch
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        out = x
        for i in range(0, len(self.layers), 2):
            if i == 8:
                x0 = out
                T, _, h, w = x0.shape
            if i > 8:
                g = self.GROUP[(i - 8) // 2]
                out = torch.cat([x0.view(T, g, -1, h, w),
                                 out.view(T, g, -1, h, w)], 2) \
                    .view(T, -1, h, w)
            out = lrelu(self.layers[i](out))
        return out


class SoftSplit(nn.Module):
    def __init__(self, channel: int, hidden: int):
        super().__init__()
        self.embedding = nn.Linear(channel * KERNEL * KERNEL, hidden)

    def forward(self, x):
        """(T, C, H, W) -> (T, fh, fw, hidden)."""
        fh, fw = t2t_hw(*x.shape[-2:])
        feat = self.embedding(_unfold(x).transpose(1, 2))
        return feat.view(x.shape[0], fh, fw, -1)


class SoftComp(nn.Module):
    def __init__(self, channel: int, hidden: int):
        super().__init__()
        self.embedding = nn.Linear(hidden, channel * KERNEL * KERNEL)
        self.bias_conv = nn.Conv2d(channel, channel, 3, 1, 1)

    def forward(self, x, out_hw):
        """(T, fh, fw, hidden) -> (T, channel, H, W)."""
        T = x.shape[0]
        feat = self.embedding(x.reshape(T, -1, x.shape[-1]))
        return self.bias_conv(_fold(feat.transpose(1, 2), out_hw))


def _ring_indices(window, expand):
    """Positions of the expanded-ring keys among the four diagonally rolled
    windows (the published valid_ind_rolled)."""
    wh, ww = window
    e0, e1 = expand
    masks = []
    for corner in range(4):
        m = np.ones((wh, ww), bool)
        ys = slice(0, wh - e0) if corner < 2 else slice(e0, wh)
        xs = slice(0, ww - e1) if corner % 2 == 0 else slice(e1, ww)
        m[ys, xs] = False
        masks.append(m)
    return np.nonzero(np.concatenate([m.reshape(-1) for m in masks]))[0]


def window_partition(x, wh: int, ww: int):
    """(T, H, W, C) -> (nW, T, wh * ww, C); H, W divisible by the window."""
    T, H, W, C = x.shape
    x = x.view(T, H // wh, wh, W // ww, ww, C).permute(1, 3, 0, 2, 4, 5)
    return x.reshape((H // wh) * (W // ww), T, wh * ww, C)


class SparseWindowAttention(nn.Module):
    def __init__(self, dim: int = 512, n_head: int = 4, window=(5, 9),
                 pool=(4, 4)):
        super().__init__()
        self.key = nn.Linear(dim, dim)
        self.query = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.pool_layer = nn.Conv2d(dim, dim, tuple(pool), tuple(pool), 0,
                                    groups=dim)
        self.n_head = n_head
        self.window = tuple(window)
        self.expand = tuple((i + 1) // 2 for i in window)
        self.register_buffer("valid_ind_rolled", torch.as_tensor(
            _ring_indices(self.window, self.expand)), persistent=False)

    def forward(self, x, t_ind):
        """x (T, H, W, C); t_ind: the range of frames whose keys and values
        count."""
        T, H, W, C = x.shape
        wh, ww = self.window
        e0, e1 = self.expand
        hd = C // self.n_head
        n_wh, n_ww = math.ceil(H / wh), math.ceil(W / ww)
        newH, newW = n_wh * wh, n_ww * ww
        if (newH, newW) != (H, W):
            x = F.pad(x, (0, 0, 0, newW - W, 0, newH - H))
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        t_sel = slice(t_ind.start, t_ind.stop, t_ind.step)
        k_s, v_s = k[t_sel], v[t_sel]

        win_q = window_partition(q, wh, ww)            # (nW, T, 45, C)
        rolls = [(-e0, -e1), (-e0, e1), (e0, -e1), (e0, e1)]
        ring = self.valid_ind_rolled

        def keys(a):
            rolled = torch.cat([window_partition(torch.roll(a, r, (1, 2)),
                                                 wh, ww) for r in rolls], 2)
            return [window_partition(a, wh, ww), rolled[:, :, ring]]

        # pooled global tokens: the learnable depthwise pooling conv, then
        # the same key and value projections
        pooled = self.pool_layer(x[t_sel].permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1)
        nW, Tk = n_wh * n_ww, len(t_ind)
        nP = pooled.shape[1] * pooled.shape[2]
        pool_k = self.key(pooled).reshape(1, Tk, nP, C).expand(nW, -1, -1, -1)
        pool_v = self.value(pooled).reshape(1, Tk, nP, C) \
            .expand(nW, -1, -1, -1)
        k_all = torch.cat(keys(k_s) + [pool_k], 2)
        v_all = torch.cat(keys(v_s) + [pool_v], 2)

        def heads(a):
            n, t, s, _ = a.shape
            return a.reshape(n, t * s, self.n_head, hd).transpose(1, 2)

        qh, kh, vh = heads(win_q), heads(k_all), heads(v_all)
        att = torch.matmul(qh.float(), kh.float().transpose(-2, -1)) \
            * (1.0 / math.sqrt(hd))
        att = torch.softmax(att, -1).to(vh.dtype)
        out = torch.matmul(att, vh).transpose(1, 2).reshape(nW, T, wh * ww, C)
        out = out.view(n_wh, n_ww, T, wh, ww, C).permute(2, 0, 3, 1, 4, 5)
        out = out.reshape(T, newH, newW, C)[:, :H, :W]
        return self.proj(out)


class FusionFeedForward(nn.Module):
    """fc1, then a fold / unfold round trip that averages each pixel's
    overlapping patch entries (zeros beyond the map's edge), exact GELU,
    fc2."""

    def __init__(self, dim: int = 512, hidden: int = 1960):
        super().__init__()
        self.fc1 = nn.Sequential(nn.Linear(dim, hidden))
        self.fc2 = nn.Sequential(nn.GELU(), nn.Linear(hidden, dim))

    def forward(self, x, out_hw):
        """x (T, fh, fw, C) -> (T, fh, fw, C)."""
        T, fh, fw, C = x.shape
        h = self.fc1(x.reshape(T, fh * fw, C))
        folded = _fold(h.transpose(1, 2).float(), out_hw)
        count = _fold(torch.ones(1, KERNEL * KERNEL, fh * fw,
                                 device=x.device), out_hw)
        h = _unfold(folded / count).transpose(1, 2).to(x.dtype)
        return self.fc2(h).view(T, fh, fw, C)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm with f32 statistics and parameters, dtype kept."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class TemporalSparseTransformer(nn.Module):
    def __init__(self, dim=512, n_head=4, window=(5, 9), pool=(4, 4),
                 ffn_hidden=1960):
        super().__init__()
        self.attention = SparseWindowAttention(dim, n_head, window, pool)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.mlp = FusionFeedForward(dim, ffn_hidden)

    def forward(self, x, fold_hw, t_ind):
        x = x + self.attention(self.norm1(x), t_ind)
        return x + self.mlp(self.norm2(x), fold_hw)


class TemporalSparseTransformerBlock(nn.Module):
    """Block i attends with the keys of frames i % t_dilation, +t_dilation,
    ..."""

    def __init__(self, depths=8, dim=512, n_head=4, window=(5, 9),
                 pool=(4, 4), t_dilation=2, ffn_hidden=1960):
        super().__init__()
        self.t_dilation = t_dilation
        self.transformer = nn.ModuleList(
            [TemporalSparseTransformer(dim, n_head, window, pool, ffn_hidden)
             for _ in range(depths)])

    def forward(self, x, fold_hw):
        T = x.shape[0]
        for i, block in enumerate(self.transformer):
            x = block(x, fold_hw, range(i % self.t_dilation, T,
                                        self.t_dilation))
        return x


class DualDomainPropagation(nn.Module):
    """Flow-guided deformable feature propagation (the published
    BidirectionalPropagation with learnable=True): a backward pass over
    reversed frames, a forward pass over its output, the fuse convs and a
    residual."""

    def __init__(self, channel: int = 128):
        super().__init__()
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for name in ("backward_1", "forward_1"):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                channel, channel, 2 * channel + 2 + 1 + 2, deform_groups=16)
            self.backbone[name] = nn.Sequential(
                nn.Conv2d(2 * channel + 2, channel, 3, 1, 1),
                nn.LeakyReLU(0.2), nn.Conv2d(channel, channel, 3, 1, 1))
        self.fuse = nn.Sequential(
            nn.Conv2d(2 * channel + 2, channel, 3, 1, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(channel, channel, 3, 1, 1))

    def _run(self, name, feats, masks, flows_prop, flows_check):
        align, backbone = self.deform_align[name], self.backbone[name]
        dt = feats.dtype
        out = []
        for i in range(feats.shape[0]):
            cur, m = feats[i:i + 1], masks[i:i + 1].to(dt)
            if i == 0:
                feat_prop = cur
            else:
                f_p = flows_prop[i - 1:i]
                valid = fb_consistency_check(f_p, flows_check[i - 1:i])
                cond = torch.cat([cur, flow_warp(feat_prop, f_p), f_p.to(dt),
                                  valid.to(dt), m], 1)
                feat_prop = align(feat_prop, cond, f_p)
            feat_prop = feat_prop + backbone(torch.cat([cur, feat_prop, m], 1))
            out.append(feat_prop)
        return torch.cat(out)

    def forward(self, x, flows_f, flows_b, masks):
        """x (T, C, H, W); flows_f (T-1, 2, H, W) t -> t+1, flows_b t+1 -> t;
        masks (T, 2, H, W) (input mask, updated mask)."""
        bwd = self._run("backward_1", x.flip(0), masks.flip(0),
                        flows_f.flip(0), flows_b.flip(0)).flip(0)
        fwd = self._run("forward_1", bwd, masks, flows_b, flows_f)
        return self.fuse(torch.cat([bwd, fwd, masks.to(x.dtype)], 1)) + x


class InpaintGenerator(nn.Module):
    def __init__(self, channel=128, hidden=512, depths=8, n_head=4,
                 window=(5, 9), pool=(4, 4), t_dilation=2, ffn_channels=40):
        super().__init__()
        c = channel  # the published decoder widths scale with channel
        self.encoder = Encoder(channel)
        self.decoder = nn.Sequential(
            Deconv(c, c), nn.LeakyReLU(0.2),
            nn.Conv2d(c, c // 2, 3, 1, 1), nn.LeakyReLU(0.2),
            Deconv(c // 2, c // 2), nn.LeakyReLU(0.2),
            nn.Conv2d(c // 2, 3, 3, 1, 1))
        self.ss = SoftSplit(channel, hidden)
        self.sc = SoftComp(channel, hidden)
        self.feat_prop_module = DualDomainPropagation(channel)
        self.transformers = TemporalSparseTransformerBlock(
            depths, hidden, n_head, window, pool, t_dilation,
            49 * ffn_channels)

    def forward(self, masked_frames, completed_flows, masks_in,
                masks_updated, l_t: int):
        """masked_frames (T, 3, H, W) in [-1, 1], the first l_t local and
        the rest references; completed_flows (flows_f, flows_b), each
        (l_t-1, 2, H, W); masks (T, 1, H, W). Returns (l_t, 3, H, W) f32 in
        [-1, 1]."""
        dt = self.ss.embedding.weight.dtype
        enc = self.encoder(torch.cat([masked_frames, masks_in, masks_updated],
                                     1).to(dt))
        h, w = enc.shape[-2:]
        flows_f, flows_b = completed_flows
        ds_f = resize_bilinear_torch_half_pixel(flows_f, h, w) / 4.0
        ds_b = resize_bilinear_torch_half_pixel(flows_b, h, w) / 4.0
        prop_mask = torch.cat([resize_nearest_2d(masks_in[:l_t], h, w),
                               resize_nearest_2d(masks_updated[:l_t], h, w)],
                              1)
        local = self.feat_prop_module(enc[:l_t], ds_f, ds_b, prop_mask)
        enc = torch.cat([local, enc[l_t:]])
        trans = self.transformers(self.ss(enc), (h, w))
        enc = enc + self.sc(trans, (h, w))
        return torch.tanh(self.decoder(enc[:l_t]).float())
