"""SAM2's FPN neck and sine position encoding, PyTorch, channel-last.

Port of videovanish_tpu/models/sam2/neck.py with the checkpoint's names
(`image_encoder.neck.convs.<i>.conv`): `convs.0` takes the coarsest
(stride 32) Hiera level. 1x1 lateral convs to d_model, then the top-down
path adds the coarser level, upsampled 2x nearest, on levels 2 and 3.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch.nn as nn
import torch.nn.functional as F


def sine_pos_embed_2d(h: int, w: int, dim: int,
                      temperature: float = 10000.0) -> np.ndarray:
    """(h, w, dim) f32 numpy: SAM2's normalized sine position encoding
    (coordinates (i+1)/N * 2*pi, frequencies temperature**(2*(k//2)/(dim/2)),
    sin/cos interleaved per frequency, [y half, x half])."""
    assert dim % 4 == 0
    npf = dim // 2
    eps = 1e-6
    scale = 2.0 * math.pi
    ys = (np.arange(h, dtype=np.float64) + 1.0) / (h + eps) * scale
    xs = (np.arange(w, dtype=np.float64) + 1.0) / (w + eps) * scale
    dim_t = temperature ** (2.0 * (np.arange(npf) // 2) / npf)

    def interleave(v):
        p = v[:, None] / dim_t[None, :]
        out = np.empty((v.shape[0], npf))
        out[:, 0::2] = np.sin(p[:, 0::2])
        out[:, 1::2] = np.cos(p[:, 1::2])
        return out

    pe_y, pe_x = interleave(ys), interleave(xs)
    pe = np.concatenate([
        np.broadcast_to(pe_y[:, None, :], (h, w, npf)),
        np.broadcast_to(pe_x[None, :, :], (h, w, npf)),
    ], axis=-1)
    return pe.astype(np.float32)


class Conv1x1(nn.Module):
    """A 1x1 conv (the checkpoint's `<name>.conv` Conv2d) applied to
    channel-last input as a matmul."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return F.linear(x, self.conv.weight.flatten(1), self.conv.bias)


class FpnNeck(nn.Module):
    """Hiera outputs [stride 4, 8, 16, 32] (channel-last) -> d_model
    features in the same order. (The JAX module also returns each level's
    `sine_pos_embed_2d`; the predictor makes the ones it needs itself.)"""

    def __init__(self, backbone_channel_list: Sequence[int],
                 d_model: int = 256, top_down_levels: Sequence[int] = (2, 3)):
        super().__init__()
        self.top_down_levels = tuple(top_down_levels)
        self.convs = nn.ModuleList(Conv1x1(c, d_model)
                                   for c in backbone_channel_list)

    def forward(self, xs):
        n = len(xs)
        laterals = [self.convs[n - 1 - i](x) for i, x in enumerate(xs)]
        feats, prev = [None] * n, None
        for i in range(n - 1, -1, -1):
            f = laterals[i]
            if prev is not None and i in self.top_down_levels:
                up = prev.float().repeat_interleave(2, dim=1) \
                    .repeat_interleave(2, dim=2)
                f = f + up.to(f.dtype)
            feats[i] = f
            prev = f
        return feats
