"""BrushNet conditioning branch, PyTorch, NCHW.

Port of videovanish_tpu/models/diffueraser/brushnet.py: a clone of the
UNet's down/mid/up stack that sees [noisy latent (4), masked-image latent
(4), downsampled mask (1)], conditioned on the same text embedding, and
emits per-stage features through zero-initialised 1x1 convs that the main
UNet adds at its skip, mid and up stages. The published DiffuEraser
brushnet is frame-wise (no motion modules), as here.

Outputs align with UNetCondition's injection points: down (conv_in + every
down resnet and downsampler), mid, up (every up-block resnet).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from benchmark.reference.vvref.models.diffueraser.blocks import (
    TimestepEmbedding, timestep_embedding,
)
from benchmark.reference.vvref.models.diffueraser.unet import build_blocks


def zero_conv(channels: int) -> nn.Conv2d:
    """1x1 conv initialised to zeros (BrushNet's ZeroConv)."""
    conv = nn.Conv2d(channels, channels, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class BrushNetModel(nn.Module):
    """Returns (down_feats, mid_feat, up_feats) for UNetCondition."""

    def __init__(self, in_channels: int = 9,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, num_attention_heads: int = 8,
                 cross_attention_dim: int = 768):
        super().__init__()
        ch = tuple(block_out_channels)
        self.ch, self.layers = ch, layers_per_block
        self.conv_in_condition = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ch[0] * 4)
        build_blocks(self, ch, layers_per_block, num_attention_heads,
                     cross_attention_dim, ch[0] * 4, motion=False)
        down_ch = [ch[0]]
        for i, c in enumerate(ch):
            down_ch += [c] * (layers_per_block + (i < len(ch) - 1))
        up_ch = [c for c in reversed(ch) for _ in range(layers_per_block + 1)]
        self.brushnet_down_blocks = nn.ModuleList(
            [zero_conv(c) for c in down_ch])
        self.brushnet_mid_block = zero_conv(ch[-1])
        self.brushnet_up_blocks = nn.ModuleList([zero_conv(c) for c in up_ch])

    def forward(self, sample, timesteps, encoder_hidden_states):
        ctx = encoder_hidden_states
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.ch[0])
            .to(self.conv_in_condition.weight.dtype))
        zd = iter(self.brushnet_down_blocks)

        h = self.conv_in_condition(sample)
        down_feats = [next(zd)(h)]
        down_res = [h]
        for blk in self.down_blocks:
            for j in range(self.layers):
                h = blk.resnets[j](h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                down_feats.append(next(zd)(h))
                down_res.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                down_feats.append(next(zd)(h))
                down_res.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx)
        h = mid.resnets[1](h, temb)
        mid_feat = self.brushnet_mid_block(h)

        zu = iter(self.brushnet_up_blocks)
        up_feats = []
        for blk in self.up_blocks:
            for j in range(self.layers + 1):
                h = torch.cat([h, down_res.pop().to(h.dtype)], dim=1)
                h = blk.resnets[j](h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                up_feats.append(next(zu)(h))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, down_res[-1].shape[-2:])
        return down_feats, mid_feat, up_feats
