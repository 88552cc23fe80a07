"""SD1.5 conditional UNet with motion modules and BrushNet injection,
PyTorch, NCHW.

Port of videovanish_tpu/models/diffueraser/unet.py: conv_in -> 3
CrossAttnDown + Down -> mid -> Up + 3 CrossAttnUp -> conv_out, a 1280-d
time embedding and 768-d text cross-attention, a motion module after every
resnet (+attention) of every down/up block and the mid block when
t_frames > 1 (the diffusers UNetMotionModel placement of the published
unet_main checkpoint: 21 modules at SD1.5 width), and the BrushNet
features added at each skip, the mid block and each up resnet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from benchmark.reference.vvref.models.diffueraser.blocks import (
    Downsample2D, GroupNorm, ResnetBlock2D, TimestepEmbedding, Transformer2D,
    Upsample2D, timestep_embedding,
)
from benchmark.reference.vvref.models.diffueraser.temporal import MotionModule


def build_blocks(owner: nn.Module, ch: Sequence[int], layers: int, heads: int,
                 ctx_dim: int, temb_ch: int, motion: bool) -> None:
    """Give `owner` the diffusers down_blocks / mid_block / up_blocks of an
    SD1.5-shaped UNet (resnets, spatial transformers on all but the
    deepest down and the first up block, optional motion modules)."""
    n = len(ch)
    res_ch = [ch[0]]  # channels of the skip stack, as the forward builds it
    owner.down_blocks = nn.ModuleList()
    prev = ch[0]
    for i, c in enumerate(ch):
        blk = nn.Module()
        blk.resnets = nn.ModuleList([
            ResnetBlock2D(prev if j == 0 else c, c, temb_ch)
            for j in range(layers)])
        if i < n - 1:
            blk.attentions = nn.ModuleList([
                Transformer2D(c, heads, c // heads, ctx_dim)
                for _ in range(layers)])
        if motion:
            blk.motion_modules = nn.ModuleList([
                MotionModule(c, heads) for _ in range(layers)])
        res_ch += [c] * layers
        if i < n - 1:
            blk.downsamplers = nn.ModuleList([Downsample2D(c)])
            res_ch.append(c)
        owner.down_blocks.append(blk)
        prev = c
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock2D(ch[-1], ch[-1], temb_ch),
                                 ResnetBlock2D(ch[-1], ch[-1], temb_ch)])
    mid.attentions = nn.ModuleList([
        Transformer2D(ch[-1], heads, ch[-1] // heads, ctx_dim)])
    if motion:
        mid.motion_modules = nn.ModuleList([MotionModule(ch[-1], heads)])
    owner.mid_block = mid
    owner.up_blocks = nn.ModuleList()
    h_ch = ch[-1]
    for i, c in enumerate(reversed(ch)):
        blk = nn.Module()
        resnets = []
        for _ in range(layers + 1):
            resnets.append(ResnetBlock2D(h_ch + res_ch.pop(), c, temb_ch))
            h_ch = c
        blk.resnets = nn.ModuleList(resnets)
        if i > 0:
            blk.attentions = nn.ModuleList([
                Transformer2D(c, heads, c // heads, ctx_dim)
                for _ in range(layers + 1)])
        if motion:
            blk.motion_modules = nn.ModuleList([
                MotionModule(c, heads) for _ in range(layers + 1)])
        if i < n - 1:
            blk.upsamplers = nn.ModuleList([Upsample2D(c)])
        owner.up_blocks.append(blk)


def _add(x, res):
    return x if res is None else x + res.to(x.dtype)


class UNetCondition(nn.Module):
    """SD1.5 UNet. sample: (B*T, C_in, h, w); returns the epsilon
    prediction. brushnet_down (12 tensors at SD1.5 shape), brushnet_mid and
    brushnet_up (12) are BrushNetModel's additive features. `cache` (an
    AttentionCache) records or replays the spatial attention outputs.
    t_frames is the clip length; with `shard` (a SequenceShard) the sample
    holds this rank's block of each clip's frames and the motion modules
    run their temporal attention as ring attention across the ranks."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, num_attention_heads: int = 8,
                 cross_attention_dim: int = 768):
        super().__init__()
        ch = tuple(block_out_channels)
        self.ch, self.layers = ch, layers_per_block
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ch[0] * 4)
        build_blocks(self, ch, layers_per_block, num_attention_heads,
                     cross_attention_dim, ch[0] * 4, motion=True)
        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-5)
        self.conv_out = nn.Conv2d(ch[0], out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                t_frames: int = 1, brushnet_down: Optional[list] = None,
                brushnet_mid: Optional[torch.Tensor] = None,
                brushnet_up: Optional[list] = None, cache=None, shard=None):
        ctx = encoder_hidden_states
        temporal = t_frames > 1
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self.time_embedding(timestep_embedding(timesteps, self.ch[0])
                                   .to(self.conv_in.weight.dtype))
        bd = list(brushnet_down) if brushnet_down is not None else []
        bu = list(brushnet_up) if brushnet_up is not None else []

        h = _add(self.conv_in(sample), bd.pop(0) if bd else None)
        down_res = [h]
        for blk in self.down_blocks:
            for j in range(self.layers):
                h = blk.resnets[j](h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, cache)
                if temporal:
                    h = blk.motion_modules[j](h, t_frames, shard)
                h = _add(h, bd.pop(0) if bd else None)
                down_res.append(h)
            if hasattr(blk, "downsamplers"):
                h = _add(blk.downsamplers[0](h), bd.pop(0) if bd else None)
                down_res.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx, cache)
        if temporal:
            h = mid.motion_modules[0](h, t_frames, shard)
        h = _add(mid.resnets[1](h, temb), brushnet_mid)

        for blk in self.up_blocks:
            for j in range(self.layers + 1):
                skip = down_res.pop()
                h = torch.cat([h, skip.to(h.dtype)], dim=1)
                h = blk.resnets[j](h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, cache)
                if temporal:
                    h = blk.motion_modules[j](h, t_frames, shard)
                h = _add(h, bu.pop(0) if bu else None)
            if hasattr(blk, "upsamplers"):
                # target the next skip's exact (odd-safe) resolution
                h = blk.upsamplers[0](h, down_res[-1].shape[-2:])
        return self.conv_out(self.conv_norm_out(h, silu=True))
