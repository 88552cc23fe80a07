"""AnimateDiff-style motion modules (temporal transformers), PyTorch.

Port of videovanish_tpu/models/diffueraser/temporal.py (diffusers
TransformerTemporalModel layout, as in the published unet_main
checkpoint):

  norm        GroupNorm(32, eps=1e-6), statistics over the whole clip
  proj_in     Linear(C, C)
  transformer_blocks.0:
    norm1 -> +sinusoidal PE -> attn1 (temporal self)
    norm2 -> +sinusoidal PE -> attn2 (temporal self)
    norm3 -> ff (GEGLU, mult 4)
  proj_out    Linear(C, C)
  + residual around the module

The temporal attention is over the frames of a window (22 at the default
clip length); on the card it runs the small_seq_attn kernel in place on
the token-major projections. The ring-attention branch of the JAX package
(sequence parallelism over several devices) is not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from videovanish_tpu_torch.models.diffueraser.blocks import (
    Attention, FeedForward, GroupNorm, LayerNorm,
)


@functools.lru_cache(maxsize=16)
def _pe_table(n: int, dim: int) -> np.ndarray:
    position = np.arange(n, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * (-np.log(10000.0) / dim))
    pe = np.zeros((n, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    pe.setflags(write=False)
    return pe


def sinusoidal_positional_embedding(n: int, dim: int,
                                    device=None) -> torch.Tensor:
    """(n, dim) interleaved sin/cos table (diffusers
    SinusoidalPositionalEmbedding: pe[:, 0::2] = sin, pe[:, 1::2] = cos)."""
    return torch.tensor(_pe_table(n, dim), device=device)


class TemporalTransformerBlock(nn.Module):
    """norm1 -> +PE -> attn1, norm2 -> +PE -> attn2, norm3 -> ff.
    (B*T, S, C) in and out; attention is over T."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim // heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim // heads)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, t_frames: int):
        BT, S, C = x.shape
        pe = sinusoidal_positional_embedding(t_frames, C, x.device)
        pos = pe.repeat(BT // t_frames, 1)[:, None, :]  # (B*T, 1, C)
        h = (self.norm1(x) + pos).to(x.dtype)
        x = x + self.attn1(h, t_frames=t_frames)
        h = (self.norm2(x) + pos).to(x.dtype)
        x = x + self.attn2(h, t_frames=t_frames)
        return x + self.ff(self.norm3(x).to(x.dtype))


class MotionModule(nn.Module):
    """GN -> proj_in -> temporal transformer block -> proj_out, plus the
    residual. Input (B*T, C, H, W); t_frames is the clip length."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm = GroupNorm(dim, 32, 1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(dim, heads)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, t_frames: int):
        BT, C, H, W = x.shape
        B = BT // t_frames
        # GroupNorm on (B, C, T, H, W): statistics pool over the clip
        h = self.norm(x.reshape(B, t_frames, C, H, W).transpose(1, 2))
        h = h.transpose(1, 2).reshape(BT, C, H, W) \
            .permute(0, 2, 3, 1).reshape(BT, H * W, C)
        h = self.proj_in(h)
        h = self.transformer_blocks[0](h, t_frames)
        h = self.proj_out(h)
        return h.reshape(BT, H, W, C).permute(0, 3, 1, 2) + x
