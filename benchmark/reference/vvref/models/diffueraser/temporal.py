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
the token-major projections. With a `SequenceShard` (the frames of the clip
split over the mesh's "data" axis, `parallel/ring_attention.py`) each rank
holds a block of every clip's frames: the attention runs as ring attention,
the GroupNorm statistics are summed over the ranks, and the positional
embedding takes the block's global frame indices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.vvref.models.diffueraser.blocks import (
    Attention, FeedForward, GroupNorm, LayerNorm,
)
from benchmark.reference.vvref.ops.groupnorm import group_norm_over_ranks


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

    def forward(self, x, t_frames: int, shard=None):
        """t_frames: the clip length; with `shard`, x holds this rank's
        block of t_frames // shard.size frames of each clip."""
        BT, S, C = x.shape
        t_local, first, attn_fn = t_frames, 0, None
        if shard is not None:
            t_local = t_frames // shard.size
            first, attn_fn = shard.index * t_local, shard.attn
        pe = sinusoidal_positional_embedding(t_frames, C, x.device)
        pos = pe[first:first + t_local].repeat(BT // t_local, 1)[:, None, :]
        h = (self.norm1(x) + pos).to(x.dtype)
        x = x + self.attn1(h, t_frames=t_local, attn_fn=attn_fn)
        h = (self.norm2(x) + pos).to(x.dtype)
        x = x + self.attn2(h, t_frames=t_local, attn_fn=attn_fn)
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

    def forward(self, x, t_frames: int, shard=None):
        """x (B*T, C, H, W); with `shard` (a SequenceShard), T is this
        rank's block of t_frames // shard.size frames of each clip."""
        BT, C, H, W = x.shape
        t_local = t_frames if shard is None else t_frames // shard.size
        B = BT // t_local
        # GroupNorm on (B, C, T, H, W): statistics pool over the clip
        h = x.reshape(B, t_local, C, H, W).transpose(1, 2)
        if shard is None:
            h = self.norm(h)
        else:
            n = self.norm
            h = group_norm_over_ranks(h, n.weight, n.bias, n.num_groups,
                                      n.eps, shard.group)
        h = h.transpose(1, 2).reshape(BT, C, H, W) \
            .permute(0, 2, 3, 1).reshape(BT, H * W, C)
        h = self.proj_in(h)
        h = self.transformer_blocks[0](h, t_frames, shard)
        h = self.proj_out(h)
        return h.reshape(BT, H, W, C).permute(0, 3, 1, 2) + x
