"""Hiera, SAM2's hierarchical image encoder, PyTorch, channel-last.

Port of videovanish_tpu/models/sam2/hiera.py with the published checkpoint's
module names (`image_encoder.trunk.*` of sam2.1_hiera_large.pt): a windowed
attention ViT in 4 stages, 2x2 max-pooling of the queries at each stage
entry, a few global-attention blocks, and outputs at strides 4/8/16/32.

Attention goes through ops.attention: the windowed blocks that keep their
width use the token-major entry point (small_seq_attn at S = 64, flash at
S = 256), the q-pool blocks the head-split one (small_seq_attn at q S = 16,
k S = 64; flash at q S = 64, k S = 256), the global blocks flash at
S = 4096. As in the JAX package, consecutive windowed blocks of one window
size stay in the partitioned layout (windows on the batch axis): every
per-token op is the same there, and the 6-D transposes run only at stage
entries, global blocks and stage outputs.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from videovanish_tpu_torch.ops.attention import attention, attention_tokenmajor
from videovanish_tpu_torch.ops.resize import resize_bicubic_torch


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> ((B*nW, ws, ws, C), (Hp, Wp)), zero-padding H and W
    to multiples of ws."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return x, (Hp, Wp)


def window_unpartition(x: torch.Tensor, ws: int, hw_pad, hw) -> torch.Tensor:
    Hp, Wp = hw_pad
    H, W = hw
    B = x.shape[0] // ((Hp // ws) * (Wp // ws))
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of (B, H, W, C) (H, W even)."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in f32 (f32 parameters), cast back to x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


class Mlp(nn.Module):
    """Linear layers with ReLU between (`layers.i` keys); the last one
    plain, or followed by a sigmoid."""

    def __init__(self, dims: Sequence[int], sigmoid_out: bool = False,
                 act=F.relu):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.sigmoid_out = sigmoid_out
        self.act = act

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid_out else x


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax.linen.gelu (the tanh form) in f32, dtype kept: torch's bf16
    kernel computes in f32 and rounds once, so no f32 copy of x is made
    (at Hiera's first stage, 8 frames, such a copy and its result set the
    request's peak memory)."""
    return F.gelu(x, approximate="tanh")


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 7, stride=4, padding=3)

    def forward(self, x):  # (B, H, W, 3) -> (B, H/4, W/4, C)
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Windowed (or global) attention with optional 2x2 query pooling."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_pool: bool = False):
        super().__init__()
        self.dim_out, self.num_heads, self.q_pool = dim_out, num_heads, q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        B, H, W, _ = x.shape
        C = self.dim_out
        q, k, v = self.qkv(x).split(C, dim=-1)
        if not self.q_pool:
            # token-major: the kernels read the heads of the (B, S, C)
            # slices of qkv in place
            out = attention_tokenmajor(q.reshape(B, H * W, C),
                                       k.reshape(B, H * W, C),
                                       v.reshape(B, H * W, C), self.num_heads)
            return self.proj(out.reshape(B, H, W, C))
        q = max_pool_2x2(q)
        H, W = q.shape[1], q.shape[2]
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(B, -1, self.num_heads, hd).permute(0, 2, 1, 3)

        out = attention(heads(q), heads(k), heads(v))
        out = out.permute(0, 2, 1, 3).reshape(B, H, W, C)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 window_size: int, q_pool: bool = False,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.q_pool = window_size, q_pool
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = Mlp((dim_out, int(dim_out * mlp_ratio), dim_out),
                       act=gelu_tanh)

    def forward(self, x, window_size: int):
        """window_size: 0 for attention over the whole (already
        partitioned, or global) grid, else the window this block cuts."""
        shortcut = x
        h = layer_norm_f32(self.norm1, x)
        if self.q_pool:
            shortcut = max_pool_2x2(self.proj(h))
        if window_size > 0:
            hw = (h.shape[1], h.shape[2])
            h, hw_pad = window_partition(h, window_size)
            h = self.attn(h)
            f = 2 if self.q_pool else 1
            h = window_unpartition(h, window_size // f,
                                   (hw_pad[0] // f, hw_pad[1] // f),
                                   (shortcut.shape[1], shortcut.shape[2]))
        else:
            h = self.attn(h)
        x = shortcut + h
        return x + self.mlp(layer_norm_f32(self.norm2, x))


class Hiera(nn.Module):
    """4-stage hierarchical encoder: (B, H, W, 3) in the compute dtype ->
    features at strides 4/8/16/32, channel-last."""

    def __init__(self, embed_dim: int = 144, num_heads: int = 2,
                 stages: Sequence[int] = (2, 6, 36, 4),
                 window_spec: Sequence[int] = (8, 4, 16, 8),
                 global_att_blocks: Sequence[int] = (23, 33, 43),
                 pos_embed_bkg_size: Sequence[int] = (7, 7),
                 pos_embed_window_size: int = 8):
        super().__init__()
        self.stages, self.window_spec = tuple(stages), tuple(window_spec)
        self.global_att_blocks = tuple(global_att_blocks)
        self.patch_embed = PatchEmbed(embed_dim)
        # the checkpoint's (1, C, h, w) layout
        self.pos_embed = nn.Parameter(torch.zeros(1, embed_dim,
                                                  *pos_embed_bkg_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(
            1, embed_dim, pos_embed_window_size, pos_embed_window_size))
        blocks, dim, heads = [], embed_dim, num_heads
        for si, depth in enumerate(self.stages):
            for di in range(depth):
                q_pool = si > 0 and di == 0
                dim_out, heads = (2 * dim, 2 * heads) if q_pool else (dim, heads)
                blocks.append(MultiScaleBlock(dim, dim_out, heads, 0, q_pool))
                dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = self.patch_embed(x)
        B, H, W, C = x.shape
        # background embedding interpolated bicubically, plus the window
        # embedding tiled over the grid
        pe = resize_bicubic_torch(self.pos_embed.permute(0, 2, 3, 1), H, W)
        win = self.pos_embed_window.permute(0, 2, 3, 1).float()
        th, tw = -(-H // win.shape[1]), -(-W // win.shape[2])
        pe_win = win.repeat(1, th, tw, 1)[:, :H, :W]
        x = x + (pe + pe_win).to(x.dtype)

        # the partitioned layout: ws > 0 while x holds windows of size ws
        st = {"x": x, "ws": 0, "pad": None, "hw": None}

        def to_spatial():
            if st["ws"]:
                st["x"] = window_unpartition(st["x"], st["ws"], st["pad"],
                                             st["hw"])
                st["ws"] = 0

        def to_windowed(ws):
            if st["ws"] != ws:
                to_spatial()
                h_, w_ = st["x"].shape[1], st["x"].shape[2]
                # pad tokens kept alive across blocks would carry state
                # the reference (fresh zero padding per block) does not
                if h_ % ws or w_ % ws:
                    raise ValueError(
                        f"Hiera fused windowed layout needs the token grid "
                        f"({h_}x{w_}) divisible by window {ws}; use an "
                        f"image_size/window_spec that tiles.")
                st["hw"] = (h_, w_)
                st["x"], st["pad"] = window_partition(st["x"], ws)
                st["ws"] = ws

        outputs, blk = [], 0
        for si, depth in enumerate(self.stages):
            for di in range(depth):
                q_pool = si > 0 and di == 0
                # stage-entry blocks window at the previous stage's size
                ws = self.window_spec[si - 1] if q_pool else self.window_spec[si]
                wsz = 0 if blk in self.global_att_blocks else ws
                if q_pool or wsz == 0:
                    to_spatial()
                else:
                    to_windowed(wsz)
                    wsz = 0  # already windowed: attention over each window
                st["x"] = self.blocks[blk](st["x"], wsz)
                blk += 1
            to_spatial()
            outputs.append(st["x"])
        return outputs
