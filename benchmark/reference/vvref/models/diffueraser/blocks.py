"""Shared diffusion building blocks (SD1.5 family), PyTorch, NCHW.

Port of videovanish_tpu/models/diffueraser/blocks.py. Module and parameter
names are the diffusers checkpoint keys (`to_out.0`, `ff.net.0.proj`,
`proj_in` as a 1x1 conv, ...), so published state dicts load without a
converter. Attention goes through ops.attention (the Hopper kernels on the
card); GroupNorm and LayerNorm keep f32 statistics and f32 parameters
whatever the activation type.

Attention, FeedForward and TimestepEmbedding run tensor-parallel when their
`model_shard` is set (parallel/sharding.py `shard_module_`, the trainer on a
mesh with a "model" axis above 1): their split parameters are this rank's
shards, the input enters through `copy_to_model` and the row-split output
layer sums the ranks' partial products. Without it they are the plain
layers.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.vvref.ops.attention import attention, attention_tokenmajor
from benchmark.reference.vvref.ops.groupnorm import group_norm, group_norm_silu
from benchmark.reference.vvref.standins import copy_to_model, row_linear


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers Timesteps), f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin], -1) if flip_sin_to_cos \
        else torch.cat([sin, cos], -1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear (diffusers TimestepEmbedding)."""
    model_shard = None

    def __init__(self, in_dim: int, emb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, emb_dim)
        self.linear_2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, t_emb):
        s = self.model_shard
        return row_linear(self.linear_2, F.silu(self.linear_1(
            copy_to_model(t_emb, s))), s)


class GroupNorm(nn.Module):
    """GroupNorm with f32 statistics over (N, C, *) input. Channel counts
    that 32 does not divide (smoke configs) use the largest common group
    count, as the JAX package does."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups if channels % num_groups == 0 \
            else math.gcd(channels, num_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, silu: bool = False):
        fn = group_norm_silu if silu else group_norm
        return fn(x, self.weight, self.bias, self.num_groups, self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in f32 whatever the input type."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


class ResnetBlock2D(nn.Module):
    """GN+SiLU+Conv twice, with the time-embedding shift and a 1x1
    shortcut when the width changes."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch else None
        self.norm2 = GroupNorm(out_ch, groups, eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) \
            if in_ch != out_ch else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionCache:
    """Cross-step reuse of spatial attention outputs: with `replay` False
    every Attention called with this cache records its output; with
    `replay` True it returns the recorded output instead of computing."""

    def __init__(self):
        self.replay = False
        self.outputs: dict = {}


class Attention(nn.Module):
    """Multi-head attention (self or cross) over token-major (B, S, C);
    heads / model of the heads on this rank under a `model_shard`."""
    model_shard = None

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, use_bias: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=use_bias)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=use_bias)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=use_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim or query_dim)])

    def forward(self, x, context=None, t_frames: Optional[int] = None,
                cache: Optional[AttentionCache] = None,
                attn_fn: Optional[Callable] = None):
        shard = self.model_shard
        heads = self.heads if shard is None else self.heads // shard.size
        if t_frames is not None:
            # temporal self-attention: (B*T, S, C) in and out; the tokens
            # cross into (B*S, T, C) once before the projections and back
            # once after the output projection. attn_fn, if given, replaces
            # the attention op on (B*S, heads, T, head_dim) q, k, v (ring
            # attention over frames split across ranks)
            BT, S, C = x.shape
            B = BT // t_frames
            h = x.reshape(B, t_frames, S, C).transpose(1, 2) \
                .reshape(B * S, t_frames, C)
            h = copy_to_model(h, shard)
            q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
            if attn_fn is None:
                out = attention_tokenmajor(q, k, v, heads)
            else:
                def split(t):
                    return t.view(B * S, t_frames, heads,
                                  self.head_dim).transpose(1, 2)

                out = attn_fn(split(q), split(k), split(v)).transpose(1, 2) \
                    .reshape(B * S, t_frames, -1)
            out = row_linear(self.to_out[0], out, shard)
            return out.reshape(B, S, t_frames, -1).transpose(1, 2) \
                .reshape(BT, S, -1)
        if cache is not None and cache.replay:
            return cache.outputs[self]
        B, S, _ = x.shape
        x = copy_to_model(x, shard)
        ctx = x if context is None else copy_to_model(context, shard)
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if context is None:
            out = attention_tokenmajor(q, k, v, heads)
        else:
            def split(t):
                return t.view(B, -1, heads, self.head_dim) \
                    .permute(0, 2, 1, 3)

            out = attention(split(q), split(k), split(v))
            out = out.permute(0, 2, 1, 3).reshape(B, S, -1)
        out = row_linear(self.to_out[0], out, shard)
        if cache is not None:
            cache.outputs[self] = out
        return out


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # exact (erf) GELU in f32
        return h * F.gelu(gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    """GEGLU -> Linear; the hidden width split under a `model_shard`."""
    model_shard = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index 1 is diffusers' dropout slot (no parameters)
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        s = self.model_shard
        return row_linear(self.net[2], self.net[0](copy_to_model(x, s)), s)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> FF, pre-LayerNorm (SD1.5 layout)."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, cache=None):
        x = x + self.attn1(self.norm1(x).to(x.dtype), cache=cache)
        x = x + self.attn2(self.norm2(x).to(x.dtype), context, cache=cache)
        return x + self.ff(self.norm3(x).to(x.dtype))


class Transformer2D(nn.Module):
    """GN -> proj_in -> transformer blocks over H*W tokens -> proj_out,
    plus the residual. proj_in/proj_out are 1x1 convs in the checkpoint
    and run as matmuls on the token form."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, head_dim, context_dim)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context=None, cache=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = F.linear(h, self.proj_in.weight.view(C, C), self.proj_in.bias)
        for blk in self.transformer_blocks:
            h = blk(h, context, cache)
        h = F.linear(h, self.proj_out.weight.view(C, C), self.proj_out.bias)
        return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    """Stride-2 conv. The VAE encoder pads (0, 1, 0, 1) first (floor
    semantics); the UNet pads 1 on every side (ceil semantics)."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest resize (x2, or to an explicit size so odd skip resolutions
    concatenate cleanly; half-pixel source centres) + conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, out_hw=None):
        size = tuple(out_hw) if out_hw is not None \
            else (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.conv(F.interpolate(x, size=size, mode="nearest-exact"))


def cast_for_inference(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights and biases of every Linear and Conv2d to `dtype`;
    normalisation parameters stay f32."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.to(dtype)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded re-initialisation at PyTorch's default scale: every Linear
    and Conv2d weight and bias uniform in +-1/sqrt(fan_in) (what
    kaiming_uniform_(a=sqrt(5)) gives), norms at weight 1, bias 0. The
    generator lies on the parameters' device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    return module
