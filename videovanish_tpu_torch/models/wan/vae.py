"""The Wan-VAE (`WanVAE_` of github.com/Wan-Video/Wan2.1, `wan/modules/
vae.py`), PyTorch, with Wan's own state-dict keys: a causal 3D
convolutional autoencoder, stride (4, 8, 8), 16 latent channels.

Every 3D convolution is causal in time: padded by two frames in front
(zeros at the start, the last two input frames of the previous chunk
after it, kept in a feature cache). Norms are RMS over the channels times
sqrt(C) and `gamma` (Wan's bias is the constant 0 in every use). Encode
runs the first frame, then four frames at a time; decode one latent
frame at a time. The temporal resamplers treat the first chunk apart:
`downsample3d` passes it through and keeps it for the next chunk's
stride-2 `time_conv`, `upsample3d` passes it through ('Rep') and from the
second chunk on doubles the frames with its `time_conv`. So 4k+1 frames
encode to k+1 latent frames and decode back to 4k+1. The mid-blocks hold
a single-head attention over each frame's pixels (head dim 4 * base).

Precision: on the card convolutions run in bf16 and the norms in f32; on
the CPU everything is f32. The latents are normalised by the published
per-channel mean and std.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from videovanish_tpu_torch.config import WanConfig
from videovanish_tpu_torch.ops.attention import attention

CACHE_T = 2


class CausalConv3d(nn.Conv3d):
    """Conv3d padded by 2 * padding[0] frames in front (the cache, then
    zeros) and symmetrically in space."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self._front = 2 * self.padding[0]
        self.padding = (0, self.padding[1], self.padding[2])

    def forward(self, x, cache=None):
        front = self._front
        if cache is not None and front > 0:
            x = torch.cat([cache, x], dim=2)
            front -= cache.shape[2]
        if front > 0:
            x = F.pad(x, (0, 0, 0, 0, front, 0))
        return super().forward(x)


class RMSNorm(nn.Module):
    """Wan's RMS_norm (bias=False): x / ||x||_channels * sqrt(C) * gamma,
    in f32."""

    def __init__(self, dim: int, images: bool = True):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim, *((1, 1) if images
                                                    else (1, 1, 1))))

    def forward(self, x):
        xf = x.float()
        n = torch.linalg.vector_norm(xf, dim=1, keepdim=True).clamp_min(1e-12)
        return xf / n * (self.scale * self.gamma.float())


def _norm_silu(norm, x):
    return F.silu(norm(x)).to(x.dtype)


def _cache_of(x, old):
    """The last CACHE_T frames of a conv's input, the previous cache's last
    frame in front when x has one frame."""
    c = x[:, :, -CACHE_T:].clone()
    if c.shape[2] < 2 and old is not None and not isinstance(old, str):
        c = torch.cat([old[:, :, -1:], c], dim=2)
    return c


class _Cache:
    """The feature cache of one encode or decode: a slot per causal
    convolution, walked in order each chunk."""

    def __init__(self):
        self.slots: list = []
        self.i = 0

    def start_chunk(self):
        self.i = 0

    def conv(self, layer, x):
        """`layer` over x with the slot's cache, which x then replaces."""
        if self.i == len(self.slots):
            self.slots.append(None)
        old = self.slots[self.i]
        self.slots[self.i] = _cache_of(x, old)
        self.i += 1
        return layer(x, old)

    def take(self):
        if self.i == len(self.slots):
            self.slots.append(None)
        self.i += 1
        return self.i - 1


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.residual = nn.Sequential(
            RMSNorm(cin, images=False), nn.SiLU(),
            CausalConv3d(cin, cout, 3, padding=1),
            RMSNorm(cout, images=False), nn.SiLU(), nn.Dropout(0.0),
            CausalConv3d(cout, cout, 3, padding=1))
        self.shortcut = CausalConv3d(cin, cout, 1) if cin != cout \
            else nn.Identity()

    def forward(self, x, cache: _Cache):
        h = self.shortcut(x)
        r = self.residual
        x = cache.conv(r[2], _norm_silu(r[0], x))
        x = cache.conv(r[6], _norm_silu(r[3], x))
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over each frame's pixels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        y = self.norm(y).to(x.dtype)
        qkv = self.to_qkv(y).reshape(b * t, 1, 3 * c, h * w) \
            .permute(0, 1, 3, 2).contiguous()
        q, k, v = qkv.chunk(3, dim=-1)
        y = attention(q, k, v)  # (bt, 1, hw, c)
        y = y.squeeze(1).permute(0, 2, 1).reshape(b * t, c, h, w)
        y = self.proj(y).reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4)
        return x + y


class Resample(nn.Module):
    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.mode = mode
        if mode.startswith("upsample"):
            self.resample = nn.Sequential(
                nn.Upsample(scale_factor=(2.0, 2.0), mode="nearest-exact"),
                nn.Conv2d(dim, dim // 2, 3, padding=1))
            if mode == "upsample3d":
                self.time_conv = CausalConv3d(dim, dim * 2, (3, 1, 1),
                                              padding=(1, 0, 0))
        else:
            self.resample = nn.Sequential(
                nn.ZeroPad2d((0, 1, 0, 1)),
                nn.Conv2d(dim, dim, 3, stride=(2, 2)))
            if mode == "downsample3d":
                self.time_conv = CausalConv3d(dim, dim, (3, 1, 1),
                                              stride=(2, 1, 1))

    def forward(self, x, cache: _Cache):
        b, c, t, h, w = x.shape
        if self.mode == "upsample3d":
            i = cache.take()
            old = cache.slots[i]
            if old is None:
                cache.slots[i] = "Rep"
            else:
                new = x[:, :, -CACHE_T:].clone()
                if new.shape[2] < 2:
                    front = torch.zeros_like(new) if isinstance(old, str) \
                        else old[:, :, -1:]
                    new = torch.cat([front, new], dim=2)
                x = self.time_conv(x, None if isinstance(old, str) else old)
                cache.slots[i] = new
                x = x.reshape(b, 2, c, t, h, w)
                x = torch.stack((x[:, 0], x[:, 1]), 3).reshape(
                    b, c, t * 2, h, w)
        t = x.shape[2]
        y = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        y = self.resample(y)
        x = y.reshape(b, t, *y.shape[1:]).permute(0, 2, 1, 3, 4)
        if self.mode == "downsample3d":
            i = cache.take()
            old = cache.slots[i]
            cache.slots[i] = x[:, :, -1:].clone() if old is not None \
                else x.clone()
            if old is not None:
                x = self.time_conv(torch.cat([old[:, :, -1:], x], 2))
        return x


def _run(layers, x, cache: _Cache):
    for layer in layers:
        x = layer(x, cache) if isinstance(layer, (ResidualBlock, Resample)) \
            else layer(x)
    return x


class Encoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks, temporal_down):
        super().__init__()
        dims = [dim * u for u in (1, *dim_mult)]
        self.conv1 = CausalConv3d(3, dims[0], 3, padding=1)
        down = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(num_res_blocks):
                down.append(ResidualBlock(cin, cout))
                cin = cout
            if i != len(dim_mult) - 1:
                down.append(Resample(cout, "downsample3d" if temporal_down[i]
                                     else "downsample2d"))
        self.downsamples = nn.Sequential(*down)
        self.middle = nn.Sequential(ResidualBlock(cout, cout),
                                    AttentionBlock(cout),
                                    ResidualBlock(cout, cout))
        self.head = nn.Sequential(RMSNorm(cout, images=False), nn.SiLU(),
                                  CausalConv3d(cout, z_dim, 3, padding=1))

    def forward(self, x, cache: _Cache):
        x = cache.conv(self.conv1, x)
        x = _run(self.downsamples, x, cache)
        x = _run(self.middle, x, cache)
        return cache.conv(self.head[2], _norm_silu(self.head[0], x))


class Decoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks, temporal_up):
        super().__init__()
        dims = [dim * u for u in (dim_mult[-1], *dim_mult[::-1])]
        self.conv1 = CausalConv3d(z_dim, dims[0], 3, padding=1)
        self.middle = nn.Sequential(ResidualBlock(dims[0], dims[0]),
                                    AttentionBlock(dims[0]),
                                    ResidualBlock(dims[0], dims[0]))
        up = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            if i in (1, 2, 3):
                cin = cin // 2
            for _ in range(num_res_blocks + 1):
                up.append(ResidualBlock(cin, cout))
                cin = cout
            if i != len(dim_mult) - 1:
                up.append(Resample(cout, "upsample3d" if temporal_up[i]
                                   else "upsample2d"))
        self.upsamples = nn.Sequential(*up)
        self.head = nn.Sequential(RMSNorm(cout, images=False), nn.SiLU(),
                                  CausalConv3d(cout, 3, 3, padding=1))

    def forward(self, x, cache: _Cache):
        x = cache.conv(self.conv1, x)
        x = _run(self.middle, x, cache)
        x = _run(self.upsamples, x, cache)
        return cache.conv(self.head[2], _norm_silu(self.head[0], x))


class WanVAE(nn.Module):
    """WanVAE_ at `cfg`'s widths; `encode` / `decode` take and give
    normalised latents."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        z = cfg.vae_z_dim
        down = tuple(cfg.vae_temporal_downsample)
        self.z_dim = z
        self.latent_stats = (cfg.vae_mean, cfg.vae_std)
        self.encoder = Encoder3d(cfg.vae_dim, z * 2, cfg.vae_dim_mult,
                                 cfg.vae_num_res_blocks, down)
        self.conv1 = CausalConv3d(z * 2, z * 2, 1)
        self.conv2 = CausalConv3d(z, z, 1)
        self.decoder = Decoder3d(cfg.vae_dim, z, cfg.vae_dim_mult,
                                 cfg.vae_num_res_blocks, down[::-1])

    def cast_for_inference(self, dtype: torch.dtype) -> "WanVAE":
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                m.to(dtype)
        return self

    def _stats(self):
        dev = self.conv1.weight.device
        return tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                     .view(1, -1, 1, 1, 1) for v in self.latent_stats)

    def encode(self, x):
        """(B, 3, 4k+1, H, W) in [-1, 1] -> (B, z, k+1, H/8, W/8) f32
        normalised latents."""
        dt = self.conv1.weight.dtype
        x = x.to(dt)
        cache, outs = _Cache(), []
        for i in range(1 + (x.shape[2] - 1) // 4):
            cache.start_chunk()
            chunk = x[:, :, :1] if i == 0 else x[:, :, 1 + 4 * (i - 1):
                                                  1 + 4 * i]
            outs.append(self.encoder(chunk, cache))
        mu = self.conv1(torch.cat(outs, 2))[:, :self.z_dim].float()
        mean, std = self._stats()
        return (mu - mean) * (1.0 / std)

    def decode(self, z):
        """(B, z, k+1, h, w) normalised latents -> (B, 3, 4k+1, 8h, 8w) f32
        in [-1, 1]."""
        mean, std = self._stats()
        z = z.float() / (1.0 / std) + mean
        x = self.conv2(z.to(self.conv2.weight.dtype))
        cache, outs = _Cache(), []
        for i in range(x.shape[2]):
            cache.start_chunk()
            outs.append(self.decoder(x[:, :, i:i + 1], cache).float())
        return torch.cat(outs, 2).clamp_(-1, 1)
