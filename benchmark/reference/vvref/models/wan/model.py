"""Wan2.1-VACE as a video remover, plain float32: the frozen copy of the
repository's plain reference (`tests/oracles_wan.py`), written from the
published description (github.com/Wan-Video/Wan2.1: `wan/modules/model.py`,
`vace_model.py`, `vae.py`, `wan/utils/fm_solvers_unipc.py`, `wan/vace.py`):
the DiT with its VACE context blocks, the causal Wan-VAE with its chunked
feature cache, the flow-matching UniPC sampler and the masked
video-to-video task. Modules keep Wan's state-dict keys. Every attention
call goes through `benchmark.reference.vvref.ops.attention` (f32, in query
chunks; the benchmark's counter records it there). It imports nothing of
the port.

Departures from the published code, none of which changes the
mathematics: attention in f32 for flash attention in bf16; one sample a
call; RoPE in f64 as Wan does, the rest in f32 where Wan's autocast runs
bf16; the umT5 embeddings are inputs; the masked pixels are set to 0
(mid-grey) before the split into frames * (1 - m) and frames * m, as
VACE's inpainting preprocessing does; the sampler keeps what order 2,
bh2, flow prediction and the zero final sigma use.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.vvref.ops.attention import attention

CACHE_T = 2


# ---------------------------------------------------------------------------
# the DiT (wan/modules/model.py, vace_model.py)
# ---------------------------------------------------------------------------
def sinusoidal_embedding_1d(dim, position):
    half = dim // 2
    position = position.type(torch.float64)
    sinusoid = torch.outer(position, torch.pow(
        10000, -torch.arange(half).to(position).div(half)))
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_params(max_seq_len, dim, theta=10000):
    freqs = torch.outer(torch.arange(max_seq_len), 1.0 / torch.pow(
        theta, torch.arange(0, dim, 2).to(torch.float64).div(dim)))
    return torch.polar(torch.ones_like(freqs), freqs)


def rope_apply(x, grid, freqs):
    """x: (S, n, d) of one sample on the (f, h, w) grid."""
    n, c = x.size(1), x.size(2) // 2
    freqs = freqs.split([c - 2 * (c // 3), c // 3, c // 3], dim=1)
    f, h, w = grid
    seq_len = f * h * w
    x_c = torch.view_as_complex(x.to(torch.float64).reshape(seq_len, n, -1,
                                                             2))
    freqs_i = torch.cat([
        freqs[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
        freqs[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
        freqs[2][:w].view(1, 1, w, -1).expand(f, h, w, -1)],
        dim=-1).reshape(seq_len, 1, -1).to(x.device)
    return torch.view_as_real(x_c * freqs_i).flatten(2).float()


class WanRMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight


class WanLayerNorm(nn.LayerNorm):
    def __init__(self, dim, eps=1e-6, elementwise_affine=False):
        super().__init__(dim, elementwise_affine=elementwise_affine, eps=eps)


class WanSelfAttention(nn.Module):
    def __init__(self, dim, num_heads, eps=1e-6):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = WanRMSNorm(dim, eps=eps)
        self.norm_k = WanRMSNorm(dim, eps=eps)

    def forward(self, x, grid, freqs):
        s, n, d = x.shape[0], self.num_heads, self.head_dim
        q = rope_apply(self.norm_q(self.q(x)).view(s, n, d), grid, freqs)
        k = rope_apply(self.norm_k(self.k(x)).view(s, n, d), grid, freqs)
        v = self.v(x).view(s, n, d)
        out = attention(*(t.transpose(0, 1)[None] for t in (q, k, v)))
        return self.o(out[0].transpose(0, 1).reshape(s, n * d))


class WanCrossAttention(WanSelfAttention):
    def forward(self, x, context):
        n, d = self.num_heads, self.head_dim
        q = self.norm_q(self.q(x)).view(-1, n, d)
        k = self.norm_k(self.k(context)).view(-1, n, d)
        v = self.v(context).view(-1, n, d)
        out = attention(*(t.transpose(0, 1)[None] for t in (q, k, v)))
        return self.o(out[0].transpose(0, 1).reshape(-1, n * d))


class WanAttentionBlock(nn.Module):
    def __init__(self, dim, ffn_dim, num_heads, eps=1e-6):
        super().__init__()
        self.norm1 = WanLayerNorm(dim, eps)
        self.self_attn = WanSelfAttention(dim, num_heads, eps)
        self.norm3 = WanLayerNorm(dim, eps, elementwise_affine=True)
        self.cross_attn = WanCrossAttention(dim, num_heads, eps)
        self.norm2 = WanLayerNorm(dim, eps)
        self.ffn = nn.Sequential(nn.Linear(dim, ffn_dim),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(ffn_dim, dim))
        self.modulation = nn.Parameter(torch.randn(1, 6, dim) / dim ** 0.5)

    def forward(self, x, e, grid, freqs, context):
        e = (self.modulation[0] + e).chunk(6, dim=0)
        y = self.self_attn(self.norm1(x) * (1 + e[1]) + e[0], grid, freqs)
        x = x + y * e[2]
        x = x + self.cross_attn(self.norm3(x), context)
        y = self.ffn(self.norm2(x) * (1 + e[4]) + e[3])
        return x + y * e[5]


class VaceWanAttentionBlock(WanAttentionBlock):
    def __init__(self, dim, ffn_dim, num_heads, eps, block_id):
        super().__init__(dim, ffn_dim, num_heads, eps)
        self.block_id = block_id
        if block_id == 0:
            self.before_proj = nn.Linear(dim, dim)
        self.after_proj = nn.Linear(dim, dim)

    def forward(self, c, x, **kwargs):
        if self.block_id == 0:
            c = self.before_proj(c) + x
        c = super().forward(c, **kwargs)
        return c, self.after_proj(c)


class Head(nn.Module):
    def __init__(self, dim, out_dim, patch_size, eps=1e-6):
        super().__init__()
        self.norm = WanLayerNorm(dim, eps)
        self.head = nn.Linear(dim, math.prod(patch_size) * out_dim)
        self.modulation = nn.Parameter(torch.randn(1, 2, dim) / dim ** 0.5)

    def forward(self, x, e):
        e = (self.modulation[0] + e).chunk(2, dim=0)
        return self.head(self.norm(x) * (1 + e[1]) + e[0])


class VaceWanModel(nn.Module):
    """VaceWanModel(model_type='vace') at the given widths."""

    def __init__(self, dim, ffn_dim, freq_dim, num_heads, num_layers,
                 text_dim, text_len, vace_layers, vace_in_dim, in_dim=16,
                 out_dim=16, patch_size=(1, 2, 2), eps=1e-6):
        super().__init__()
        self.dim, self.freq_dim, self.text_len = dim, freq_dim, text_len
        self.out_dim, self.patch_size = out_dim, patch_size
        self.patch_embedding = nn.Conv3d(in_dim, dim, patch_size,
                                         stride=patch_size)
        self.text_embedding = nn.Sequential(
            nn.Linear(text_dim, dim), nn.GELU(approximate="tanh"),
            nn.Linear(dim, dim))
        self.time_embedding = nn.Sequential(
            nn.Linear(freq_dim, dim), nn.SiLU(), nn.Linear(dim, dim))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(dim, dim * 6))
        self.blocks = nn.ModuleList(
            WanAttentionBlock(dim, ffn_dim, num_heads, eps)
            for _ in range(num_layers))
        self.head = Head(dim, out_dim, patch_size, eps)
        d = dim // num_heads
        self.freqs = torch.cat([rope_params(1024, d - 4 * (d // 6)),
                                rope_params(1024, 2 * (d // 6)),
                                rope_params(1024, 2 * (d // 6))], dim=1)
        self.vace_layers = list(vace_layers)
        self.vace_layers_mapping = {i: n for n, i in
                                    enumerate(self.vace_layers)}
        self.vace_blocks = nn.ModuleList(
            VaceWanAttentionBlock(dim, ffn_dim, num_heads, eps, block_id=i)
            for i in self.vace_layers)
        self.vace_patch_embedding = nn.Conv3d(vace_in_dim, dim, patch_size,
                                              stride=patch_size)

    def forward(self, x, t, vace_context, context, context_scale=1.0):
        """x (in_dim, f, H, W), t a scalar tensor, vace_context
        (vace_in_dim, f, H, W), context (L, text_dim) -> (out_dim, f, H,
        W)."""
        u = self.patch_embedding(x[None])
        grid = tuple(u.shape[2:])
        x = u.flatten(2).transpose(1, 2)[0]
        e = self.time_embedding(sinusoidal_embedding_1d(
            self.freq_dim, t.reshape(1)).float())[0]
        e0 = self.time_projection(e).unflatten(0, (6, self.dim))
        context = self.text_embedding(torch.cat([
            context, context.new_zeros(self.text_len - context.shape[0],
                                       context.shape[1])]))
        kw = dict(e=e0, grid=grid, freqs=self.freqs, context=context)
        c = self.vace_patch_embedding(vace_context[None]).flatten(2) \
            .transpose(1, 2)[0]
        hints = []
        for block in self.vace_blocks:
            c, hint = block(c, x, **kw)
            hints.append(hint)
        for i, block in enumerate(self.blocks):
            x = block(x, **kw)
            if i in self.vace_layers_mapping:
                x = x + hints[self.vace_layers_mapping[i]] * context_scale
        x = self.head(x, e)
        f, h, w = grid
        c = self.out_dim
        u = x.view(f, h, w, *self.patch_size, c)
        u = torch.einsum("fhwpqrc->cfphqwr", u)
        return u.reshape(c, *[i * j for i, j in zip(grid, self.patch_size)])


# ---------------------------------------------------------------------------
# the Wan-VAE (wan/modules/vae.py)
# ---------------------------------------------------------------------------
class CausalConv3d(nn.Conv3d):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._padding = (self.padding[2], self.padding[2], self.padding[1],
                         self.padding[1], 2 * self.padding[0], 0)
        self.padding = (0, 0, 0)

    def forward(self, x, cache_x=None):
        padding = list(self._padding)
        if cache_x is not None and self._padding[4] > 0:
            x = torch.cat([cache_x, x], dim=2)
            padding[4] -= cache_x.shape[2]
        return super().forward(F.pad(x, padding))


class RMS_norm(nn.Module):
    def __init__(self, dim, channel_first=True, images=True):
        super().__init__()
        shape = (dim, *((1, 1) if images else (1, 1, 1)))
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(shape))
        self.bias = 0.0

    def forward(self, x):
        return F.normalize(x, dim=1) * self.scale * self.gamma + self.bias


class Resample(nn.Module):
    def __init__(self, dim, mode):
        super().__init__()
        self.mode = mode
        if mode in ("upsample2d", "upsample3d"):
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
                                              stride=(2, 1, 1),
                                              padding=(0, 0, 0))

    def forward(self, x, feat_cache=None, feat_idx=(0,)):
        b, c, t, h, w = x.size()
        if self.mode == "upsample3d" and feat_cache is not None:
            idx = feat_idx[0]
            if feat_cache[idx] is None:
                feat_cache[idx] = "Rep"
                feat_idx[0] += 1
            else:
                cache_x = x[:, :, -CACHE_T:].clone()
                rep = isinstance(feat_cache[idx], str)
                if cache_x.shape[2] < 2 and not rep:
                    cache_x = torch.cat([feat_cache[idx][:, :, -1:],
                                         cache_x], dim=2)
                if cache_x.shape[2] < 2 and rep:
                    cache_x = torch.cat([torch.zeros_like(cache_x),
                                         cache_x], dim=2)
                x = self.time_conv(x) if rep \
                    else self.time_conv(x, feat_cache[idx])
                feat_cache[idx] = cache_x
                feat_idx[0] += 1
                x = x.reshape(b, 2, c, t, h, w)
                x = torch.stack((x[:, 0], x[:, 1]), 3).reshape(
                    b, c, t * 2, h, w)
        t = x.shape[2]
        x = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        x = self.resample(x)
        x = x.reshape(b, t, *x.shape[1:]).permute(0, 2, 1, 3, 4)
        if self.mode == "downsample3d" and feat_cache is not None:
            idx = feat_idx[0]
            if feat_cache[idx] is None:
                feat_cache[idx] = x.clone()
                feat_idx[0] += 1
            else:
                cache_x = x[:, :, -1:].clone()
                x = self.time_conv(torch.cat([feat_cache[idx][:, :, -1:], x],
                                             2))
                feat_cache[idx] = cache_x
                feat_idx[0] += 1
        return x


def _cached(layer, x, feat_cache, feat_idx):
    idx = feat_idx[0]
    cache_x = x[:, :, -CACHE_T:].clone()
    if cache_x.shape[2] < 2 and feat_cache[idx] is not None:
        cache_x = torch.cat([feat_cache[idx][:, :, -1:], cache_x], dim=2)
    x = layer(x, feat_cache[idx])
    feat_cache[idx] = cache_x
    feat_idx[0] += 1
    return x


class ResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.residual = nn.Sequential(
            RMS_norm(in_dim, images=False), nn.SiLU(),
            CausalConv3d(in_dim, out_dim, 3, padding=1),
            RMS_norm(out_dim, images=False), nn.SiLU(), nn.Dropout(0.0),
            CausalConv3d(out_dim, out_dim, 3, padding=1))
        self.shortcut = CausalConv3d(in_dim, out_dim, 1) \
            if in_dim != out_dim else nn.Identity()

    def forward(self, x, feat_cache=None, feat_idx=(0,)):
        h = self.shortcut(x)
        for layer in self.residual:
            if isinstance(layer, CausalConv3d) and feat_cache is not None:
                x = _cached(layer, x, feat_cache, feat_idx)
            else:
                x = layer(x)
        return x + h


class AttentionBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = RMS_norm(dim)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        identity = x
        b, c, t, h, w = x.size()
        x = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
        x = self.norm(x)
        q, k, v = self.to_qkv(x).reshape(b * t, 1, c * 3, -1).permute(
            0, 1, 3, 2).contiguous().chunk(3, dim=-1)
        x = attention(q, k, v)
        x = x.squeeze(1).permute(0, 2, 1).reshape(b * t, c, h, w)
        x = self.proj(x)
        x = x.reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4)
        return x + identity


def _run(layers, x, feat_cache, feat_idx):
    for layer in layers:
        if isinstance(layer, (ResidualBlock, Resample)):
            x = layer(x, feat_cache, feat_idx)
        elif isinstance(layer, CausalConv3d):
            x = _cached(layer, x, feat_cache, feat_idx)
        else:
            x = layer(x)
    return x


class Encoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks,
                 temperal_downsample):
        super().__init__()
        dims = [dim * u for u in [1] + list(dim_mult)]
        self.conv1 = CausalConv3d(3, dims[0], 3, padding=1)
        downsamples = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(num_res_blocks):
                downsamples.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                downsamples.append(Resample(
                    out_dim, "downsample3d" if temperal_downsample[i]
                    else "downsample2d"))
        self.downsamples = nn.Sequential(*downsamples)
        self.middle = nn.Sequential(ResidualBlock(out_dim, out_dim),
                                    AttentionBlock(out_dim),
                                    ResidualBlock(out_dim, out_dim))
        self.head = nn.Sequential(RMS_norm(out_dim, images=False), nn.SiLU(),
                                  CausalConv3d(out_dim, z_dim, 3, padding=1))

    def forward(self, x, feat_cache, feat_idx):
        x = _cached(self.conv1, x, feat_cache, feat_idx)
        x = _run(self.downsamples, x, feat_cache, feat_idx)
        x = _run(self.middle, x, feat_cache, feat_idx)
        return _run(self.head, x, feat_cache, feat_idx)


class Decoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks,
                 temperal_upsample):
        super().__init__()
        dims = [dim * u for u in [dim_mult[-1]] + list(dim_mult)[::-1]]
        self.conv1 = CausalConv3d(z_dim, dims[0], 3, padding=1)
        self.middle = nn.Sequential(ResidualBlock(dims[0], dims[0]),
                                    AttentionBlock(dims[0]),
                                    ResidualBlock(dims[0], dims[0]))
        upsamples = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i in (1, 2, 3):
                in_dim = in_dim // 2
            for _ in range(num_res_blocks + 1):
                upsamples.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                upsamples.append(Resample(
                    out_dim, "upsample3d" if temperal_upsample[i]
                    else "upsample2d"))
        self.upsamples = nn.Sequential(*upsamples)
        self.head = nn.Sequential(RMS_norm(out_dim, images=False), nn.SiLU(),
                                  CausalConv3d(out_dim, 3, 3, padding=1))

    def forward(self, x, feat_cache, feat_idx):
        x = _cached(self.conv1, x, feat_cache, feat_idx)
        x = _run(self.middle, x, feat_cache, feat_idx)
        x = _run(self.upsamples, x, feat_cache, feat_idx)
        return _run(self.head, x, feat_cache, feat_idx)


def count_conv3d(model):
    return sum(isinstance(m, CausalConv3d) for m in model.modules())


class WanVAE_(nn.Module):
    def __init__(self, dim=96, z_dim=16, dim_mult=(1, 2, 4, 4),
                 num_res_blocks=2, temperal_downsample=(False, True, True),
                 mean=None, std=None):
        super().__init__()
        self.z_dim = z_dim
        self.encoder = Encoder3d(dim, z_dim * 2, dim_mult, num_res_blocks,
                                 temperal_downsample)
        self.conv1 = CausalConv3d(z_dim * 2, z_dim * 2, 1)
        self.conv2 = CausalConv3d(z_dim, z_dim, 1)
        self.decoder = Decoder3d(dim, z_dim, dim_mult, num_res_blocks,
                                 list(temperal_downsample)[::-1])
        self.latent_stats = (mean, std)

    def _scale(self, device):
        mean, std = (torch.tensor(v, dtype=torch.float32, device=device)
                     .view(1, self.z_dim, 1, 1, 1) for v in self.latent_stats)
        return mean, 1.0 / std

    def encode(self, x):
        cache = [None] * count_conv3d(self.encoder)
        outs = []
        for i in range(1 + (x.shape[2] - 1) // 4):
            chunk = x[:, :, :1] if i == 0 else x[:, :, 1 + 4 * (i - 1):
                                                  1 + 4 * i]
            outs.append(self.encoder(chunk, cache, [0]))
        mu, _ = self.conv1(torch.cat(outs, 2)).chunk(2, dim=1)
        mean, inv_std = self._scale(x.device)
        return (mu - mean) * inv_std

    def decode(self, z):
        mean, inv_std = self._scale(z.device)
        z = z / inv_std + mean
        x = self.conv2(z)
        cache = [None] * count_conv3d(self.decoder)
        outs = [self.decoder(x[:, :, i:i + 1], cache, [0])
                for i in range(x.shape[2])]
        return torch.cat(outs, 2).clamp_(-1, 1)


# ---------------------------------------------------------------------------
# the sampler (wan/utils/fm_solvers_unipc.py, order 2, bh2)
# ---------------------------------------------------------------------------
class FlowUniPCMultistepScheduler:
    def __init__(self, num_train_timesteps=1000, solver_order=2):
        alphas = np.linspace(1, 1 / num_train_timesteps,
                             num_train_timesteps)[::-1].copy()
        sigmas = torch.from_numpy(1.0 - alphas).to(dtype=torch.float32)
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.sigma_min = sigmas[-1].item()
        self.sigma_max = sigmas[0].item()

    def set_timesteps(self, num_inference_steps, shift):
        sigmas = np.linspace(self.sigma_max, self.sigma_min,
                             num_inference_steps + 1).copy()[:-1]
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        timesteps = sigmas * self.num_train_timesteps
        sigmas = np.concatenate([sigmas, [0]]).astype(np.float32)
        self.sigmas = torch.from_numpy(sigmas)
        self.timesteps = torch.from_numpy(timesteps).to(dtype=torch.int64)
        self.model_outputs = [None] * self.solver_order
        self.lower_order_nums = 0
        self.last_sample = None
        self.step_index = 0
        self.this_order = None

    @staticmethod
    def _alpha_sigma(sigma):
        return 1 - sigma, sigma

    def _lambda(self, i):
        alpha, sigma = self._alpha_sigma(self.sigmas[i])
        return torch.log(alpha) - torch.log(sigma)

    def _terms(self, order, i_t, i_s0):
        h = self._lambda(i_t) - self._lambda(i_s0)
        m0 = self.model_outputs[-1]
        rks, D1s = [], []
        for i in range(1, order):
            mi = self.model_outputs[-(i + 1)]
            rk = (self._lambda(i_s0 - i) - self._lambda(i_s0)) / h
            rks.append(rk)
            D1s.append((mi - m0) / rk)
        rks.append(1.0)
        rks = torch.tensor(rks)
        hh = -h
        h_phi_1 = torch.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        factorial_i = 1
        B_h = torch.expm1(hh)
        R, b = [], []
        for i in range(1, order + 1):
            R.append(torch.pow(rks, i - 1))
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return h_phi_1, B_h, torch.stack(R), torch.tensor(b), D1s

    def _uni_p(self, x, order):
        i = self.step_index
        alpha_t, sigma_t = self._alpha_sigma(self.sigmas[i + 1])
        _, sigma_s0 = self._alpha_sigma(self.sigmas[i])
        h_phi_1, B_h, _, _, D1s = self._terms(order, i + 1, i)
        m0 = self.model_outputs[-1]
        x_t_ = sigma_t / sigma_s0 * x - alpha_t * h_phi_1 * m0
        if D1s:
            rhos_p = torch.tensor([0.5])
            pred_res = rhos_p[0] * D1s[0]
            return x_t_ - alpha_t * B_h * pred_res
        return x_t_ - alpha_t * B_h * 0

    def _uni_c(self, model_t, x, order):
        i = self.step_index
        alpha_t, sigma_t = self._alpha_sigma(self.sigmas[i])
        _, sigma_s0 = self._alpha_sigma(self.sigmas[i - 1])
        h_phi_1, B_h, R, b, D1s = self._terms(order, i, i - 1)
        rhos_c = torch.tensor([0.5]) if order == 1 \
            else torch.linalg.solve(R, b)
        m0 = self.model_outputs[-1]
        x_t_ = sigma_t / sigma_s0 * x - alpha_t * h_phi_1 * m0
        corr_res = rhos_c[0] * D1s[0] if D1s else 0
        D1_t = model_t - m0
        return x_t_ - alpha_t * B_h * (corr_res + rhos_c[-1] * D1_t)

    def step(self, model_output, sample):
        x0_pred = sample - self.sigmas[self.step_index] * model_output
        if self.step_index > 0 and self.last_sample is not None:
            sample = self._uni_c(x0_pred, self.last_sample, self.this_order)
        self.model_outputs = self.model_outputs[1:] + [x0_pred]
        this_order = min(self.solver_order,
                         len(self.timesteps) - self.step_index)
        self.this_order = min(this_order, self.lower_order_nums + 1)
        self.last_sample = sample
        prev_sample = self._uni_p(sample, self.this_order)
        self.lower_order_nums = min(self.lower_order_nums + 1,
                                    self.solver_order)
        self.step_index += 1
        return prev_sample


# ---------------------------------------------------------------------------
# the masked video-to-video task (wan/vace.py)
# ---------------------------------------------------------------------------
def build(cfg: dict, state: dict | None = None, device="cpu"):
    """(VaceWanModel, WanVAE_) at `cfg`'s widths (the fields of the
    port's WanConfig as a dict), with `state` = {"dit", "vae"} loaded, on
    `device` (None: where they were built)."""
    dit = VaceWanModel(cfg["dim"], cfg["ffn_dim"], cfg["freq_dim"],
                       cfg["num_heads"], cfg["num_layers"], cfg["text_dim"],
                       cfg["text_len"], cfg["vace_layers"],
                       cfg["vace_in_dim"], cfg["in_dim"], cfg["out_dim"],
                       tuple(cfg["patch_size"]), cfg["eps"])
    vae = WanVAE_(cfg["vae_dim"], cfg["vae_z_dim"], tuple(cfg["vae_dim_mult"]),
                  cfg["vae_num_res_blocks"],
                  tuple(cfg["vae_temporal_downsample"]), cfg["vae_mean"],
                  cfg["vae_std"])
    if state is not None:
        dit.load_state_dict({k: v.float() for k, v in state["dit"].items()})
        vae.load_state_dict({k: v.float() for k, v in state["vae"].items()})
    if device is not None:
        dit, vae = dit.to(device), vae.to(device)
        dit.freqs = dit.freqs.to(device)
    return dit.eval(), vae.eval()


def resize_bilinear(img, out_h, out_w):
    """cv2.INTER_LINEAR of (T, H, W, C): half-pixel centres, taps clamped
    at the border; f32."""
    def taps(n_in, n_out):
        f = (torch.arange(n_out, dtype=torch.float64) + 0.5) \
            * (n_in / n_out) - 0.5
        f0 = torch.floor(f)
        w = torch.where(f0 < 0, 0.0, torch.where(f0 > n_in - 2, 1.0, f - f0))
        i0 = f0.long().clamp(0, n_in - 2)
        return i0, i0 + 1, w.float()
    x = img.float()
    y0, y1, wy = taps(x.shape[1], out_h)
    x0, x1, wx = taps(x.shape[2], out_w)
    wy, wx = wy.to(x.device)[:, None, None], wx.to(x.device)[:, None]
    top = x[:, y0] * (1 - wy) + x[:, y1] * wy
    return top[:, :, x0] * (1 - wx) + top[:, :, x1] * wx


def inpaint(dit, vae, frames, masks, cfg: dict, context, context_null,
            size: tuple, catch=None):
    """The remover: frames (T, H, W, 3) uint8 and masks (T, H, W) (nonzero
    = hole) -> (T, h, w, 3) f32 in [0, 255] at `size` = (h, w). The
    frames are resized (bilinear, rounded to uint8) and the masks
    (nearest) to `size`, padded to 4k+1 frames by repeating the last;
    `catch` (optional) gets the final latents."""
    h, w = size
    T, H, W = masks.shape
    t4 = 4 * math.ceil((T - 1) / 4) + 1
    idx = torch.arange(t4).clamp(max=T - 1)
    fr = resize_bilinear(frames[idx], h, w).round().clamp(0, 255)
    ys = torch.floor(torch.arange(h, dtype=torch.float64) * (H / h)).long()
    xs = torch.floor(torch.arange(w, dtype=torch.float64) * (W / w)).long()
    m = (masks[idx][:, ys][:, :, xs] > 0).float()
    video = (fr / 127.5 - 1.0).permute(3, 0, 1, 2)       # (3, T, h, w)
    mask = m[None]                                        # (1, T, h, w)
    video = video * (1 - mask)                            # grey under m
    with torch.no_grad():
        inactive = video * (1 - mask)
        reactive = video * mask
        z0 = torch.cat([vae.encode(inactive[None])[0],
                        vae.encode(reactive[None])[0]], dim=0)
        f = z0.shape[1]
        # vace_encode_masks
        mm = mask[0].view(t4, h // 8, 8, w // 8, 8).permute(2, 4, 0, 1, 3) \
            .reshape(64, t4, h // 8, w // 8)
        mm = F.interpolate(mm[None], size=(f, h // 8, w // 8),
                           mode="nearest-exact")[0]
        z = torch.cat([z0, mm])
        noise = torch.randn((cfg["vae_z_dim"], f, h // 8, w // 8),
                            generator=torch.Generator().manual_seed(0)) \
            .to(z.device)
        sched = FlowUniPCMultistepScheduler()
        sched.set_timesteps(cfg["sample_steps"], cfg["sample_shift"])
        latents = noise
        for t in sched.timesteps:
            tt = t.to(z.device)
            cond = dit(latents, tt, z, context)
            uncond = dit(latents, tt, z, context_null)
            pred = uncond + cfg["guide_scale"] * (cond - uncond)
            latents = sched.step(pred[None], latents[None])[0]
        if catch is not None:
            catch(latents)
        video = vae.decode(latents[None])[0]
    return (video[:, :T].permute(1, 2, 3, 0) + 1.0) * 127.5
