"""AutoencoderKL (SD VAE, sd-vae-ft-mse architecture), PyTorch, NCHW.

Port of videovanish_tpu/models/diffueraser/vae.py with diffusers key names.
The mid-block attention is one 512-wide head over every latent pixel: on
the card it runs the flash_attn_fwd kernel's D = 512 instance.
"""
from __future__ import annotations

import torch.nn as nn

from benchmark.reference.vvref.standins import rename_legacy_vae_keys
from benchmark.reference.vvref.models.diffueraser.blocks import (
    Attention, Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D,
)


class VAEAttention(Attention):
    """Single-head spatial self-attention of the VAE mid block, with its
    GroupNorm and the residual."""

    def __init__(self, channels: int):
        super().__init__(channels, heads=1, head_dim=channels, use_bias=True)
        self.group_norm = GroupNorm(channels, 32, 1e-6)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = super().forward(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels),
                                      ResnetBlock2D(channels, channels)])
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Stage(nn.Module):
    """One encoder down block or decoder up block (diffusers naming)."""

    def __init__(self, in_ch, out_ch, n_resnets, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch)
            for j in range(n_resnets)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([
                Downsample2D(out_ch, asymmetric_pad=True)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])


class Encoder(nn.Module):
    def __init__(self, block_out_channels=(128, 256, 512, 512),
                 layers_per_block=2, latent_channels=4):
        super().__init__()
        ch = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Stage(ch[max(i - 1, 0)], c, layers_per_block,
                   "down" if i < len(ch) - 1 else None)
            for i, c in enumerate(ch)])
        self.mid_block = MidBlock(ch[-1])
        self.conv_norm_out = GroupNorm(ch[-1], 32, 1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, block_out_channels=(128, 256, 512, 512),
                 layers_per_block=2, latent_channels=4):
        super().__init__()
        rev = tuple(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], c, layers_per_block + 1,
                   "up" if i < len(rev) - 1 else None)
            for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], 32, 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """SD VAE. encode() returns the mean of the latent distribution;
    decode() maps latents to [-1, 1] RGB. The latent scaling factor is the
    caller's. State dicts with the pre-0.18 diffusers attention names of
    the published sd-vae-ft-mse file (query/key/value/proj_attn) load as
    they are: a load hook renames them (convert.rename_legacy_vae_keys)."""

    def __init__(self, block_out_channels=(128, 256, 512, 512),
                 layers_per_block=2, latent_channels=4):
        super().__init__()
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.decoder = Decoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels,
                                    2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self._register_load_state_dict_pre_hook(self._rename_legacy)

    @staticmethod
    def _rename_legacy(state_dict, prefix, *_):
        renamed = rename_legacy_vae_keys(
            {k[len(prefix):]: state_dict.pop(k) for k in list(state_dict)
             if k.startswith(prefix)})
        state_dict.update({prefix + k: v for k, v in renamed.items()})

    def encode(self, x):
        mean, _logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        return self.decode(self.encode(x))
