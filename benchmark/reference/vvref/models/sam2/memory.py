"""SAM2's memory attention and memory encoder, PyTorch, channel-last.

Port of videovanish_tpu/models/sam2/memory.py with the checkpoint's names
(`memory_attention.*`, `memory_encoder.*`). The memory bank is a fixed set
of slots (num_maskmem spatial slots, then the object-pointer tokens) with a
validity mask, so every frame has the same shapes:

  - memory attention: pre-LN layers of RoPE self-attention (one 256-wide
    head over the 64x64 tokens: the flash kernel's D = 256 instance),
    RoPE cross-attention to the memory (keys and values projected 64 ->
    256; invalid slots masked, so it takes the plain path with the finite
    -1e30 fill: a bank with no valid key gives a uniform softmax, which the
    predictor discards), and a ReLU MLP. Pointer tokens get zero rotation
    angles;
  - memory encoder: the image-resolution mask downsampled 16x by four
    stride-2 conv + LayerNorm + GELU layers and a 1x1 conv, added to the
    projected stride-16 features, fused by two ConvNeXt blocks, projected
    to mem_dim.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.vvref.models.sam2.hiera import gelu_tanh, layer_norm_f32
from benchmark.reference.vvref.ops.attention import attention
from benchmark.reference.vvref.ops.rope import apply_rope, axial_rope_tables


class RoPEAttention(nn.Module):
    """q/k/v/out projections at the full internal width, rotary embedding
    on q and k."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 1,
                 kv_in_dim: int = 0):
        super().__init__()
        kv = kv_in_dim or embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(kv, embed_dim)
        self.v_proj = nn.Linear(kv, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, rope_q=None, rope_k=None, key_valid=None):
        B, Sq, C = q.shape
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(B, -1, self.num_heads, hd).permute(0, 2, 1, 3)

        qh = heads(self.q_proj(q))
        kh = heads(self.k_proj(k))
        vh = heads(self.v_proj(v))
        if rope_q is not None:
            qh = apply_rope(qh, *rope_q)
        if rope_k is not None:
            kh = apply_rope(kh, *rope_k)
        out = attention(qh, kh, vh, key_mask=key_valid)
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(B, Sq, C))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, d_model: int = 256, kv_dim: int = 64,
                 mlp_dim: int = 2048):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, 1)
        self.cross_attn_image = RoPEAttention(d_model, 1, kv_in_dim=kv_dim)
        self.linear1 = nn.Linear(d_model, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, mem_kv, mem_pos, mem_valid, rope_self=None,
                rope_mem=None):
        h = layer_norm_f32(self.norm1, x)
        x = x + self.self_attn(h, h, h, rope_q=rope_self, rope_k=rope_self)
        h = layer_norm_f32(self.norm2, x)
        x = x + self.cross_attn_image(
            h, mem_kv + mem_pos.to(mem_kv.dtype), mem_kv, rope_q=rope_self,
            rope_k=rope_mem, key_valid=mem_valid)
        h = layer_norm_f32(self.norm3, x)
        return x + self.linear2(F.relu(self.linear1(h)))


@functools.lru_cache(maxsize=8)
def _rope_tables(S: int, M: int, head_dim: int, device: torch.device):
    """((sin, cos) over the S-token square grid, (sin, cos) over M memory
    tokens: the grid repeated M // S times, then zero-angle pointer
    tokens), f32 on `device`; None where the grid is not square."""
    side = int(round(S ** 0.5))
    if side * side != S or head_dim % 4:
        return None, None
    sin_s, cos_s = axial_rope_tables(side, side, head_dim)
    n_rep, rem = M // S, M - (M // S) * S
    sin_m = np.concatenate([np.tile(sin_s, (n_rep, 1)),
                            np.zeros((rem, head_dim // 2), np.float32)], 0)
    cos_m = np.concatenate([np.tile(cos_s, (n_rep, 1)),
                            np.ones((rem, head_dim // 2), np.float32)], 0)

    def dev(*a):
        return tuple(torch.from_numpy(t).to(device) for t in a)
    return dev(sin_s, cos_s), dev(sin_m, cos_m)


class MemoryAttention(nn.Module):
    def __init__(self, num_layers: int = 4, d_model: int = 256,
                 kv_dim: int = 64, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(d_model, kv_dim,
                                                         mlp_dim)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, x_pos, mem_kv, mem_pos, mem_valid):
        """x: (B, S, d_model) stride-16 tokens of the current frame; x_pos:
        (1|B, S, d_model) sine encoding (added once, scaled by 0.1);
        mem_kv / mem_pos: (B, M, kv_dim) memory tokens (spatial slots, then
        pointer tokens); mem_valid: (B, M) bool."""
        rope_self, rope_mem = _rope_tables(x.shape[1], mem_kv.shape[1],
                                           x.shape[2], x.device)
        x = x + 0.1 * x_pos.to(x.dtype)
        for layer in self.layers:
            x = layer(x, mem_kv, mem_pos, mem_valid, rope_self, rope_mem)
        return layer_norm_f32(self.norm, x)


class MaskDownSampler(nn.Module):
    """`encoder` indices as in the checkpoint: (conv, LayerNorm, GELU) x 4
    at 3i, 3i+1, 3i+2, then the final 1x1 conv at 12."""

    def __init__(self, d_model: int = 256):
        super().__init__()
        layers, ch = [], 1
        for _ in range(4):
            layers += [nn.Conv2d(ch, ch * 4, 3, stride=2, padding=1),
                       nn.LayerNorm(ch * 4, eps=1e-6),
                       nn.GELU(approximate="tanh")]
            ch *= 4
        layers.append(nn.Conv2d(ch, d_model, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, m):  # (B, S, S, 1) -> (B, S/16, S/16, d_model)
        enc = self.encoder
        x = m.permute(0, 3, 1, 2)
        for i in range(4):
            x = enc[3 * i](x)
            x = gelu_tanh(layer_norm_f32(enc[3 * i + 1], x.permute(0, 2, 3, 1)))
            x = x.permute(0, 3, 1, 2)
        final = enc[12]
        return F.linear(x.permute(0, 2, 3, 1), final.weight.flatten(1),
                        final.bias)


class CXBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7, LayerNorm, pointwise 4x, GELU,
    pointwise, layer scale `gamma`, residual."""

    def __init__(self, dim: int, intermediate: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate)
        self.pwconv2 = nn.Linear(intermediate, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):  # (B, H, W, C)
        h = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = layer_norm_f32(self.norm, h)
        h = self.pwconv2(gelu_tanh(self.pwconv1(h)))
        return x + h * self.gamma.to(h.dtype)


class MemoryEncoder(nn.Module):
    def __init__(self, d_model: int = 256, mem_dim: int = 64,
                 fuser_layers: int = 2, fuser_intermediate: int = 1024):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(d_model)
        self.pix_feat_proj = nn.Conv2d(d_model, d_model, 1)
        self.fuser = nn.Module()
        self.fuser.layers = nn.ModuleList(CXBlock(d_model, fuser_intermediate)
                                          for _ in range(fuser_layers))
        self.out_proj = nn.Conv2d(d_model, mem_dim, 1)

    def forward(self, pix_feat, mask_scaled):
        """pix_feat: (B, H, W, d_model) stride-16; mask_scaled: (B, 16H,
        16W, 1) image-resolution mask (already scaled and biased by the
        caller). Returns (B, H, W, mem_dim)."""
        m = self.mask_downsampler(mask_scaled.to(pix_feat.dtype))
        x = F.linear(pix_feat, self.pix_feat_proj.weight.flatten(1),
                     self.pix_feat_proj.bias) + m
        for layer in self.fuser.layers:
            x = layer(x)
        return F.linear(x, self.out_proj.weight.flatten(1), self.out_proj.bias)
