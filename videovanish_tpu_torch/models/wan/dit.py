"""Wan2.1's video diffusion transformer with VACE's context blocks
(`VaceWanModel` of github.com/Wan-Video/Wan2.1, `wan/modules/model.py` and
`vace_model.py`), PyTorch, with Wan's own state-dict keys (a published
file loads with `load_state_dict`).

A forward patchifies the latents (Conv3d (1, 2, 2)) into f*h*w tokens,
embeds the timestep (sinusoid, cos half first; Linear-SiLU-Linear, then
SiLU-Linear to six modulation vectors a block) and the text context
(Linear-GELU-Linear over the 512 zero-padded rows), runs the VACE blocks
on the context latents to get one hint per VACE block, and then the main
blocks, main block vace_layers[j] adding hint j. A block:

    m0..m5 = modulation + e0
    x += m2 * SA(LN(x) (1 + m1) + m0)      SA: RMS-normed q, k over the
                                            whole width, 3D RoPE, flash
    x += CA(LN_affine(x), ctx)             CA: RMS-normed q, k; 512 keys
    x += m5 * FFN(LN(x) (1 + m4) + m3)     FFN: Linear-GELU(tanh)-Linear

A VACE block is the same block: block 0 first sets c = before_proj(c) +
x; each then gives hint_j = after_proj(c). The head modulates LN(x) by
(h0, h1) = head.modulation + e and projects it to the patch's pixels.

Precision, as Wan runs under its autocast: on the card the linear and
convolution weights and matmuls are bf16; the residual streams, the
norms, the modulation, the time embedding, the head and RoPE are f32
(q and k are rounded to bf16 once, after the rotation, for the flash
kernel). On the CPU everything is f32. Attention goes through
`ops.attention.attention`: on the card self-attention is
`flash_attn_fwd[D=128,Sq=Sk=f*h*w]` and cross-attention
`flash_attn_fwd[D=128,Sk=512]`.

Each forward opens the range `wan.dit`, and the VACE blocks inside it
`wan.vace`.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from videovanish_tpu_torch.config import WanConfig
from videovanish_tpu_torch.ops.attention import attention
from videovanish_tpu_torch.ops.rope import apply_rope, wan_rope_tables
from videovanish_tpu_torch.utils.observability import trace_annotation


def sinusoidal_embedding(dim: int, t: torch.Tensor) -> torch.Tensor:
    """Wan's `sinusoidal_embedding_1d`: (N,) timesteps to (N, dim), the
    cos half first, computed in f64 and returned in f32."""
    half = dim // 2
    pos = t.to(torch.float64)
    freqs = torch.pow(10000.0, -torch.arange(
        half, dtype=torch.float64, device=t.device).div(half))
    s = torch.outer(pos, freqs)
    return torch.cat([torch.cos(s), torch.sin(s)], dim=1).float()


class RMSNorm(nn.Module):
    """WanRMSNorm: x / rms(x) * weight over the last axis, in f32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight.float()


class LayerNorm(nn.LayerNorm):
    """WanLayerNorm: LayerNorm in f32 (no affine unless asked)."""

    def __init__(self, dim: int, eps: float, elementwise_affine=False):
        super().__init__(dim, eps=eps, elementwise_affine=elementwise_affine)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            None if self.weight is None else
                            self.weight.float(),
                            None if self.bias is None else self.bias.float(),
                            self.eps)


class Attention(nn.Module):
    """WanSelfAttention / WanT2VCrossAttention: q, k, v, o projections,
    q and k RMS-normed over the whole width."""

    def __init__(self, dim: int, num_heads: int, eps: float):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = RMSNorm(dim, eps)
        self.norm_k = RMSNorm(dim, eps)

    def _heads(self, t, rope=None):
        """(B, S, dim) f32 -> (B, H, S, D) in the weights' dtype, rotated
        by `rope` = (sin, cos) first."""
        B, S, _ = t.shape
        t = t.view(B, S, self.num_heads, self.head_dim)
        if rope is not None:
            t = apply_rope(t, *rope)
        return t.to(self.q.weight.dtype).transpose(1, 2)

    def forward(self, x, context=None, rope=None):
        """Self-attention (context None, rotated by `rope`) or
        cross-attention to `context`; x and context in the weights'
        dtype."""
        src = x if context is None else context
        q = self._heads(self.norm_q(self.q(x)), rope)
        k = self._heads(self.norm_k(self.k(src)), rope)
        v = self._heads(self.v(src))
        out = attention(q, k, v)
        B, H, S, D = out.shape
        return self.o(out.transpose(1, 2).reshape(B, S, H * D))


class Block(nn.Module):
    """WanAttentionBlock (t2v cross-attention, cross_attn_norm)."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        dim = cfg.dim
        self.norm1 = LayerNorm(dim, cfg.eps)
        self.self_attn = Attention(dim, cfg.num_heads, cfg.eps)
        self.norm3 = LayerNorm(dim, cfg.eps, elementwise_affine=True)
        self.cross_attn = Attention(dim, cfg.num_heads, cfg.eps)
        self.norm2 = LayerNorm(dim, cfg.eps)
        self.ffn = nn.Sequential(nn.Linear(dim, cfg.ffn_dim),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(cfg.ffn_dim, dim))
        self.modulation = nn.Parameter(torch.randn(1, 6, dim) / dim ** 0.5)

    def forward(self, x, e0, context, rope):
        """x: (B, S, dim) f32, updated in place and returned; e0: (B, 6,
        dim) f32; context: (B, L, dim) in the weights' dtype."""
        dt = self.ffn[0].weight.dtype
        m = (self.modulation.float() + e0).unbind(1)
        m = [t[:, None] for t in m]
        h = torch.addcmul(m[0], self.norm1(x), 1 + m[1]).to(dt)
        x.addcmul_(self.self_attn(h, rope=rope), m[2])
        x += self.cross_attn(self.norm3(x).to(dt), context)
        h = torch.addcmul(m[3], self.norm2(x), 1 + m[4]).to(dt)
        x.addcmul_(self.ffn(h), m[5])
        return x


class VaceBlock(Block):
    """VaceWanAttentionBlock: block 0 adds before_proj(c) to x first; each
    gives after_proj(c) as its hint."""

    def __init__(self, cfg: WanConfig, block_id: int):
        super().__init__(cfg)
        self.block_id = block_id
        if block_id == 0:
            self.before_proj = nn.Linear(cfg.dim, cfg.dim)
        self.after_proj = nn.Linear(cfg.dim, cfg.dim)

    def forward(self, c, x, e0, context, rope):
        if self.block_id == 0:
            c = self.before_proj(c).float() + x
        c = super().forward(c, e0, context, rope)
        return c, self.after_proj(c.to(self.after_proj.weight.dtype))


class Head(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        out = cfg.out_dim * cfg.patch_size[0] * cfg.patch_size[1] \
            * cfg.patch_size[2]
        self.norm = LayerNorm(cfg.dim, cfg.eps)
        self.head = nn.Linear(cfg.dim, out)
        self.modulation = nn.Parameter(
            torch.randn(1, 2, cfg.dim) / cfg.dim ** 0.5)

    def forward(self, x, e):
        """In f32, as Wan's head runs under its f32 autocast."""
        h0, h1 = (self.modulation.float() + e[:, None]).unbind(1)
        y = torch.addcmul(h0[:, None], self.norm(x), 1 + h1[:, None])
        return F.linear(y, self.head.weight.float(), self.head.bias.float())


class WanDiT(nn.Module):
    """VaceWanModel ("vace", t2v cross-attention) at `cfg`'s widths."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.patch_embedding = nn.Conv3d(cfg.in_dim, dim, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.text_embedding = nn.Sequential(
            nn.Linear(cfg.text_dim, dim), nn.GELU(approximate="tanh"),
            nn.Linear(dim, dim))
        self.time_embedding = nn.Sequential(
            nn.Linear(cfg.freq_dim, dim), nn.SiLU(), nn.Linear(dim, dim))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(dim, dim * 6))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.head = Head(cfg)
        self.vace_blocks = nn.ModuleList(
            VaceBlock(cfg, i) for i in cfg.vace_layers)
        self.vace_patch_embedding = nn.Conv3d(
            cfg.vace_in_dim, dim, cfg.patch_size, stride=cfg.patch_size)
        # main block index -> its hint's index
        self.hint_of = {i: n for n, i in enumerate(cfg.vace_layers)}
        self._rope = {}

    def cast_for_inference(self, dtype: torch.dtype) -> "WanDiT":
        """Linear and convolution weights to `dtype`, except the time
        embedding, the time projection and the head, which Wan runs in
        f32; norms and modulation stay f32."""
        f32 = set(self.time_embedding.modules()) \
            | set(self.time_projection.modules()) | set(self.head.modules())
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)) and m not in f32:
                m.to(dtype)
        return self

    def rope(self, grid: tuple, device) -> tuple:
        """(sin, cos) of the (f, h, w) token grid, (S, 1, D/2) f32."""
        key = (grid, str(device))
        if key not in self._rope:
            sin, cos = wan_rope_tables(*grid, self.cfg.dim
                                       // self.cfg.num_heads)
            self._rope[key] = tuple(torch.from_numpy(t)[:, None].to(device)
                                    for t in (sin, cos))
        return self._rope[key]

    def _patchify(self, conv, x):
        dt = conv.weight.dtype
        y = conv(x.to(dt))
        return y.flatten(2).transpose(1, 2), tuple(y.shape[2:])

    def embed_context(self, context):
        """(B, L, text_dim) text embeddings -> (B, text_len, dim): rows
        zero-padded to text_len, then the text embedding."""
        B, L, C = context.shape
        pad = context.new_zeros(B, self.cfg.text_len - L, C)
        ctx = torch.cat([context, pad], dim=1)
        return self.text_embedding(ctx.to(self.text_embedding[0].weight.dtype))

    def forward(self, x, t, vace_context, context):
        """Flow prediction for latents x (1, in_dim, f, H, W) f32 at
        timestep t (a scalar tensor), for every row of `context` (B,
        text_len, dim; `embed_context`'s), with the VACE context latents
        vace_context (1, vace_in_dim, f, H, W). Returns (B, out_dim, f, H,
        W) f32."""
        cfg = self.cfg
        with trace_annotation("wan.dit"):
            B = context.shape[0]
            tokens, grid = self._patchify(self.patch_embedding, x)
            rope = self.rope(grid, x.device)
            e = self.time_embedding(sinusoidal_embedding(
                cfg.freq_dim, t.reshape(1)).to(
                    self.time_embedding[0].weight.dtype)).float()
            e0 = self.time_projection(e).float().unflatten(1, (6, cfg.dim))
            x = tokens.float().expand(B, -1, -1).contiguous()
            with trace_annotation("wan.vace"):
                c, _ = self._patchify(self.vace_patch_embedding,
                                      vace_context)
                c = c.expand(B, -1, -1)
                hints = []
                for block in self.vace_blocks:
                    c, hint = block(c, x, e0, context, rope)
                    hints.append(hint)
                del c
            for i, block in enumerate(self.blocks):
                x = block(x, e0, context, rope)
                if i in self.hint_of:
                    x.add_(hints[self.hint_of[i]])
            out = self.head(x, e)
            return self.unpatchify(out, grid)

    def unpatchify(self, x, grid):
        """(B, f*h*w, p*q*r*c) -> (B, c, f*p, h*q, w*r)."""
        f, h, w = grid
        p, q, r = self.cfg.patch_size
        c = self.cfg.out_dim
        x = x.view(x.shape[0], f, h, w, p, q, r, c)
        x = torch.einsum("bfhwpqrc->bcfphqwr", x)
        return x.reshape(x.shape[0], c, f * p, h * q, w * r)
