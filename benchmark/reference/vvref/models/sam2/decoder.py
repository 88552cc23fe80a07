"""SAM2's mask decoder: two-way transformer and hypernetwork mask heads,
PyTorch, channel-last.

Port of videovanish_tpu/models/sam2/decoder.py with the checkpoint's names
(`sam_mask_decoder.*`; the object-pointer head is the top-level
`obj_ptr_proj`, held by the predictor). Tokens are [object score, IoU,
mask 0..3] + the sparse prompt embeddings. The token-to-image attentions
(22 queries over the 4096 image tokens, 8 heads of 16) take the flash
kernel; the attentions that mask padded prompt slots take the plain path,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.vvref.models.sam2.hiera import (
    Mlp, gelu_tanh, layer_norm_f32,
)
from benchmark.reference.vvref.ops.attention import attention


class DecoderAttention(nn.Module):
    """Attention with an internal down-projection (SAM style)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        inner = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, inner)
        self.k_proj = nn.Linear(embed_dim, inner)
        self.v_proj = nn.Linear(embed_dim, inner)
        self.out_proj = nn.Linear(inner, embed_dim)

    def forward(self, q, k, v, key_mask=None):
        B = q.shape[0]
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        hd = qp.shape[-1] // self.num_heads

        def heads(t):
            return t.reshape(B, -1, self.num_heads, hd).permute(0, 2, 1, 3)

        out = attention(heads(qp), heads(kp), heads(vp), key_mask=key_mask)
        return self.out_proj(out.permute(0, 2, 1, 3).reshape(B, -1, qp.shape[-1]))


class TwoWayBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(embed_dim, num_heads)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.cross_attn_token_to_image = DecoderAttention(embed_dim,
                                                          num_heads, 2)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.lin1 = nn.Linear(embed_dim, mlp_dim)
        self.mlp.lin2 = nn.Linear(mlp_dim, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.cross_attn_image_to_token = DecoderAttention(embed_dim,
                                                          num_heads, 2)
        self.norm4 = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe, token_valid=None):
        # token self-attention, padded prompt slots masked out as keys
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries,
                                     key_mask=token_valid)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries,
                                               key_mask=token_valid)
        queries = layer_norm_f32(self.norm1, queries)
        # token -> image
        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = layer_norm_f32(self.norm2, queries)
        # token MLP
        h = self.mlp.lin2(F.relu(self.mlp.lin1(queries)))
        queries = layer_norm_f32(self.norm3, queries + h)
        # image -> token
        q = queries + query_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries,
                                                     key_mask=token_valid)
        keys = layer_norm_f32(self.norm4, keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayBlock(embed_dim, num_heads, mlp_dim,
                        skip_first_layer_pe=(i == 0)) for i in range(depth))
        self.final_attn_token_to_image = DecoderAttention(embed_dim,
                                                          num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, image_embed, image_pe, point_embed, token_valid=None):
        """image_embed, image_pe: (B, HW, C); point_embed: (B, P, C);
        token_valid: optional (B, P) bool of real (non-padding) tokens."""
        queries, keys = point_embed, image_embed
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embed, image_pe,
                                  token_valid)
        q = queries + point_embed
        k = keys + image_pe
        attn = self.final_attn_token_to_image(q, k, keys)
        return layer_norm_f32(self.norm_final_attn, queries + attn), keys


class ConvTranspose2x2(nn.ConvTranspose2d):
    """A 2x2 stride-2 transposed conv (the checkpoint's (I, O, 2, 2)
    weight) applied to channel-last input as one matmul: every input pixel
    writes its own 2x2 output block.

    It computes what the JAX package computes: flax's ConvTranspose
    (transpose_kernel=False) on the kernel its converter makes from this
    weight, which is torch's ConvTranspose2d with the kernel flipped in
    both spatial axes (ROADMAP, Queue 3)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x):
        B, H, W, _ = x.shape
        y = torch.einsum("nhwc,coij->nhiwjo", x, self.weight.flip(2, 3))
        return y.reshape(B, 2 * H, 2 * W, -1) + self.bias


class MaskDecoder(nn.Module):
    """Masks, IoU, object score and object-pointer tokens from the
    (memory-conditioned) stride-16 features and the prompt embeddings."""

    def __init__(self, embed_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3):
        super().__init__()
        C = embed_dim
        self.n_masks = n = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(embed_dim=C, mlp_dim=8 * C)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(n, C)
        self.obj_score_token = nn.Embedding(1, C)
        # the checkpoint's Sequential (indices 0-4); forward applies the
        # parts one by one with the high-resolution skips between them
        self.output_upscaling = nn.Sequential(
            ConvTranspose2x2(C, C // 4), nn.LayerNorm(C // 4, eps=1e-6),
            nn.GELU(approximate="tanh"), ConvTranspose2x2(C // 4, C // 8),
            nn.GELU(approximate="tanh"))
        self.conv_s0 = nn.Conv2d(C, C // 8, 1)
        self.conv_s1 = nn.Conv2d(C, C // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            Mlp((C, C, C, C // 8)) for _ in range(n))
        self.iou_prediction_head = Mlp(
            (C,) * iou_head_depth + (n,), sigmoid_out=True)
        self.pred_obj_score_head = Mlp((C, C, C, 1))

    def forward(self, image_embed, image_pe, sparse_prompt, high_res_s4,
                high_res_s8, sparse_valid, obj_ptr_proj):
        """image_embed: (B, H, W, C); image_pe: (B, H, W, C); sparse_prompt:
        (B, P, C); high_res_s4 / s8: (B, 4H, 4W, C) / (B, 2H, 2W, C) skips;
        sparse_valid: (B, P) bool; obj_ptr_proj: the pointer MLP.
        Returns masks (B, M, 4H, 4W) f32 logits, iou (B, M), obj_ptrs
        (B, M, C) (every mask token's pointer) and obj_score (B, 1)."""
        B, H, W, C = image_embed.shape
        dt = image_embed.dtype
        tokens = torch.cat([self.obj_score_token.weight, self.iou_token.weight,
                            self.mask_tokens.weight], dim=0)
        tokens = torch.cat([tokens[None].expand(B, -1, -1).to(dt),
                            sparse_prompt.to(dt)], dim=1)
        src = image_embed.reshape(B, H * W, C)
        pe = image_pe.expand(B, H, W, C).reshape(B, H * W, C).to(dt)
        token_valid = torch.cat([
            torch.ones(B, 2 + self.n_masks, dtype=torch.bool,
                       device=sparse_valid.device), sparse_valid], dim=1)
        hs, src = self.transformer(src, pe, tokens, token_valid)
        obj_out, iou_out = hs[:, 0], hs[:, 1]
        mask_out = hs[:, 2:2 + self.n_masks]

        # stride 16 -> 4 with the high-resolution skips
        up = self.output_upscaling
        up1 = up[0](src.reshape(B, H, W, C))
        up1 = up1 + F.linear(high_res_s8.to(up1.dtype),
                             self.conv_s1.weight.flatten(1), self.conv_s1.bias)
        up1 = gelu_tanh(layer_norm_f32(up[1], up1))
        up2 = up[3](up1)
        up2 = up2 + F.linear(high_res_s4.to(up2.dtype),
                             self.conv_s0.weight.flatten(1), self.conv_s0.bias)
        up2 = gelu_tanh(up2)

        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper.float(), up2.float())
        return {
            "masks": masks,
            "iou": self.iou_prediction_head(iou_out).float(),
            "obj_ptrs": obj_ptr_proj(mask_out),
            "obj_score": self.pred_obj_score_head(obj_out).float(),
        }
