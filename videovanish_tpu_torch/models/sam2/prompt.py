"""SAM2's prompt encoder: points and boxes to sparse embeddings, PyTorch.

Port of videovanish_tpu/models/sam2/prompt.py with the checkpoint's names
(`sam_prompt_encoder.*`). Every prompt batch is padded to MAX_POINTS slots
with the "not a point" label -1, so every frame has the same shapes; the
mask decoder masks the padded slots out of its attention. Labels: 1
positive click, 0 negative, 2 and 3 box corners, -1 padding. Everything
here stays f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

MAX_POINTS = 16  # prompt slots per (frame, object)


class PositionEmbeddingRandom(nn.Module):
    """Random spatial-frequency Fourier features of [0, 1]^2 coordinates."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords01):
        c = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    """(points, labels) -> (sparse (B, MAX_POINTS, D), dense no-mask (D,));
    `dense_pe(h, w)` is the decoder's image positional encoding."""

    def __init__(self, embed_dim: int = 256, image_size: int = 1024):
        super().__init__()
        self.image_size = image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # learned per-label embeddings: [neg, pos, box corner 1, corner 2]
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def forward(self, points_px, labels):
        """points_px: (B, P, 2) (x, y) pixels of the model's square input;
        labels: (B, P) int in {-1, 0, 1, 2, 3}."""
        emb = self.pe_layer((points_px + 0.5) / self.image_size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], emb)
        for li in range(4):
            emb = torch.where(lab == li,
                              emb + self.point_embeddings[li].weight[0], emb)
        return emb, self.no_mask_embed.weight[0]

    def dense_pe(self, h: int, w: int):
        """(h, w, D) encoding of the pixel centres of an h x w grid, (x, y)
        order."""
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        coords = torch.stack([xs[None, :].expand(h, w),
                              ys[:, None].expand(h, w)], dim=-1)
        return self.pe_layer(coords)
