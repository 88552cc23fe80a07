"""2D axial rotary position embeddings (RoPE) for spatial token grids.

Port of videovanish_tpu/ops/rope.py. SAM2's memory attention rotates its
queries and keys by their (x, y) grid position: the head dim splits in
half, the x (column) frequencies take the first half of the rotated pairs
and the y (row) frequencies the second, each half standard 1D RoPE over
frequency pairs. The tables are numpy constants, made once per grid.
"""
from __future__ import annotations

import numpy as np
import torch


def axial_rope_tables(side_y: int, side_x: int, head_dim: int,
                      theta: float = 10000.0):
    """(sin, cos) tables of shape (side_y*side_x, head_dim//2), f32 numpy,
    for a flattened row-major (y, x) grid."""
    assert head_dim % 4 == 0, head_dim
    quarter = head_dim // 4
    freqs = theta ** (-np.arange(quarter, dtype=np.float64) / quarter)
    ys = np.arange(side_y, dtype=np.float64)
    xs = np.arange(side_x, dtype=np.float64)
    ang_y = ys[:, None] * freqs[None]                      # (Sy, q)
    ang_x = xs[:, None] * freqs[None]                      # (Sx, q)
    ang = np.concatenate([
        np.broadcast_to(ang_x[None, :, :], (side_y, side_x, quarter)),
        np.broadcast_to(ang_y[:, None, :], (side_y, side_x, quarter)),
    ], axis=-1).reshape(side_y * side_x, head_dim // 2)
    return (np.sin(ang).astype(np.float32),
            np.cos(ang).astype(np.float32))


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2i], x[2i+1]) in f32. x: (..., S, D); sin/cos:
    (S, D//2) f32 tensors on x's device. The dtype of x is kept."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
