"""Plain attention for the reference: f32 scores and softmax, taken in
query chunks so that the score tensor stays under 4 GiB. Every call of
the copied models lands here, whatever route the port would take.

`RECORDERS`: callables given (B, H, Sq, Sk, D) of each call; the
benchmark's attention count (`benchmark/counts/`) appends one while it
runs the models on the meta device."""
from __future__ import annotations

import torch

_NEG_INF = -1e30
RECORDERS: list = []


def plain_attention(q, k, v, scale, is_causal=False, key_mask=None,
                    max_score_bytes: int = 1 << 32):
    """(B, H, Sq, D) x (B, H, Sk, D) attention; key_mask: optional (B, Sk)
    bool, False keys are excluded."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    for rec in RECORDERS:
        rec(B, H, Sq, Sk, D)
    rows = max(1, max_score_bytes // max(1, B * H * Sk * 4))
    kf, vf = k.float(), v.float()
    out = []
    for i in range(0, Sq, rows):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i:i + rows].float(),
                         kf) * scale
        if is_causal:
            keep = torch.ones(s.shape[-2], Sk, dtype=torch.bool,
                              device=s.device).tril(Sk - Sq + i)
            s = s.masked_fill(~keep, _NEG_INF)
        if key_mask is not None:
            s = s.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bhqk,bhkd->bhqd", p, vf))
    return (out[0] if len(out) == 1 else torch.cat(out, dim=2)).to(q.dtype)


def attention(q, k, v, scale: float | None = None, is_causal: bool = False,
              key_mask=None):
    """Multi-head attention over (B, H, S, D) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return plain_attention(q, k, v, scale, is_causal, key_mask)


def attention_tokenmajor(q, k, v, heads: int, scale: float | None = None):
    """Self-attention over token-major (N, S, C) q/k/v, C = heads*d."""
    N, S, C = q.shape
    d = C // heads

    def split(t):
        return t.reshape(N, S, heads, d).permute(0, 2, 1, 3)
    out = attention(split(q), split(k), split(v), scale=scale)
    return out.permute(0, 2, 1, 3).reshape(N, S, C)
