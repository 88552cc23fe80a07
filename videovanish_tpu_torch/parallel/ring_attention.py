"""Ring attention: sequence-parallel attention over the mesh's "data" axis
(port of videovanish_tpu/parallel/ring_attention.py).

Each rank holds a block of the sequence (the frames of a clip) of q, k and
v. The K/V blocks travel around the ring, rank r to rank r + 1, while every
rank folds each block into an online softmax (f32 accumulators); the copy
of the next block is posted before the current one is computed, so the two
overlap. Nothing holds the full score matrix or the full K/V.

The per-block step is plain PyTorch, as the JAX body is einsums under XLA
and not a Pallas kernel. There is no backward: the trainer never builds the
ring.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from videovanish_tpu_torch.core.mesh import (
    DATA_AXIS, MODEL_AXIS, _check_backend, all_gather_cat, data_coords,
)

_NEG_INF = -1e30


def ring_attention(q, k, v, group=None, scale: float | None = None):
    """The per-rank body: q, k, v (B, H, S_local, D), the sequence split
    over the ranks of `group` in rank order. Returns (B, H, S_local, D) =
    softmax(q k^T * scale) v over the FULL sequence, in q's dtype."""
    group = group or dist.group.WORLD
    _check_backend(q.device.type, group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)

    qf = q.float()
    acc = torch.zeros_like(qf)
    m = torch.full_like(qf[..., :1], _NEG_INF)
    l = torch.zeros_like(qf[..., :1])
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for i in range(n):
        reqs = []
        if i < n - 1:  # no rotate after the last block
            k_nxt, v_nxt = torch.empty_like(k_cur), torch.empty_like(v_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_cur, nxt, group),
                dist.P2POp(dist.isend, v_cur, nxt, group),
                dist.P2POp(dist.irecv, k_nxt, prv, group),
                dist.P2POp(dist.irecv, v_nxt, prv, group)])
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float()) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        for r in reqs:
            r.wait()
        if reqs:
            k_cur, v_cur = k_nxt, v_nxt
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = DATA_AXIS):
    """Full (B, H, S, D) tensors in and out, the same on every rank: each
    rank takes its block of S over `axis_name` (S must divide by the axis),
    runs the ring, and the blocks are gathered back."""
    group = mesh.get_group(axis_name)

    def fn(q, k, v, scale=None):
        n = mesh[axis_name].size()
        i = mesh.get_local_rank(axis_name)
        S = q.shape[2]
        if S % n:
            raise ValueError(f"sequence {S} does not divide over {n} ranks")
        blk = slice(i * S // n, (i + 1) * S // n)
        out = ring_attention(q[:, :, blk], k[:, :, blk], v[:, :, blk],
                             group, scale)
        return all_gather_cat(out, group, dim=2)

    return fn


def ring_attention_for_mesh(mesh, seq_axis: str = DATA_AXIS,
                            head_axis: str = MODEL_AXIS):
    """Attention on (B, H, S_local, D) q, k, v whose sequence is split over
    `seq_axis` (ring attention), with the heads split over `head_axis` when
    it is larger than 1 and H divides by it (each rank runs the ring on its
    heads, and the heads are gathered back). Returns (B, H, S_local, D)."""
    seq_group = mesh.get_group(seq_axis)
    n_h = mesh[head_axis].size()
    h_group = mesh.get_group(head_axis) if n_h > 1 else None

    def fn(q, k, v, scale=None):
        H = q.shape[1]
        if n_h == 1 or H % n_h:
            return ring_attention(q, k, v, seq_group, scale)
        i = mesh.get_local_rank(head_axis)
        hs = slice(i * H // n_h, (i + 1) * H // n_h)
        out = ring_attention(q[:, hs], k[:, hs], v[:, hs], seq_group, scale)
        return all_gather_cat(out, h_group, dim=1)

    return fn


@dataclass(frozen=True)
class SequenceShard:
    """A clip's frames split over the mesh's "data" axis in equal blocks,
    as a motion module sees them: this rank holds frames [index * t,
    (index + 1) * t) of every batch element, t = clip length / size. `attn`
    is the temporal attention (ring over "data", heads over "model");
    `group` is the "data" group, over which the clip-wide GroupNorm
    statistics are summed."""
    group: object
    index: int
    size: int
    attn: Callable


def sequence_shard(mesh) -> SequenceShard:
    index, size = data_coords(mesh)
    return SequenceShard(mesh.get_group(DATA_AXIS), index, size,
                         ring_attention_for_mesh(mesh))
