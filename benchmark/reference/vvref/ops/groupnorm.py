"""GroupNorm (+ SiLU) with f32 statistics over NCHW-family tensors.

Port of videovanish_tpu/ops/groupnorm.py: the activations may be bf16, the
statistics and the normalisation run in f32 and the result returns in the
input's type. `group_norm_over_ranks` pools the statistics of a tensor split
over several ranks, where GSPMD reduces them over every shard.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from benchmark.reference.vvref.standins import all_reduce_sum


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over (N, C, *) input: per-sample statistics over each
    group of channels and every trailing axis, in f32."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(),
                        eps).to(x.dtype)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm followed by SiLU, both in f32."""
    y = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return F.silu(y).to(x.dtype)


def group_norm_over_ranks(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, num_groups: int, eps: float,
                          group) -> torch.Tensor:
    """GroupNorm over (N, C, *) input whose trailing axes are split over
    the ranks of `group` (the frames of a clip, each rank a block): the
    statistics pool over every rank's block, as one GroupNorm over the
    whole. The f32 sums, then the sums of squared deviations from the
    pooled mean, are summed over the ranks; a mean of per-rank variances
    would differ."""
    N, C = x.shape[:2]
    xg = x.float().reshape(N, num_groups, -1)
    count = xg.shape[-1] * dist.get_world_size(group)
    mean = all_reduce_sum(xg.sum(-1), group)[..., None] / count
    d = xg - mean
    var = all_reduce_sum((d * d).sum(-1), group)[..., None] / count
    y = (d * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return (y * weight.float().view(shape) + bias.float().view(shape)) \
        .to(x.dtype)
