"""GroupNorm (+ SiLU) with f32 statistics over NCHW-family tensors.

Port of videovanish_tpu/ops/groupnorm.py: the activations may be bf16, the
statistics and the normalisation run in f32 and the result returns in the
input's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
