"""Tensor parallelism over the mesh's "model" axis, and the clips of a batch
over "data" (port of videovanish_tpu/parallel/sharding.py).

The JAX package names a PartitionSpec for each parameter and lets GSPMD
insert the collectives. The port holds plain local tensors (the kernels
take raw pointers): each rank keeps its shard of a split parameter, and the
layers that read one run Megatron's pattern with explicit collectives over
the "model" group. The rules are the JAX package's, over the port's
(diffusers) names:

  column split  to_q, to_k, to_v, ff.net.0.proj and linear_1, weight and
                bias: torch dim 0. The layer's input goes through
                `copy_to_model` (identity forward, the gradient all-reduced
                backward), so each rank runs heads / model of the heads, or
                its slice of the hidden width;
  row split     to_out.0, ff.net.2 and linear_2, the weight: torch dim 1.
                `row_linear` all-reduces the partial products forward
                (identity backward) and adds the bias once, after the sum;
  replicated    everything else (convolutions, norms, embeddings).

An nn.Linear weight is (out, in) where a Flax kernel is (in, out), so JAX's
column split P(None, "model") is torch dim 0 and its row split P("model",
None) torch dim 1. GEGLU's projection (ff.net.0.proj) yields [h, gate],
which the layer halves with chunk(2); where GSPMD keeps any layout right, a
contiguous split would give rank 0 all of h and rank 1 all of gate. Its
shard is therefore rank r's slice of each half, and `join_shards` puts the
halves back in order.

A trainer's tensor under a "model" split carries its ModelShard (the
attribute SHARD), as Megatron tags its parameters: the train state's save,
restore and bind read it, with the parameter's name from their keys, to
gather a shard or to cut one from a whole tensor.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from videovanish_tpu_torch.core.mesh import (
    MODEL_AXIS, all_reduce_sum, data_coords,
)

_COLUMN = re.compile(
    r"(?:^|\.)(?:to_q|to_k|to_v|ff\.net\.0\.proj|linear_1)\.(?:weight|bias)$")
_ROW = re.compile(r"(?:^|\.)(?:to_out\.0|ff\.net\.2|linear_2)\.weight$")
# [h, gate]: two halves, each split over "model"
_PAIRED = re.compile(r"(?:^|\.)ff\.net\.0\.proj\.(?:weight|bias)$")

SHARD = "vv_model_shard"


def split_dim(name: str, ndim: int) -> Optional[int]:
    """The torch dim of parameter `name` split over "model" (0 for a column
    split, 1 for a row split), None where it is replicated: JAX's
    param_sharding_rules over the port's names."""
    if _COLUMN.search(name) and ndim in (1, 2):
        return 0
    if _ROW.search(name) and ndim == 2:
        return 1
    return None


@dataclass(frozen=True)
class ModelShard:
    """This rank's place on the "model" axis: the group, its index in it
    and the axis size."""
    group: object
    rank: int
    size: int


def model_shard(mesh) -> Optional[ModelShard]:
    """The mesh's "model" coordinates of this rank; None without a mesh or
    where the axis is 1 (every layer then runs whole)."""
    if mesh is None or mesh[MODEL_AXIS].size() == 1:
        return None
    return ModelShard(mesh.get_group(MODEL_AXIS),
                      mesh.get_local_rank(MODEL_AXIS),
                      mesh[MODEL_AXIS].size())


def shard_tensor(name: str, whole: torch.Tensor, rank: int,
                 size: int) -> torch.Tensor:
    """Rank `rank`'s shard of parameter `name` over a "model" axis of `size`
    (a copy; `whole` itself where the parameter is replicated). A width the
    axis does not divide raises, as JAX's device_put does."""
    dim = split_dim(name, whole.ndim)
    if dim is None or size == 1:
        return whole
    parts = 2 if _PAIRED.search(name) else 1
    n = whole.shape[dim]
    if n % (parts * size):
        raise ValueError(f"{name}: dim {dim} of {tuple(whole.shape)} does "
                         f"not split over a model axis of {size}"
                         + (" in each of its two halves" if parts > 1
                            else ""))
    per = n // (parts * size)
    halves = whole.chunk(parts, dim)
    return torch.cat([h.narrow(dim, rank * per, per) for h in halves], dim)


def join_shards(name: str, shards: list) -> torch.Tensor:
    """The whole parameter `name` from every rank's shard in "model" order;
    the inverse of shard_tensor."""
    dim = split_dim(name, shards[0].ndim)
    if dim is None or len(shards) == 1:
        return shards[0]
    if _PAIRED.search(name):
        halves = [s.chunk(2, dim) for s in shards]
        return torch.cat([h for h, _ in halves] + [g for _, g in halves], dim)
    return torch.cat(shards, dim)


def gather_tensor(name: str, t: torch.Tensor,
                  shard: Optional[ModelShard]) -> torch.Tensor:
    """The whole parameter `name` from this rank's shard `t`: an all-gather
    over the "model" group (every rank of it calls this)."""
    if shard is None or split_dim(name, t.ndim) is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return join_shards(name, parts)


def shard_state_dict(state: dict, mesh) -> dict:
    """This rank's shard of every tensor of a whole state dict (JAX's
    shard_params)."""
    shard = model_shard(mesh)
    if shard is None:
        return dict(state)
    return {k: shard_tensor(k, v, shard.rank, shard.size)
            for k, v in state.items()}


def gather_state_dict(shards: dict, mesh) -> dict:
    """The whole state dict from every rank's shards: one all-gather over
    "model" a split tensor, in the dict's order on every rank."""
    shard = model_shard(mesh)
    return {k: gather_tensor(k, v, shard) for k, v in shards.items()}


def batch_block(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the leading (clip) axis over "data" (JAX's
    batch_sharding); the axis must be a multiple of the data axis."""
    index, size = data_coords(mesh)
    if size == 1:
        return x
    n = x.shape[0]
    if n % size:
        raise ValueError(f"a batch of {n} does not split over a data axis "
                         f"of {size}")
    return x[index * n // size:(index + 1) * n // size]


# ---------------------------------------------------------------------------
# Megatron's two collectives
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the "model" group
    backward (each rank's column shard saw the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        # a copy: autograd may hand the same buffer to another branch
        g = grad.clone(memory_format=torch.contiguous_format)
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products of a row-split layer summed over the "model"
    group forward, in place (`x` is a fresh product that autograd does not
    keep); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, shard: Optional[ModelShard]):
    """The input of column-split layers: `x` itself, whose gradient is
    summed over the "model" group."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def row_linear(linear, x: torch.Tensor, shard: Optional[ModelShard]):
    """`linear` (row-split under `shard`) on this rank's slice of the
    features: the partial products summed over "model", then the bias,
    once. `linear(x)` itself without a shard."""
    if shard is None:
        return linear(x)
    y = _ReduceFromModel.apply(F.linear(x, linear.weight), shard.group)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


@torch.no_grad()
def shard_module_(module: torch.nn.Module,
                  shard: Optional[ModelShard]) -> None:
    """Cut every split parameter of `module` to this rank's shard, in place
    (the Parameter objects stay), and hand `shard` to each layer that runs
    on shards (a `model_shard` attribute: Attention, FeedForward,
    TimestepEmbedding). A head count the axis does not divide raises."""
    if shard is None:
        return
    for m in module.modules():
        heads = getattr(m, "heads", None)
        if hasattr(m, "model_shard") and heads and heads % shard.size:
            raise ValueError(f"{heads} heads do not split over a model "
                             f"axis of {shard.size}")
    for name, p in module.named_parameters():
        if split_dim(name, p.ndim) is not None:
            p.data = shard_tensor(name, p.data, shard.rank, shard.size)
    for m in module.modules():
        if hasattr(m, "model_shard"):
            m.model_shard = shard


# ---------------------------------------------------------------------------
# the shard a trainer's tensors carry
# ---------------------------------------------------------------------------
def tag_shard_(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    setattr(t, SHARD, shard)
    return t


def shard_of(t: torch.Tensor) -> Optional[ModelShard]:
    """The "model" shard whose tensor `t` is (None where it is whole)."""
    return getattr(t, SHARD, None)


def local_of(name: str, whole: torch.Tensor,
             dst: torch.Tensor) -> torch.Tensor:
    """What `dst`, a trainer's tensor of parameter `name`, holds of
    `whole`: this rank's shard where `dst` is one, `whole` itself where
    the shapes already agree."""
    shard = shard_of(dst)
    if shard is None or whole.shape == dst.shape:
        return whole
    return shard_tensor(name, whole, shard.rank, shard.size)
