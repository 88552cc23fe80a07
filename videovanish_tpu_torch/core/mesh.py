"""The ("data", "model") device mesh over torch.distributed (port of
videovanish_tpu/core/mesh.py).

The JAX package runs one controller: its arrays are global and GSPMD
inserts every collective. The port runs PyTorch's way: one process per card
(torchrun), each rank holding plain local tensors for its frames, with an
explicit collective wherever an operation crosses frames. A DeviceMesh keeps
the groups; the tensors stay plain tensors (the kernels take raw pointers),
so there is no DTensor. Every rank is given the same inputs and returns the
same full result.

Backends: NCCL for CUDA tensors, after torch.cuda.set_device(LOCAL_RANK);
gloo for CPU tensors, where the caller asked for the CPU. A mesh or a
collective on CUDA tensors over any other backend raises: nothing is staged
through the host.

The axes: frames and temporal windows shard over "data"; attention heads
over "model".
"""
from __future__ import annotations

import contextvars
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> tuple[int, int]:
    """Resolve (data, model) sizes for a flat device count."""
    if model_parallel <= 0:
        model_parallel = 1
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n_devices} devices"
        )
    return n_devices // model_parallel, model_parallel


def plan_hybrid_mesh(n_slices: int, devices_per_slice: int,
                     model_parallel: int = 1) -> tuple[tuple[int, int],
                                                       tuple[int, int]]:
    """Axis layout of a multi-node ("hybrid") mesh, pure function.

    Returns ((dcn_data, dcn_model), (ici_data, ici_model)): the network
    between nodes only ever carries the data axis; model parallelism stays
    inside a node, where tensor-sized collectives ride NVLink.
    """
    if model_parallel > devices_per_slice:
        raise ValueError(
            f"model_parallel={model_parallel} cannot span slices "
            f"({devices_per_slice} devices per slice): TP collectives "
            "must stay inside a node")
    if devices_per_slice % max(1, model_parallel):
        raise ValueError(
            f"model_parallel={model_parallel} does not divide "
            f"{devices_per_slice} devices per slice")
    return ((n_slices, 1),
            (devices_per_slice // max(1, model_parallel),
             max(1, model_parallel)))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda") -> bool:
    """Join the process group of a multi-process run. The arguments, else
    the JAX package's VV_COORDINATOR (host:port) / VV_NUM_PROCESSES /
    VV_PROCESS_ID, else torchrun's WORLD_SIZE / RANK with MASTER_ADDR and
    MASTER_PORT. On the card the backend is NCCL, on LOCAL_RANK's card (the
    process id modulo the card count without it); on the CPU it is gloo.
    One process is a no-op (False); an initialized group returns True."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("VV_NUM_PROCESSES")
                            or env.get("WORLD_SIZE") or 1)
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(env.get("VV_PROCESS_ID") or env.get("RANK") or 0)
    coordinator_address = coordinator_address or env.get("VV_COORDINATOR")
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif env.get("MASTER_ADDR"):
        init_method = "env://"
    else:
        raise ValueError(f"{num_processes} processes need VV_COORDINATOR "
                         "or torchrun's MASTER_ADDR / MASTER_PORT")
    device_id = None
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the NCCL process group")
        device_id = torch.device("cuda", int(env.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(device_id)
    dist.init_process_group("nccl" if device_id else "gloo",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            device_id=device_id)
    return True


def _check_backend(device_type: str, group=None) -> None:
    """CUDA tensors travel over NCCL only, CPU tensors over gloo only."""
    backend = str(dist.get_backend(group))
    want = "nccl" if device_type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a mesh on {device_type} tensors needs the {want} "
                         f"backend, the process group has {backend!r}")


def make_mesh(device_type: str = "cuda", model_parallel: int = 1,
              data: int = -1):
    """("data", "model") DeviceMesh over every rank of the initialized
    world (a 1x1 mesh in a one-rank world, where every sharding below is a
    no-op). `data` other than -1 must equal the data axis it resolves to.
    On the card, the first rank of each node builds the kernels while the
    others wait, so that no two ranks write one library."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_distributed)")
    _check_backend(device_type)
    dp, mp = mesh_shape_for(dist.get_world_size(), model_parallel)
    if data not in (-1, dp):
        raise ValueError(f"data={data}, but {dist.get_world_size()} ranks "
                         f"at model={mp} give data={dp}")
    mesh = init_device_mesh(device_type, (dp, mp),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    if device_type == "cuda":
        if int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0:
            from videovanish_tpu_torch.ops import kernels
            kernels.build()
        dist.barrier()
    return mesh


def make_hybrid_mesh(n_slices: Optional[int] = None, model_parallel: int = 1,
                     device_type: str = "cuda"):
    """("data", "model") mesh over several nodes: "data" spans the nodes
    and "model" stays inside one (plan_hybrid_mesh). torchrun numbers the
    ranks node by node, so the row-major (data, model) layout keeps each
    model group on one node. n_slices: the node count (default: the world
    over torchrun's LOCAL_WORLD_SIZE); one node gives the flat mesh."""
    world = dist.get_world_size()
    if not n_slices:
        n_slices = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_slices <= 1:
        return make_mesh(device_type, model_parallel)
    _, (_, mp) = plan_hybrid_mesh(n_slices, world // n_slices, model_parallel)
    return make_mesh(device_type, mp)


# ---------------------------------------------------------------------------
# frames over "data"
# ---------------------------------------------------------------------------
def data_coords(mesh) -> tuple[int, int]:
    """(this rank's index on "data", the axis size); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size()


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (one shape on all) concatenated along `dim` in the
    group's rank order."""
    _check_backend(t.device.type, group)
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group, in place."""
    _check_backend(t.device.type, group)
    dist.all_reduce(t, group=group)
    return t


def frame_block(n: int, mesh) -> tuple[int, int]:
    """[start, stop) of this rank's block of n frames over "data": ceil(n /
    data) frames a rank, the last ranks fewer or none (GSPMD's split of an
    uneven axis)."""
    index, size = data_coords(mesh)
    per = -(-n // size)
    return min(n, index * per), min(n, (index + 1) * per)


def gather_blocks(mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's frame_block of n frames concatenated in order: the
    all-gather over "data" of blocks padded with zeros to ceil(n / data)."""
    index, size = data_coords(mesh)
    if size == 1:
        return local
    per = -(-n // size)
    if local.shape[0] < per:
        local = torch.cat([local, local.new_zeros(
            (per - local.shape[0], *local.shape[1:]))])
    return all_gather_cat(local, mesh.get_group(DATA_AXIS))[:n]


# the blocks run_sharded is handing its function, while it runs
_BLOCKS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "vv_data_blocks", default=())


def is_data_block(t) -> bool:
    """True for a tensor that run_sharded handed the running function as
    this rank's block of an axis split over "data"."""
    return any(t is b for b in _BLOCKS.get())


def run_sharded(mesh, fn: Callable, *xs: torch.Tensor, even: bool = True):
    """fn on this rank's block of the leading (frame) axis of every x, and
    its output (a tensor or a tuple of them) gathered over "data" in frame
    order, so every rank returns what fn(*xs) returns. even=True shards
    only an axis that tiles evenly over "data" and runs fn on the whole
    axis on every rank otherwise, as the JAX package replicates an uneven
    batch (`put_batch`); even=False pads the axis to a multiple of "data"
    by repeating its last item, whose outputs are dropped."""
    index, size = data_coords(mesh)
    n = xs[0].shape[0]
    if size == 1 or (even and n % size):
        return fn(*xs)
    per = -(-n // size)
    pad = per * size - n
    if pad:
        xs = tuple(torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
                   for x in xs)
    blocks = tuple(x[index * per:(index + 1) * per] for x in xs)
    mark = _BLOCKS.set(blocks)
    try:
        out = fn(*blocks)
    finally:
        _BLOCKS.reset(mark)
    group = mesh.get_group(DATA_AXIS)
    if isinstance(out, tuple):
        return tuple(all_gather_cat(o, group)[:n] for o in out)
    return all_gather_cat(out, group)[:n]


# ---------------------------------------------------------------------------
# one writer, agreed decisions
# ---------------------------------------------------------------------------
def is_writer() -> bool:
    """True in the process that writes files: rank 0, or a lone process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def agree(obj):
    """Rank 0's `obj` on every rank (a broadcast over the world); `obj`
    itself in a lone process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank of the world; nothing in a lone process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
