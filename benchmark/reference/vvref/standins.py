"""What the reference copy takes in place of the port's mesh,
observability, checkpoint and conversion modules: one process, no mesh,
no files, state dicts under the port's names, nothing recorded."""
from __future__ import annotations

import contextlib


def maybe_load(path):
    return None


def load_torch_state(path):
    raise ValueError("the reference loads no checkpoint file")


def published_state_dict(state: dict, model: str) -> dict:
    return dict(state)


def jax_params_to_state_dict(tree, name):
    raise ValueError("the reference takes state dicts under the port's names")


def rename_legacy_vae_keys(state: dict) -> dict:
    return state


def data_coords(mesh) -> tuple[int, int]:
    return 0, 1


def run_sharded(mesh, fn, *xs, even: bool = True):
    return fn(*xs)


def frame_block(n: int, mesh) -> tuple[int, int]:
    return 0, n


def gather_blocks(mesh, local, n: int):
    return local


def all_reduce_sum(t, group):
    return t


def sequence_shard(mesh):
    raise ValueError("the reference runs on one device")


def copy_to_model(x, shard):
    return x


def row_linear(linear, x, shard):
    return linear(x)


def record_sharding(program: str, **tensors) -> None:
    return None


def record_stage(stage: str, seconds: float, **fields) -> None:
    return None


@contextlib.contextmanager
def stage_timer(stage: str, **fields):
    yield


@contextlib.contextmanager
def trace_annotation(name: str):
    yield
