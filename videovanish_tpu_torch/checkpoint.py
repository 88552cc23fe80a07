"""Weight files: the published torch files read into state dicts, and the
port's own assembled files written.

Port of videovanish_tpu/core/checkpoint.py (`maybe_load`) and
`core/convert.load_torch_state`, for torch files in place of orbax:

  load_torch_state(path)   .safetensors through the reader below; .pt /
                           .pth / .bin through torch.load (weights only),
                           unwrapping a "model" or "state_dict" entry
  maybe_load(path)         None when the path does not exist (one log line:
                           the caller then keeps seeded random weights);
                           otherwise the file, and any fault raises
  save_state(path, tree)   torch.save of a (nested) dict of tensors

The .safetensors reader needs no package: the format is an 8-byte
little-endian header length, a JSON header {name: {dtype, shape,
data_offsets}} (plus "__metadata__"), then the raw little-endian data. The
file is mapped, not read, and each tensor is a view of the mapping where
its offset is aligned to its element size (a copy where it is not).
"""
from __future__ import annotations

import json
import logging
import os
import struct
import zipfile

import torch

log = logging.getLogger(__name__)

# the dtypes of the published files (weights, position ids, batch-norm
# counters)
_SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32,
}


def read_safetensors(path) -> dict:
    """{name: tensor} of a .safetensors file, as views of its mapping."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes in a file of "
                             f"{size}")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable header ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    # shared=False maps the file copy-on-write: nothing is read up front
    data = torch.from_file(str(path), shared=False, size=size,
                           dtype=torch.uint8)[8 + n:]
    out = {}
    for name, ent in header.items():
        dtype = _SAFETENSORS_DTYPES.get(ent.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {ent.get('dtype')!r}")
        shape = [int(s) for s in ent["shape"]]
        start, end = (int(o) for o in ent["data_offsets"])
        item = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if not 0 <= start <= end <= data.numel() or \
                end - start != numel * item:
            raise ValueError(f"{path}: {name} {shape} {ent['dtype']} does "
                             f"not fit its offsets {start}..{end}")
        raw = data[start:end]
        if (8 + n + start) % item:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_torch_state(path) -> dict:
    """The state dict of a published or converted weight file: {key:
    tensor} (a nested dict for the port's assembled files), on the CPU."""
    path = str(path)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True,
                     mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict):
        for key in ("model", "state_dict"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: holds a {type(obj).__name__}, not a "
                         f"state dict")
    return obj


def checkpoint_present(path) -> bool:
    """Whether `path` names an existing file; logs one line when it does
    not, since the caller then keeps seeded random weights."""
    if path and os.path.exists(path):
        return True
    log.warning("no checkpoint at %r: seeded random weights", path)
    return False


def maybe_load(path):
    """load_torch_state(path), or None when the path does not exist."""
    return load_torch_state(path) if checkpoint_present(path) else None


def _own_storage(tree):
    """The tree with every tensor that views a larger storage (a mapped
    safetensors file) copied out: torch.save writes a tensor's whole
    storage, and refuses one storage viewed as two dtypes."""
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    if tree.untyped_storage().nbytes() != tree.nbytes or \
            tree.storage_offset() or not tree.is_contiguous():
        return tree.clone(memory_format=torch.contiguous_format)
    return tree


def save_state(path, tree) -> None:
    """Write a (nested) dict of tensors with torch.save."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_own_storage(tree), path)
