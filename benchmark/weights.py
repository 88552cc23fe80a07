"""Seeded weights, made on the device in a few large calls.

Each tensor of a module's state dict gets a rule from its owner and name,
the scale of PyTorch's default initialisation (which the port's own seeded
init also follows): every weight of two or more axes and its bias uniform
in +-1/sqrt(fan_in), norms at weight 1 and bias 0, embeddings standard
normal, and the few named tensors of `SPECIAL`. The uniform draws of all
tensors come from one `torch.rand` and the normal ones from one
`torch.randn` on a generator on the device, in blocks of BLOCK values,
and are scaled and split in bulk; the result is in `dtype` (the type the
port serves them in), and the reference takes the same values in f32.
A tensor no rule covers raises. Buffers that a module computes from its
configuration (index tables) are taken from an instance built on the CPU.
Which rule each tensor takes (a module's plan) is worked out once a
checkout and configuration, and kept under `build/`.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch
import torch.nn as nn

BLOCK = 1 << 28
PLAN_DIR = Path(__file__).resolve().parents[1] / "build" / "bench_plans"
REFERENCE = Path(__file__).resolve().parent / "reference"
# (name of the tensor within its module, rule, value): SAM2's tensors
# outside the generic rules, set as the port's seeded init sets them
SPECIAL = {
    "gamma": ("const", 1e-6),
    "pos_embed": ("normal", 0.02),
    "pos_embed_window": ("normal", 0.02),
    "maskmem_tpos_enc": ("normal", 0.02),
    "positional_encoding_gaussian_matrix": ("normal", 1.0),
    "no_mem_embed": ("const", 0.0),
    "no_obj_ptr": ("const", 0.0),
    "no_obj_embed_spatial": ("const", 0.0),
}
# whole keys set apart: SAM2's object-score head ends in a bias that says
# the prompted object is present in every frame, as a trained model says
# of an object it was shown. At random weights the score's sign is a coin
# flip per seed, and an absent object's logits are one constant on both
# sides, so a check would compare nothing on those seeds and a run would
# skip the memory encoder's work.
FULL_KEYS = {
    "sam_mask_decoder.pred_obj_score_head.layers.2.bias": ("const", 10.0),
}
_BN_BUFFERS = {"running_mean": 0.0, "running_var": 1.0,
               "num_batches_tracked": 0.0}


def _rule(module: nn.Module, name: str, t: torch.Tensor):
    if name in SPECIAL:
        return SPECIAL[name]
    if name in _BN_BUFFERS:
        return "const", _BN_BUFFERS[name]
    w = getattr(module, "weight", None)
    if isinstance(module, nn.Embedding):
        return "normal", 1.0
    if w is not None and w.dim() >= 2 and name in ("weight", "bias"):
        fan_in = w.shape[1] * w[0, 0].numel()
        return "uniform", fan_in ** -0.5
    if w is not None and w.dim() == 1 and name in ("weight", "bias"):
        return "const", 1.0 if name == "weight" else 0.0
    return None


def module_plan(module: nn.Module, structural=None) -> list:
    """[key, shape, dtype, rule, value] of every tensor of `module`'s state
    dict (a module on the meta device). A tensor no rule covers is taken
    from `structural()`, an instance built on the CPU, as rule "given" with
    its values; without one it raises."""
    out, missing = [], []
    for mname, m in module.named_modules():
        own = list(m.named_parameters(recurse=False)) + \
            list(m.named_buffers(recurse=False))
        persistent = set(m.state_dict(keep_vars=True).keys())
        for name, t in own:
            if name not in persistent:
                continue
            key = f"{mname}.{name}" if mname else name
            r = FULL_KEYS.get(key) or _rule(m, name, t)
            dtype = str(t.dtype).removeprefix("torch.")
            if r is None:
                missing.append([key, list(t.shape), dtype])
            else:
                out.append([key, list(t.shape), dtype, r[0], r[1]])
    if missing:
        if structural is None:
            raise ValueError(f"no weight rule for {[m[0] for m in missing]}")
        built = structural().state_dict()
        out += [[k, shape, dtype, "given", built[k].tolist()]
                for k, shape, dtype in missing]
    return out


def plans(key: dict, build) -> dict:
    """{name: module_plan} of the modules `build()` returns as {name:
    (meta module, structural or None)}. Building the skeletons costs
    seconds a run, so the plans are kept in PLAN_DIR under a hash of `key`
    (the configuration), this file and the reference's code: only a
    checkout's first run of a configuration builds them."""
    h = hashlib.sha256(json.dumps(key, sort_keys=True).encode())
    for path in sorted([Path(__file__), *REFERENCE.rglob("*.py")]):
        h.update(path.read_bytes())
    path = PLAN_DIR / f"{h.hexdigest()[:20]}.json"
    if path.exists():
        return json.loads(path.read_text())
    out = {name: module_plan(m, structural)
           for name, (m, structural) in build().items()}
    PLAN_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(out))
    os.replace(tmp, path)
    return out


def _draw(kind: str, n: int, gen, device) -> list:
    fn = torch.rand if kind == "uniform" else torch.randn
    return [fn(min(BLOCK, n - i), generator=gen, device=device)
            for i in range(0, n, BLOCK)]


def seeded_state(entries: list, gen: torch.Generator, dtype) -> dict:
    """The state dict of a module's plan under the rules above, on
    `gen`'s device, floating tensors in `dtype` (integer ones keep their
    type)."""
    device = gen.device
    out = {}
    for kind in ("uniform", "normal"):
        sel = [e for e in entries if e[3] == kind]
        counts = [int(torch.Size(e[1]).numel()) for e in sel]
        total = sum(counts)
        if not total:
            continue
        scale = torch.repeat_interleave(
            torch.tensor([e[4] for e in sel], device=device),
            torch.tensor(counts, device=device))
        flat, pos = [], 0
        for block in _draw(kind, total, gen, device):
            s = scale[pos:pos + block.numel()]
            pos += block.numel()
            v = (block * 2.0 - 1.0) * s if kind == "uniform" else block * s
            flat.append(v.to(dtype))
        flat = torch.cat(flat) if len(flat) > 1 else flat[0]
        for e, piece in zip(sel, torch.split(flat, counts)):
            out[e[0]] = piece.view(e[1])
    for key, shape, dt, kind, value in entries:
        t_dtype = getattr(torch, dt)
        if t_dtype.is_floating_point:
            t_dtype = dtype
        if kind == "const":
            out[key] = torch.full(shape, value, dtype=t_dtype, device=device)
        elif kind == "given":
            out[key] = torch.tensor(value, dtype=t_dtype,
                                    device=device).view(shape)
    return out


def to_f32(state):
    """The same values in f32 for the reference (integer tensors kept), in
    a state dict or a dict of them."""
    if isinstance(state, dict):
        return {k: to_f32(v) for k, v in state.items()}
    return state.float() if state.is_floating_point() else state
