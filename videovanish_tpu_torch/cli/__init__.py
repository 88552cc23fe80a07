"""Command-line entry points of the port.

    python -m videovanish_tpu_torch.cli.sam2_masker --color_video ... \\
        --annotations ...
    python -m videovanish_tpu_torch.cli.diffuerase --color_video ... \\
        --mask_video ...
    python -m videovanish_tpu_torch.cli.compare --a ... --b ...
    python -m videovanish_tpu_torch.cli.convert ...
    python -m videovanish_tpu_torch.cli.videovanish  # the window (PySide6)

They run on the card; VV_PLATFORM=cpu runs them on the CPU, as the JAX
package's CLIs read it. VV_DEBUG_NANS=1 stops a run at the first module
whose output is not finite (`apply_debug_nans`).
"""
from __future__ import annotations

import os
import threading

_DEBUG_NANS_HOOKS = None
_MODULE_PATH = threading.local()


def device_from_env() -> str:
    """"cpu" under VV_PLATFORM=cpu, else "cuda", which must exist: without
    a card a CLI stops rather than run on the CPU unasked. Applies
    VV_DEBUG_NANS first."""
    apply_debug_nans()
    if os.environ.get("VV_PLATFORM") == "cpu":
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set VV_PLATFORM=cpu to run on "
                           "the CPU")
    return "cuda"


def _module_entered(module, args):
    """Push `module` with its path from the outermost module running on
    this thread (e.g. `UNetMotionModel.down_blocks.0.attentions.1`): the
    innermost running module that holds it names it."""
    stack = getattr(_MODULE_PATH, "stack", None)
    if stack is None:
        stack = _MODULE_PATH.stack = []
    for parent, path in reversed(stack):
        name = next((n for n, m in parent._modules.items() if m is module),
                    None)
        if name is not None:
            stack.append((module, f"{path}.{name}"))
            return
    stack.append((module, type(module).__name__))


def _module_left(module, args, output):
    import torch
    stack = _MODULE_PATH.stack
    while stack and stack[-1][0] is not module:
        stack.pop()
    path = stack.pop()[1] if stack else type(module).__name__
    todo = [output]
    while todo:
        x = todo.pop()
        if isinstance(x, (tuple, list)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, torch.Tensor) and x.is_floating_point() and \
                not bool(torch.isfinite(x).all()):
            stack.clear()
            raise FloatingPointError(
                f"VV_DEBUG_NANS: the output of {path} "
                f"({type(module).__name__}) is not finite")


def apply_debug_nans():
    """Under VV_DEBUG_NANS=1 (the JAX package's knob, which sets
    jax_debug_nans): forward hooks on every torch module that raise
    FloatingPointError at the first module whose output holds a NaN or an
    infinity, naming the module by its path. A large slowdown: each
    module's output is checked, which waits on the device. Installed once
    a process; returns the hooks' handles, or None without the variable."""
    global _DEBUG_NANS_HOOKS
    if os.environ.get("VV_DEBUG_NANS") == "1" and _DEBUG_NANS_HOOKS is None:
        from torch.nn.modules import module as nn_module
        _DEBUG_NANS_HOOKS = (
            nn_module.register_module_forward_pre_hook(_module_entered),
            nn_module.register_module_forward_hook(_module_left))
    return _DEBUG_NANS_HOOKS
