"""The control: the reference with every linear and convolution layer
computed from float8 (e4m3) operands, as an fp8 GEMM with f32
accumulation computes it. Each weight is rounded once, each input on the
way in, both with one scale per tensor (its largest magnitude to 448,
e4m3's largest); the products and sums stay f32. This is the step below
the bf16 the configurations state."""
from __future__ import annotations

import torch
import torch.nn as nn

E4M3_MAX = 448.0
LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(t.dtype)


def _quantize_input(module, args):
    x = args[0] if args else None
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return None
    return (round_e4m3(x),) + tuple(args[1:])


@torch.no_grad()
def emulate_fp8(root: nn.Module) -> int:
    """Round the weights of `root`'s linear and convolution layers (and
    layers with a weight of two or more axes that subclass neither) and
    quantize their inputs from now on; returns the layers changed."""
    n = 0
    for m in root.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, LAYERS) or (isinstance(w, torch.Tensor)
                                     and w.dim() >= 2
                                     and not isinstance(m, nn.Embedding)):
            m.weight.copy_(round_e4m3(m.weight))
            m.register_forward_pre_hook(_quantize_input)
            n += 1
    return n
