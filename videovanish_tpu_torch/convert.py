"""Weights from the JAX package's parameter trees into the port.

The port's modules use the diffusers checkpoint key names and shapes, so a
published state dict loads with `load_state_dict`. Parameters held as JAX
(flax) trees -- nested dicts of numpy arrays, as videovanish_tpu's
`core/convert.convert_state_dict` produces them from those checkpoints --
come across with `jax_params_to_state_dict`, which inverts that
conversion: the name rules (VAE_RULES, UNET_RULES, UNET_SPECIALS) and the
leaf transforms

  conv kernel   (kh, kw, I, O) -> (O, I, kh, kw)
  dense kernel  (I, O)         -> (O, I); (O, I, 1, 1) for the spatial
                                  transformers' proj_in / proj_out
  norm scale                   -> weight

This module keeps its own copy of those rules: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# JAX module path (dotted) -> diffusers module path, applied in order
_UNET_NAME_RULES = [
    (r"^(down_blocks|up_blocks)_(\d+)_(resnets|attentions|motion_modules"
     r"|downsamplers|upsamplers)_(\d+)\b", r"\1.\2.\3.\4"),
    (r"^mid_block_(resnets|attentions|motion_modules)_(\d+)\b",
     r"mid_block.\1.\2"),
    (r"(^|\.)transformer_blocks_(\d+)\b", r"\1transformer_blocks.\2"),
    (r"(^|\.)to_out_0\b", r"\1to_out.0"),
    (r"(^|\.)ff\.net_0\.proj\b", r"\1ff.net.0.proj"),
    (r"(^|\.)ff\.net_2\b", r"\1ff.net.2"),
]
_BRUSHNET_NAME_RULES = _UNET_NAME_RULES + [
    (r"^conv_in$", "conv_in_condition"),
    (r"^zero_down_(\d+)\.conv$", r"brushnet_down_blocks.\1"),
    (r"^zero_mid\.conv$", "brushnet_mid_block"),
    (r"^zero_up_(\d+)\.conv$", r"brushnet_up_blocks.\1"),
]
_VAE_NAME_RULES = [
    (r"^(encoder|decoder)\.(down_blocks|up_blocks)_(\d+)_(resnets"
     r"|downsamplers|upsamplers)_(\d+)\b", r"\1.\2.\3.\4.\5"),
    (r"\.mid_block\.(resnets|attentions)_(\d+)\b", r".mid_block.\1.\2"),
    (r"\.attentions\.0\.attn\.", ".attentions.0."),
    (r"(^|\.)to_out_0\b", r"\1to_out.0"),
]
_RULES = {"unet": _UNET_NAME_RULES, "brushnet": _BRUSHNET_NAME_RULES,
          "vae": _VAE_NAME_RULES}
# dense kernels that are 1x1 convs in the checkpoint (SD1.5's
# use_linear_projection=False spatial transformers)
_CONV1X1 = re.compile(r"\.attentions\.\d+\.proj_(in|out)$")

# pre-0.18 diffusers attention names in the published sd-vae-ft-mse file
_LEGACY_VAE = [
    (r"(mid_block\.attentions\.\d+)\.query\.", r"\1.to_q."),
    (r"(mid_block\.attentions\.\d+)\.key\.", r"\1.to_k."),
    (r"(mid_block\.attentions\.\d+)\.value\.", r"\1.to_v."),
    (r"(mid_block\.attentions\.\d+)\.proj_attn\.", r"\1.to_out.0."),
]


def rename_legacy_vae_keys(state: dict) -> dict:
    """Map the VAE mid-block attention's old names (query, key, value,
    proj_attn) to the current ones (to_q, to_k, to_v, to_out.0)."""
    out = {}
    for key, val in state.items():
        for pat, rep in _LEGACY_VAE:
            key = re.sub(pat, rep, key)
        out[key] = val
    return out


def _leaves(tree, path=()):
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, path + (name,))
        else:
            yield path + (name,), val


def jax_params_to_state_dict(params: dict, model: str) -> dict:
    """JAX parameter tree (nested dicts of arrays) of the "vae", "unet" or
    "brushnet" -> the port's state dict {diffusers key: f32 tensor}."""
    rules = _RULES[model]
    out = {}
    for path, arr in _leaves(params):
        *mods, leaf = path
        name = ".".join(mods)
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
                if _CONV1X1.search(name):
                    a = a[:, :, None, None]
            else:
                raise ValueError(f"kernel {'/'.join(path)} has shape {a.shape}")
            key = name + ".weight"
        elif leaf == "scale":
            key = name + ".weight"
        elif leaf == "bias":
            key = name + ".bias"
        else:
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        out[key] = torch.tensor(a)
    return out
