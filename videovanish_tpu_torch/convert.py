"""Weights from the JAX package's parameter trees into the port.

The port's modules use the diffusers and ProPainter checkpoint key names
and shapes, so a published state dict loads with `load_state_dict`. Parameters held as JAX
(flax) trees -- nested dicts of numpy arrays, as videovanish_tpu's
`core/convert.convert_state_dict` produces them from those checkpoints --
come across with `jax_params_to_state_dict`, which inverts that
conversion: the name rules (VAE_RULES, UNET_RULES, UNET_SPECIALS,
RAFT_RULES, FLOWCOMP_RULES, PROPAINTER_RULES; SAM2_RULES, SAM2_SPECIALS and
sam2_fb_preprocess for "sam2", see `_sam2_state_dict`) and the leaf
transforms

  conv kernel   (kh, kw, I, O) -> (O, I, kh, kw), grouped and depthwise
                                  kernels (kh, kw, I/g, O) alike
  conv3d kernel (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
  dense kernel  (I, O)         -> (O, I); (O, I, 1, 1) for the spatial
                                  transformers' proj_in / proj_out
  norm scale                   -> weight
  running_mean / running_var   -> kept (frozen batch norms)

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
# ProPainter's three networks: the JAX modules fold a list index into the
# scope name (layer1_0, conv_offset_2, fc1_0) and hold each propagation
# direction's modules in a scanned step (step_backward_ ...)
_RAFT_NAME_RULES = [
    (r"(^|\.)layer([123])_([01])\b", r"\1layer\2.\3"),
    (r"\.downsample_conv\b", ".downsample.0"),
    (r"\.downsample_norm\b", ".downsample.1"),
    (r"\.mask_([02])\b", r".mask.\1"),
]
_PROP_STEP_RULES = [
    (r"\.step_(\w+?)\.deform_align\.conv_offset_(\d)\b",
     r".deform_align.\1.conv_offset.\2"),
    (r"\.step_(\w+?)\.deform_align\b", r".deform_align.\1"),
    (r"\.step_(\w+?)\.backbone_(\d)\b", r".backbone.\1.\2"),
]
_FLOWCOMP_NAME_RULES = _PROP_STEP_RULES + [
    (r"^(downsample|encoder[12]|mid_dilation|decoder[12]|upsample)_(\d)\b",
     r"\1.\2"),
    (r"\.conv([12])_0\b", r".conv\1.0"),
]
_GENERATOR_NAME_RULES = _PROP_STEP_RULES + [
    (r"(^|\.)layers_(\d+)\b", r"\1layers.\2"),
    (r"^decoder_(\d)\b", r"decoder.\1"),
    (r"\.fuse_(\d)\b", r".fuse.\1"),
    (r"\.transformer_(\d+)\b", r".transformer.\1"),
    (r"\.fc1_0\b", ".fc1.0"),
    (r"\.fc2_1\b", ".fc2.1"),
]
_RULES = {"unet": _UNET_NAME_RULES, "brushnet": _BRUSHNET_NAME_RULES,
          "vae": _VAE_NAME_RULES, "raft": _RAFT_NAME_RULES,
          "flow_comp": _FLOWCOMP_NAME_RULES,
          "generator": _GENERATOR_NAME_RULES}
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


# SAM2: JAX module path (dotted) -> the published checkpoint's, in order
_SAM2_NAME_RULES = [
    (r"^hiera\b", "image_encoder.trunk"),
    (r"^neck\.convs_(\d+)$", r"image_encoder.neck.convs.\1.conv"),
    (r"^prompt_encoder\b", "sam_prompt_encoder"),
    (r"^decoder\.obj_ptr_proj\b", "obj_ptr_proj"),
    (r"^decoder\b", "sam_mask_decoder"),
    (r"\.mlp_fc([12])$", lambda m: f".mlp.layers.{int(m.group(1)) - 1}"),
    (r"\.mlp_lin([12])$", r".mlp.lin\1"),
    (r"\.output_upscaling_1$", ".output_upscaling.3"),
    (r"\.output_upscaling_0$", ".output_upscaling.0"),
    (r"\.output_upscaling_ln$", ".output_upscaling.1"),
    (r"\.conv_s4$", ".conv_s0"),
    (r"\.conv_s8$", ".conv_s1"),
    # the mask downsampler's Sequential: (conv, norm, GELU) x 4, final conv
    (r"\.mask_downsampler_layers_(\d+)\.conv$",
     lambda m: f".mask_downsampler.encoder.{3 * int(m.group(1))}"),
    (r"\.mask_downsampler_layers_(\d+)\.layer_norm$",
     lambda m: f".mask_downsampler.encoder.{3 * int(m.group(1)) + 1}"),
    (r"\.mask_downsampler_final_conv$", ".mask_downsampler.encoder.12"),
    (r"\.feature_projection$", ".pix_feat_proj"),
    (r"^memory_encoder\.projection$", "memory_encoder.out_proj"),
    (r"\.memory_fuser_layers_(\d+)", r".fuser.layers.\1"),
    (r"(\.fuser\.layers\.\d+)\.layer_norm$", r"\1.norm"),
    (r"\.depthwise_conv$", ".dwconv"),
    (r"\.pointwise_conv([12])$", r".pwconv\1"),
    (r"(^|\.)(blocks|layers|output_hypernetworks_mlps)_(\d+)(?=\.|$)",
     r"\1\2.\3"),
]
# top-level SAM2 leaves: JAX name -> (checkpoint key, shape transform)
_SAM2_TOP = {
    "maskmem_tpos_enc": ("maskmem_tpos_enc",
                         lambda a: a.reshape(a.shape[0], 1, 1, a.shape[1])),
    "no_memory_embedding": ("no_mem_embed", lambda a: a),
    "no_object_pointer": ("no_obj_ptr", lambda a: a.reshape(1, -1)),
    "occlusion_spatial_embedding": ("no_obj_embed_spatial",
                                    lambda a: a.reshape(1, -1)),
}


def _sam2_state_dict(params: dict) -> dict:
    """Inverse of the JAX package's SAM2 conversion (sam2_fb_preprocess,
    SAM2_RULES, SAM2_SPECIALS): position embeddings NHWC -> NCHW, the
    stacked point embeddings split into four (1, C) tables, the (C,)
    embedding vectors and the video-level vectors back to (1, C), the
    temporal encoding to (n, 1, 1, m), transposed-conv kernels (kh, kw, I,
    O) -> (I, O, kh, kw), the 1x1 high-resolution skips held as dense
    kernels -> (O, I, 1, 1) convs, and the ConvNeXt layer scale `scale` ->
    `gamma`."""
    out = {}
    for path, arr in _leaves(params):
        *mods, leaf = path
        a = np.asarray(arr, dtype=np.float32)
        if not mods:
            key, fn = _SAM2_TOP[leaf]
            out[key] = torch.tensor(np.ascontiguousarray(fn(a)))
            continue
        name = ".".join(mods)
        for pat, rep in _SAM2_NAME_RULES:
            name = re.sub(pat, rep, name)
        if leaf == "point_embeddings":
            for i in range(a.shape[0]):
                out[f"{name}.point_embeddings.{i}.weight"] = \
                    torch.tensor(a[i:i + 1])
            continue
        if leaf in ("pos_embed", "pos_embed_window"):
            key, a = f"{name}.{leaf}", a.transpose(0, 3, 1, 2)
        elif leaf in ("iou_token", "mask_tokens", "obj_score_token",
                      "not_a_point_embed", "no_mask_embed"):
            key, a = f"{name}.{leaf}.weight", a.reshape(-1, a.shape[-1])
        elif leaf == "positional_encoding_gaussian_matrix":
            key = f"{name}.{leaf}"
        elif leaf == "kernel":
            key = name + ".weight"
            if re.search(r"\.output_upscaling\.[03]$", name):
                a = a.transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif re.search(r"\.conv_s[01]$", name):
                a = a.T[:, :, None, None]
            else:
                a = a.T
        elif leaf == "scale":
            key = name + (".gamma" if re.search(r"\.fuser\.layers\.\d+$",
                                                name) else ".weight")
        elif leaf == "bias":
            key = name + ".bias"
        else:
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        out[key] = torch.tensor(np.ascontiguousarray(a))
    return out


def jax_params_to_state_dict(params: dict, model: str) -> dict:
    """JAX parameter tree (nested dicts of arrays) of the "vae", "unet",
    "brushnet", "raft", "flow_comp", "generator" or "sam2" -> the port's
    state dict {checkpoint key: f32 tensor}."""
    if model == "sam2":
        return _sam2_state_dict(params)
    rules = _RULES[model]
    out = {}
    for path, arr in _leaves(params):
        *mods, leaf = path
        name = ".".join(mods)
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            if a.ndim == 5:
                a = a.transpose(4, 3, 0, 1, 2)
            elif a.ndim == 4:
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
        elif leaf in ("bias", "running_mean", "running_var"):
            key = f"{name}.{leaf}"
        else:
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        out[key] = torch.tensor(a)
    return out
