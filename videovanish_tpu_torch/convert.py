"""Weights into the port: published torch files, LoRA merges, and the JAX
package's parameter trees.

The port's modules use the diffusers, transformers, ProPainter and SAM2
checkpoint key names and shapes, so a published state dict loads with
`load_state_dict` after `published_state_dict`'s few fixes (the legacy
VAE attention names, the `module.` prefix of ProPainter's files, and the
keys the port holds nothing for). `parse_lora_state` and `merge_lora` fold
a LoRA file (the PCM "2-Step" distillation) into the UNet's weights, as
videovanish_tpu/core/convert.py does. Parameters held as JAX
(flax) trees -- nested dicts of numpy arrays, as videovanish_tpu's
`core/convert.convert_state_dict` produces them from those checkpoints --
come across with `jax_params_to_state_dict`, which inverts that
conversion: the name rules (VAE_RULES, UNET_RULES, UNET_SPECIALS,
RAFT_RULES, FLOWCOMP_RULES, PROPAINTER_RULES, CLIP_RULES, CLIP_SPECIAL;
SAM2_RULES, SAM2_SPECIALS and sam2_fb_preprocess for "sam2", see
`_sam2_state_dict`) and the leaf transforms

  conv kernel   (kh, kw, I, O) -> (O, I, kh, kw), grouped and depthwise
                                  kernels (kh, kw, I/g, O) alike
  conv3d kernel (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
  dense kernel  (I, O)         -> (O, I); (O, I, 1, 1) for the spatial
                                  transformers' proj_in / proj_out
  norm scale                   -> weight
  embedding table (V, C)       -> weight, as it is
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
# CLIP's text tower (transformers' CLIPTextModel names); the position
# table is a bare leaf of the tree
_CLIP_NAME_RULES = [
    (r"^layers_(\d+)\b", r"text_model.encoder.layers.\1"),
    (r"\.mlp_fc([12])$", r".mlp.fc\1"),
    (r"^(token|position)_embedding$", r"text_model.embeddings.\1_embedding"),
    (r"^final_layer_norm$", "text_model.final_layer_norm"),
]
_RULES = {"unet": _UNET_NAME_RULES, "brushnet": _BRUSHNET_NAME_RULES,
          "vae": _VAE_NAME_RULES, "raft": _RAFT_NAME_RULES,
          "flow_comp": _FLOWCOMP_NAME_RULES,
          "generator": _GENERATOR_NAME_RULES, "clip": _CLIP_NAME_RULES}
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


# published files -> the port's state dicts: ProPainter's three files
# carry DataParallel's `module.` prefix; the keys below have no home in the
# port (a position-id buffer, training-only heads, SAM2's mask-prompt path,
# which the reference's clicks and boxes never use) and are dropped
PUBLISHED_MODELS = ("vae", "unet", "brushnet", "clip", "raft",
                    "flow_completion", "propainter", "sam2")
_MODULE_PREFIX = ("raft", "flow_completion", "propainter")
_DROPS = {
    "clip": (r"^text_model\.embeddings\.position_ids$",),
    "flow_completion": (r"^edgeDetector\.",),
    "propainter": (r"^(discriminator|dis)\.",),
    "sam2": (r"^sam_prompt_encoder\.mask_downscaling\.",
             r"^mask_downsample\.", r"^no_mem_pos_enc$"),
}


def published_state_dict(state: dict, model: str) -> dict:
    """A published (or already converted) state dict of `model`, one of
    PUBLISHED_MODELS, under the port's keys: tensors kept as they are."""
    if model not in PUBLISHED_MODELS:
        raise ValueError(f"unknown model {model!r}; one of {PUBLISHED_MODELS}")
    if model == "vae":
        state = rename_legacy_vae_keys(state)
    drops = _DROPS.get(model, ())
    out = {}
    for key, val in state.items():
        if model in _MODULE_PREFIX:
            key = re.sub(r"^module\.", "", key)
        if not any(re.search(p, key) for p in drops):
            out[key] = val
    return out


# LoRA factors by key suffix: peft and new diffusers (lora_A / lora_B), the
# old diffusers attention processors (lora.down / lora.up), kohya
# (lora_down / lora_up) with its per-module alpha
_LORA_SUFFIXES = (
    (".lora_A.default.weight", "down"), (".lora_B.default.weight", "up"),
    (".lora_A.weight", "down"), (".lora_B.weight", "up"),
    (".lora.down.weight", "down"), (".lora.up.weight", "up"),
    (".lora_down.weight", "down"), (".lora_up.weight", "up"),
    (".alpha", "alpha"),
)


def parse_lora_state(state: dict, component: str = "unet") -> dict:
    """{base name: {"down", "up"[, "alpha"]}} of a LoRA state dict, for one
    tower ("unet" or "text_encoder"): "unet." / "text_encoder." prefixes,
    kohya's "lora_unet_" / "lora_te_", and a raw peft save's
    "base_model.model." routed by its module path. Base names keep the
    file's separators; merge_lora resolves them."""
    out: dict = {}
    for key, val in state.items():
        for suf, role in _LORA_SUFFIXES:
            if key.endswith(suf):
                base = key[:-len(suf)]
                break
        else:
            continue
        if base.startswith("base_model.model."):
            base = base[len("base_model.model."):]
            tower = "text_encoder" if base.startswith("text_model.") \
                else "unet"
            if component != tower:
                continue
        if base.startswith("lora_unet_"):
            if component != "unet":
                continue
            base = base[len("lora_unet_"):]
        elif re.match(r"^lora_te\d?_", base):
            if component != "text_encoder":
                continue
            base = re.sub(r"^lora_te\d?_", "", base)
        elif base.startswith("unet."):
            if component != "unet":
                continue
            base = base[len("unet."):]
        elif base.startswith("text_encoder."):
            if component != "text_encoder":
                continue
            base = base[len("text_encoder."):]
        val = torch.as_tensor(val)
        out.setdefault(base, {})[role] = \
            float(val) if role == "alpha" else val
    for base, ent in out.items():
        if "down" not in ent or "up" not in ent:
            raise ValueError(f"LoRA entry {base!r} is missing its "
                             f"{'up' if 'down' in ent else 'down'} factor")
    return out


def merge_lora(base_state: dict, lora: dict, scale: float = 1.0) -> dict:
    """A new state dict with W + scale * (alpha / r) * up @ down folded into
    every weight a LoRA entry names, computed in f32 and cast back to W's
    dtype; 2-D factors onto a 1x1 conv, (r, I, kh, kw) down factors onto a
    kxk conv. Names match underscore-insensitively (kohya flattens them).
    An entry that matches no weight raises."""
    flat = {k[:-len(".weight")].replace(".", "_"): k
            for k in base_state if k.endswith(".weight")}
    misses = [n for n in lora if n.replace(".", "_") not in flat]
    if misses:
        raise ValueError(f"{len(misses)} LoRA entries matched no base weight "
                         f"(first: {misses[:5]})")
    out = dict(base_state)
    for name, ent in lora.items():
        k = flat[name.replace(".", "_")]
        w = out[k]
        down, up = ent["down"].float(), ent["up"].float()
        r = down.shape[0]
        if up.dim() == 4 and tuple(up.shape[2:]) != (1, 1):
            raise ValueError(f"LoRA {name!r}: up factor with spatial extent "
                             f"{tuple(up.shape)} is not supported")
        delta = (up.reshape(up.shape[0], -1) @ down.reshape(r, -1)).reshape(
            (up.shape[0],) + tuple(down.shape[1:]))
        delta = delta * (scale * ent.get("alpha", float(r)) / r)
        if delta.shape != w.shape:
            if delta.numel() != w.numel():
                raise ValueError(f"LoRA {name!r}: delta {tuple(delta.shape)}"
                                 f" does not match {k!r} {tuple(w.shape)}")
            delta = delta.reshape(w.shape)
        out[k] = (w.float() + delta.to(w.device)).to(w.dtype)
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
    "brushnet", "raft", "flow_comp", "generator", "clip" or "sam2" -> the
    port's state dict {checkpoint key: f32 tensor}."""
    if model == "sam2":
        return _sam2_state_dict(params)
    rules = _RULES[model]
    out = {}
    for path, arr in _leaves(params):
        *mods, leaf = path
        if not mods:  # CLIP's position table
            mods, leaf = [leaf], "embedding"
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
        elif leaf in ("scale", "embedding"):
            key = name + ".weight"
        elif leaf in ("bias", "running_mean", "running_var"):
            key = f"{name}.{leaf}"
        else:
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        out[key] = torch.tensor(a)
    return out
