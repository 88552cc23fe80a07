"""run_infill_on_frames: the inpainting pipeline (port of
videovanish_tpu/pipeline/infill.py).

Same signature and defaults as the JAX package, plus `device`. Every step
runs on the device: binarize + dilate the masks, the ProPainter prior
(unless one is passed in), DiffuEraser, rescale and feathered composite;
the prior stays on the device at its internal resolution, and only the
finished frames come back to the host.

The config's `infill.model` picks the remover. "diffueraser" (the
default) is the above. "vace" runs Wan2.1-VACE (`models/wan/`) in its
place: dilate, no prior, `WanVace.inpaint` inside the stage
`wan_denoise`, the same composite. It runs on one device and takes no
prior, no latent carry (the chunked driver) and no mesh: those raise.

The models are lazy singletons, as in the reference, built with the
weights of the config's checkpoint files where they exist. Stages are
timed as in the JAX package (`utils/observability.py`: mask_dilate,
propainter_prior, diffueraser_denoise, rescale_composite), and
VV_PROFILE_DIR traces a call.

Several cards: under torchrun (one process per card) the call goes SPMD on
its own, as the JAX package's does on a multi-device host: it joins the
process group, builds a ("data", "model") mesh over every rank, and the
models shard their frames over "data" (`_get_mesh`). Every rank passes the
same frames and gets the whole result back. VV_MESH=0 keeps each process
on its own card; VV_MODEL_PARALLEL=k sets the model axis.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from videovanish_tpu_torch.config import default_config
from videovanish_tpu_torch.core.mesh import (
    data_coords, initialize_distributed, make_mesh,
)
from videovanish_tpu_torch.models.diffueraser.model import (
    DiffuEraser, stack_frames,
)
from videovanish_tpu_torch.models.diffueraser.model import (
    load_checkpoint as load_diffueraser_checkpoint,
)
from videovanish_tpu_torch.models.propainter.model import (
    Propainter, load_checkpoints as load_propainter_checkpoints,
)
from videovanish_tpu_torch.models.wan.model import WanVace
from videovanish_tpu_torch.ops.composite import feathered_composite
from videovanish_tpu_torch.ops.morphology import binarize_and_dilate
from videovanish_tpu_torch.utils.observability import (
    maybe_profile, stage_timer,
)

# lazy model singletons
video_inpainting_sd = None
propainter = None
wan = None
last_ckpt = None
_config = None
_mesh = "unset"  # resolved on first use: a DeviceMesh or None


def _get_config():
    global _config
    if _config is None:
        _config = default_config()
    return _config


def set_config(cfg) -> None:
    """Install a non-default config (tests use tiny_config); drops the
    model singletons and the mesh decision."""
    global _config, video_inpainting_sd, propainter, wan, last_ckpt, _mesh
    _config = cfg
    video_inpainting_sd = None
    propainter = None
    wan = None
    last_ckpt = None
    _mesh = "unset"


def set_mesh(mesh) -> None:
    """Install a mesh (a DeviceMesh, or None for one device) in place of
    `_get_mesh`'s decision; drops the model singletons."""
    global video_inpainting_sd, propainter, last_ckpt, _mesh
    video_inpainting_sd = None
    propainter = None
    last_ckpt = None
    _mesh = mesh


def _get_mesh(device="cuda"):
    """The mesh policy of the JAX package's `_get_mesh`: a ("data",
    "model") mesh over every rank when the process runs in a
    torch.distributed world of more than one rank (joined here from
    torchrun's or the VV_ variables, `initialize_distributed`), None in a
    lone process. VV_MESH=0 forces None; VV_MODEL_PARALLEL=k sets the
    model axis (default: the config's). A mesh that cannot be built
    raises."""
    global _mesh
    if isinstance(_mesh, str):
        mode = os.environ.get("VV_MESH", "auto")
        if mode not in ("auto", "0"):
            raise ValueError(f"VV_MESH={mode!r}: expected 'auto' or '0'")
        device = torch.device(device)
        if mode == "0" or not initialize_distributed(
                device_type=device.type) \
                or torch.distributed.get_world_size() == 1:
            _mesh = None
        else:
            mcfg = _get_config().mesh
            mp = int(os.environ.get("VV_MODEL_PARALLEL", mcfg.model))
            _mesh = make_mesh(device.type, model_parallel=mp,
                              data=mcfg.data)
    return _mesh


def _clip_for_mesh(cfg, mesh):
    """The DiffuEraser config with its window length rounded up to a
    multiple of the mesh's data axis, so that every window shards (a
    window that does not divide runs whole on every rank)."""
    n = data_coords(mesh)[1]
    if n > 1 and cfg.clip_length % n:
        cfg = dataclasses.replace(
            cfg, clip_length=-(-cfg.clip_length // n) * n)
    return cfg


def get_model(ckpt: str = "2-Step", device="cuda"):
    """The DiffuEraser singleton for `ckpt` on `device`, built on first use
    with the weights of the config's checkpoint files (`load_checkpoint`);
    seeded random where a file does not exist. Under a mesh (`_get_mesh`)
    its frames shard over "data"."""
    global video_inpainting_sd, last_ckpt
    mesh = _get_mesh(device)
    if (video_inpainting_sd is None or last_ckpt != ckpt
            or video_inpainting_sd.device != torch.device(device)):
        video_inpainting_sd = None  # the old model's memory goes first
        cfg = _get_config().diffueraser
        video_inpainting_sd = DiffuEraser(
            config=_clip_for_mesh(cfg, mesh), ckpt=ckpt, device=device,
            params=load_diffueraser_checkpoint(cfg), mesh=mesh)
        last_ckpt = ckpt
    return video_inpainting_sd


def get_propainter(device="cuda"):
    """The Propainter singleton on `device`, built on first use with the
    weights of the config's three checkpoint files (`load_checkpoints`);
    seeded random where a file does not exist. Under a mesh its work
    shards over "data"."""
    global propainter
    mesh = _get_mesh(device)
    if propainter is None or propainter.device != torch.device(device):
        propainter = None
        cfg = _get_config().propainter
        propainter = Propainter(config=cfg, device=device,
                                params=load_propainter_checkpoints(cfg),
                                mesh=mesh)
    return propainter


def get_wan(device="cuda"):
    """The WanVace singleton on `device`, built on first use with seeded
    random weights (the published files are not read yet)."""
    global wan
    if wan is None or wan.device != torch.device(device):
        wan = None
        wan = WanVace(config=_get_config().wan, device=device)
    return wan


def _vace_refusals(propainer_frames, frame_offset, latent_carry,
                   return_latent_tail, device) -> None:
    """What the "vace" route does not take raises here."""
    if propainer_frames is not None:
        raise ValueError("infill model 'vace' takes no prior: it "
                         "generates the hole from the frames alone")
    if frame_offset or latent_carry is not None or return_latent_tail:
        raise ValueError("infill model 'vace' runs a clip in one pass: the "
                         "chunked driver's latent carry is DiffuEraser's")
    if _get_mesh(device) is not None:
        raise ValueError("infill model 'vace' runs on one device; the "
                         "mesh path is DiffuEraser's (VV_MESH=0)")


def _prior(frames, dilated, prog, device):
    """The ProPainter prior of (T, H, W, 3) frames under (T, H, W) dilated
    masks: (T, h, w, 3) uint8 on the device at its internal resolution."""
    cfg = _get_config().propainter
    pp = get_propainter(device)
    with stage_timer("propainter_prior", frames=int(frames.shape[0])):
        return pp.forward(
            frames, dilated, ref_stride=cfg.ref_stride,
            neighbor_length=cfg.neighbor_length,
            subvideo_length=cfg.subvideo_length, mask_dilation=0,
            progress=prog, return_device=True)


def dilate_masks(mask_frames, mask_dilation_iter: int, device="cuda"):
    """Binarize (any channel > 0) and dilate the mask stack on `device`;
    returns (T, H, W) uint8 in {0, 255}."""
    with stage_timer("mask_dilate", frames=len(mask_frames)):
        masks = stack_frames(mask_frames, device)
        if masks.dim() == 3:
            masks = masks[..., None]
        return binarize_and_dilate(masks, mask_dilation_iter)


def compute_prior(frames_rgb, mask_frames, mask_dilation_iter: int = 8,
                  ckpt: str = "2-Step", prog=None, device="cuda"):
    """Dilate the masks and run the ProPainter prior, for
    `run_infill_on_frames`'s `dilated_masks` and `propainer_frames`:
    returns ((T, H, W) uint8 {0, 255} dilated masks, (T, h, w, 3) uint8
    prior), both on `device`. `ckpt` is accepted for the reference's
    signature (the prior does not depend on it)."""
    prog = prog or (lambda *_a, **_k: None)
    device = torch.device(device)
    with torch.inference_mode():
        frames = stack_frames(frames_rgb, device)
        dilated = dilate_masks(mask_frames, mask_dilation_iter, device)
        return dilated, _prior(frames, dilated, prog, device)


def run_infill_on_frames(frames_rgb, mask_frames, mask_dilation_iter: int = 8,
                         ckpt: str = "2-Step", propainer_frames=None,
                         max_img_size: int = 960,
                         keep_unmasked_original: bool = True,
                         feather_px: int = 3, prog=None,
                         frame_offset: int = 0, latent_carry=None,
                         return_latent_tail: int = 0,
                         dilated_masks=None, on_device_idle=None,
                         preview: bool = False, device="cuda"):
    """Remove the masked objects from frames_rgb.

    frames_rgb: list of (H, W, 3) RGB uint8
    mask_frames: list of (H, W, 3) or (H, W) uint8; any nonzero channel =
        hole
    propainer_frames: optional precomputed prior frames (any resolution);
        None computes the ProPainter prior
    frame_offset / latent_carry / return_latent_tail: cross-chunk latent
        blending hooks (see DiffuEraser.forward); with return_latent_tail
        > 0 the last n frames are withheld and (frames, carry) returned
    dilated_masks: optional precomputed (T, H, W) uint8 {0, 255} dilated
        masks, which skips the dilation
    on_device_idle: optional zero-argument callback fired once the model's
        outputs are complete, before the composite
    preview: cap the inference resolution at the config's preview size
    device: where everything runs ("cuda" by default; "cpu" on request)
    Returns a list of (H, W, 3) RGB uint8 frames at the input resolution.
    """
    prog = prog or (lambda *_a, **_k: None)
    device = torch.device(device)
    remover = _get_config().infill.model
    if remover not in ("diffueraser", "vace"):
        raise ValueError(f"infill model {remover!r}: expected "
                         "'diffueraser' or 'vace'")
    if remover == "vace":
        _vace_refusals(propainer_frames, frame_offset, latent_carry,
                       return_latent_tail, device)
    if preview:
        tier = _get_config().diffueraser.preview_img_size
        if tier:
            max_img_size = min(max_img_size, tier)
    with torch.inference_mode(), maybe_profile():
        frames = stack_frames(frames_rgb, device)
        T = int(frames.shape[0])
        prog(5, "dilating frames")
        if dilated_masks is not None:
            dilated = stack_frames(dilated_masks, device)
        else:
            dilated = dilate_masks(mask_frames, mask_dilation_iter, device)

        prog(10, "loading weights")
        if remover == "vace":
            with stage_timer("wan_denoise", frames=T):
                inpainted = get_wan(device).inpaint(
                    frames, dilated, max_img_size, progress=prog)
        else:
            inpainted = _diffuerase(
                frames, dilated, propainer_frames, ckpt, max_img_size,
                keep_unmasked_original, feather_px, prog, frame_offset,
                latent_carry, return_latent_tail, device)
        carry = None
        if return_latent_tail:
            inpainted, carry = inpainted
            frames = frames[:inpainted.shape[0]]
            dilated = dilated[:inpainted.shape[0]]
        if on_device_idle is not None:
            on_device_idle()
        prog(90, "resizing and merging finished frames")
        with stage_timer("rescale_composite", frames=T):
            out = feathered_composite(
                inpainted, frames, dilated, float(feather_px),
                keep_unmasked_original=keep_unmasked_original)
            out_np = out.cpu().numpy()
    prog(100, "done")
    result = [out_np[i] for i in range(out_np.shape[0])]
    if return_latent_tail:
        return result, tuple(t.cpu().numpy() for t in carry)
    return result


def _diffuerase(frames, dilated, propainer_frames, ckpt, max_img_size,
                keep_unmasked_original, feather_px, prog, frame_offset,
                latent_carry, return_latent_tail, device):
    """The "diffueraser" remover: the prior (unless passed in), then
    DiffuEraser.forward's result."""
    T = int(frames.shape[0])
    model = get_model(ckpt or "2-Step", device)
    if propainer_frames is None:
        prog(20, "running propainter prior")
        propainer_frames = _prior(frames, dilated, prog, device)
    prog(50, "running DiffuEraser")
    with stage_timer("diffueraser_denoise", frames=T):
        return model.forward(
            frames, dilated, propainer_frames, max_img_size=max_img_size,
            mask_dilation_iter=0, guidance_scale=None, progress=prog,
            # alpha is 0 beyond feather_px outside the dilated mask, so
            # only the mask's bounding box (+ a feather-covering margin)
            # of the model output is used
            output_roi="auto" if keep_unmasked_original else None,
            roi_margin=16 + int(np.ceil(feather_px)),
            frame_offset=frame_offset, latent_carry=latent_carry,
            return_latent_tail=return_latent_tail)
