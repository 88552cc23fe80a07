"""run_infill_on_frames: the inpainting pipeline (port of
videovanish_tpu/pipeline/infill.py).

Same signature and defaults as the JAX package, plus `device`. Every step
runs on the device: binarize + dilate the masks, the ProPainter prior
(unless one is passed in), DiffuEraser, rescale and feathered composite;
the prior stays on the device at its internal resolution, and only the
finished frames come back to the host.

The models are lazy singletons, as in the reference, built with the
weights of the config's checkpoint files where they exist.
"""
from __future__ import annotations

import numpy as np
import torch

from videovanish_tpu_torch.config import default_config
from videovanish_tpu_torch.models.diffueraser.model import (
    DiffuEraser, stack_frames,
)
from videovanish_tpu_torch.models.diffueraser.model import (
    load_checkpoint as load_diffueraser_checkpoint,
)
from videovanish_tpu_torch.models.propainter.model import (
    Propainter, load_checkpoints as load_propainter_checkpoints,
)
from videovanish_tpu_torch.ops.composite import feathered_composite
from videovanish_tpu_torch.ops.morphology import binarize_and_dilate

# lazy model singletons
video_inpainting_sd = None
propainter = None
last_ckpt = None
_config = None


def _get_config():
    global _config
    if _config is None:
        _config = default_config()
    return _config


def set_config(cfg) -> None:
    """Install a non-default config (tests use tiny_config); drops the
    model singletons."""
    global _config, video_inpainting_sd, propainter, last_ckpt
    _config = cfg
    video_inpainting_sd = None
    propainter = None
    last_ckpt = None


def get_model(ckpt: str = "2-Step", device="cuda"):
    """The DiffuEraser singleton for `ckpt` on `device`, built on first use
    with the weights of the config's checkpoint files (`load_checkpoint`);
    seeded random where a file does not exist."""
    global video_inpainting_sd, last_ckpt
    if (video_inpainting_sd is None or last_ckpt != ckpt
            or video_inpainting_sd.device != torch.device(device)):
        video_inpainting_sd = None  # the old model's memory goes first
        cfg = _get_config().diffueraser
        video_inpainting_sd = DiffuEraser(
            config=cfg, ckpt=ckpt, device=device,
            params=load_diffueraser_checkpoint(cfg))
        last_ckpt = ckpt
    return video_inpainting_sd


def get_propainter(device="cuda"):
    """The Propainter singleton on `device`, built on first use with the
    weights of the config's three checkpoint files (`load_checkpoints`);
    seeded random where a file does not exist."""
    global propainter
    if propainter is None or propainter.device != torch.device(device):
        propainter = None
        cfg = _get_config().propainter
        propainter = Propainter(config=cfg, device=device,
                                params=load_propainter_checkpoints(cfg))
    return propainter


def _prior(frames, dilated, prog, device):
    """The ProPainter prior of (T, H, W, 3) frames under (T, H, W) dilated
    masks: (T, h, w, 3) uint8 on the device at its internal resolution."""
    cfg = _get_config().propainter
    return get_propainter(device).forward(
        frames, dilated, ref_stride=cfg.ref_stride,
        neighbor_length=cfg.neighbor_length,
        subvideo_length=cfg.subvideo_length, mask_dilation=0,
        progress=prog, return_device=True)


def dilate_masks(mask_frames, mask_dilation_iter: int, device="cuda"):
    """Binarize (any channel > 0) and dilate the mask stack on `device`;
    returns (T, H, W) uint8 in {0, 255}."""
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
    if preview:
        tier = _get_config().diffueraser.preview_img_size
        if tier:
            max_img_size = min(max_img_size, tier)
    with torch.inference_mode():
        frames = stack_frames(frames_rgb, device)
        prog(5, "dilating frames")
        if dilated_masks is not None:
            dilated = stack_frames(dilated_masks, device)
        else:
            dilated = dilate_masks(mask_frames, mask_dilation_iter, device)

        prog(10, "loading weights")
        model = get_model(ckpt or "2-Step", device)
        if propainer_frames is None:
            prog(20, "running propainter prior")
            propainer_frames = _prior(frames, dilated, prog, device)
        prog(50, "running DiffuEraser")
        inpainted = model.forward(
            frames, dilated, propainer_frames, max_img_size=max_img_size,
            mask_dilation_iter=0, guidance_scale=None, progress=prog,
            # alpha is 0 beyond feather_px outside the dilated mask, so only
            # the mask's bounding box (+ a feather-covering margin) of the
            # model output is used
            output_roi="auto" if keep_unmasked_original else None,
            roi_margin=16 + int(np.ceil(feather_px)),
            frame_offset=frame_offset, latent_carry=latent_carry,
            return_latent_tail=return_latent_tail)
        carry = None
        if return_latent_tail:
            inpainted, carry = inpainted
            frames = frames[:inpainted.shape[0]]
            dilated = dilated[:inpainted.shape[0]]
        if on_device_idle is not None:
            on_device_idle()
        prog(90, "resizing and merging finished frames")
        out = feathered_composite(inpainted, frames, dilated,
                                  float(feather_px),
                                  keep_unmasked_original=keep_unmasked_original)
        out_np = out.cpu().numpy()
    prog(100, "done")
    result = [out_np[i] for i in range(out_np.shape[0])]
    if return_latent_tail:
        return result, tuple(t.cpu().numpy() for t in carry)
    return result
