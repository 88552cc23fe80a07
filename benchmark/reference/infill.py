"""The infill request on the reference: what the port's
`pipeline.infill.run_infill_on_frames` does at its defaults with the prior
computed (dilate, ProPainter prior, DiffuEraser, feathered composite), on
the frozen copy in f32 with plain attention. Two calls, so that a counter
can tell the prior's work from DiffuEraser's."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.vvref.ops.composite import feathered_composite
from benchmark.reference.vvref.ops.morphology import binarize_and_dilate


def prior(pp, frames: np.ndarray, masks: np.ndarray, icfg, pcfg, device):
    """(frames, dilated masks (T, H, W) uint8, prior (T, h, w, 3) uint8),
    all on the device."""
    with torch.inference_mode():
        fr = torch.from_numpy(frames).to(device)
        dilated = binarize_and_dilate(
            torch.from_numpy(masks[..., None]).to(device),
            icfg.mask_dilation_iter)
        pri = pp.forward(fr, dilated, ref_stride=pcfg.ref_stride,
                         neighbor_length=pcfg.neighbor_length,
                         subvideo_length=pcfg.subvideo_length,
                         mask_dilation=0, return_device=True)
        return fr, dilated, pri


def diffuerase(de, fr, dilated, pri, icfg) -> np.ndarray:
    """The output (T, H, W, 3) uint8 of one request (numpy)."""
    with torch.inference_mode():
        inpainted = de.forward(
            fr, dilated, pri, max_img_size=icfg.max_img_size,
            mask_dilation_iter=0, guidance_scale=None,
            output_roi="auto" if icfg.keep_unmasked_original else None,
            roi_margin=16 + int(math.ceil(icfg.feather_px)))
        out = feathered_composite(
            inpainted, fr, dilated, float(icfg.feather_px),
            keep_unmasked_original=icfg.keep_unmasked_original)
        return out.cpu().numpy()
