"""The VACE infill request on the reference: what the port's
`pipeline.infill.run_infill_on_frames` does with `infill.model = "vace"`
(dilate, Wan2.1-VACE at the inference size, feathered composite), on the
frozen plain reference in f32 with plain attention."""
from __future__ import annotations

import torch

from benchmark.reference.vvref.models.wan import model as wan
from benchmark.reference.vvref.ops.composite import feathered_composite
from benchmark.reference.vvref.ops.morphology import binarize_and_dilate
from benchmark.reference.vvref.ops.resize import plan_long_side


def inference_size(H: int, W: int, wcfg: dict, icfg: dict) -> tuple:
    """(h, w): the long side at most the smaller of the call's and Wan's
    cap, each side a multiple of 16 (the VAE's stride times the patch)."""
    return plan_long_side(H, W, min(icfg["max_img_size"],
                                    wcfg["max_img_size"]), 16)


def request(dit, vae, frames, masks, wcfg: dict, icfg: dict, context,
            context_null, device) -> tuple:
    """(output (T, H, W, 3) uint8 numpy, final latents, dilated masks
    (T, H, W) uint8 on the device) of one request: frames (T, H, W, 3)
    and masks (T, H, W) uint8 numpy."""
    caught = []
    with torch.inference_mode():
        fr = torch.from_numpy(frames).to(device)
        dilated = binarize_and_dilate(
            torch.from_numpy(masks[..., None]).to(device),
            icfg["mask_dilation_iter"])
        size = inference_size(fr.shape[1], fr.shape[2], wcfg, icfg)
        inpainted = wan.inpaint(dit, vae, fr, dilated, wcfg, context,
                                context_null, size, catch=caught.append)
        out = feathered_composite(
            inpainted, fr, dilated, float(icfg["feather_px"]),
            keep_unmasked_original=icfg["keep_unmasked_original"])
        return out.cpu().numpy(), caught[0], dilated
