"""Flow-guided image propagation (ProPainter's non-learnable bidirectional
propagation), port of videovanish_tpu/models/propainter/propagation.py.

A backward pass (future to past) and then a forward pass over the backward
pass's output; a pixel fills only where the current frame has a hole, the
flows pass the forward-backward consistency check, and the source pixel is
itself valid. Frames warp nearest, masks bilinear, and every decision mask
is binarised at 0.1. The thresholds are discontinuous, so the arithmetic
is the JAX function's, step for step. Images (T, C, H, W), masks
(T, 1, H, W), flows (T-1, 2, H, W).
"""
from __future__ import annotations

import torch

from videovanish_tpu_torch.ops.flow import flow_warp, prop_warp


def binary_mask(m, th: float = 0.1):
    return (m > th).float()


def fb_consistency_check(flow_fw, flow_bw, alpha1: float = 0.01,
                         alpha2: float = 0.5):
    """1 where the backward flow, warped by the forward flow, cancels it."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    flow_diff = flow_fw + flow_bw_warped
    norm = (flow_fw ** 2).sum(1, keepdim=True) \
        + (flow_bw_warped ** 2).sum(1, keepdim=True)
    thresh = alpha1 * norm + alpha2
    return ((flow_diff ** 2).sum(1, keepdim=True) < thresh).float()


def _one_direction(feats, masks, flows_prop, flows_check,
                   interpolation: str):
    """Step 0 passes frame 0 through; step i > 0 warps the previous step's
    output by flows_prop[i-1] and checks it against flows_check[i-1]."""
    f, m = feats[:1], masks[:1]
    out_f, out_m = [f], [m]
    for i in range(1, feats.shape[0]):
        f_p, f_c = flows_prop[i - 1:i], flows_check[i - 1:i]
        feat_cur, mask_cur = feats[i:i + 1], masks[i:i + 1]
        feat_warp, mask_warp_raw, chk_warp = prop_warp(f, m, f_c, f_p,
                                                       interpolation)
        flow_diff = f_p + chk_warp
        norm = (f_p ** 2).sum(1, keepdim=True) \
            + (chk_warp ** 2).sum(1, keepdim=True)
        valid = ((flow_diff ** 2).sum(1, keepdim=True)
                 < 0.01 * norm + 0.5).float()
        mask_warp = binary_mask(mask_warp_raw)
        union = binary_mask(mask_cur * valid * (1.0 - mask_warp))
        f = union * feat_warp + (1.0 - union) * feat_cur
        m = binary_mask(mask_cur * (1.0 - valid * (1.0 - mask_warp)))
        out_f.append(f)
        out_m.append(m)
    return torch.cat(out_f), torch.cat(out_m)


def image_propagation(frames, masks, flows_f, flows_b,
                      interpolation: str = "nearest"):
    """frames (T, C, H, W) masked content; masks (T, 1, H, W), 1 = hole;
    flows_f (T-1, 2, H, W) flow t -> t+1, flows_b flow t+1 -> t. Returns
    (propagated frames, updated masks)."""
    masks = masks.float()
    # the backward pass runs over the reversed frames with the forward flows
    b_f, b_m = _one_direction(frames.flip(0), masks.flip(0), flows_f.flip(0),
                              flows_b.flip(0), interpolation)
    return _one_direction(b_f.flip(0), b_m.flip(0), flows_b, flows_f,
                          interpolation)
