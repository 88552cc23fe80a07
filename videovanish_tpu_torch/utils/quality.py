"""Video quality metrics: PSNR and SSIM (port of
videovanish_tpu/utils/quality.py), as tensor code in float64 on the
frames' device (numpy arrays go to the CPU).

PSNR is the standard definition on uint8 video (MAX = 255). SSIM is Wang
et al. 2004 with the scikit-image / MATLAB parameters: an 11x11 gaussian
window of sigma 1.5 ('valid' filtering), K1 = 0.01, K2 = 0.03, per channel
and averaged.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _f64(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device or t.device, dtype=torch.float64)


def _pair(a, b):
    a = _f64(a)
    b = _f64(b, a.device)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return a, b


def _psnr_of_mse(mse: float, max_val: float) -> float:
    if mse == 0.0:
        return float("inf")
    return float(10.0 * math.log10(max_val * max_val / mse))


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio of two images or videos of any shape;
    +inf for identical inputs."""
    a, b = _pair(a, b)
    return _psnr_of_mse(float(((a - b) ** 2).mean()), max_val)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float64, device=device) \
        - (size - 1) / 2.0
    k = torch.exp(-(r * r) / (2.0 * sigma * sigma))
    return k / k.sum()


def _filter2_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filter over the last two axes: along the width,
    then the height, one tap at a time."""
    n = k.numel()
    w = img.shape[-1] - n + 1
    acc = torch.zeros(img.shape[:-1] + (w,), dtype=img.dtype,
                      device=img.device)
    for i in range(n):
        acc += k[i] * img[..., i:i + w]
    h = acc.shape[-2] - n + 1
    res = torch.zeros(acc.shape[:-2] + (h, w), dtype=img.dtype,
                      device=img.device)
    for i in range(n):
        res += k[i] * acc[..., i:i + h, :]
    return res


def _ssim_frames(a: torch.Tensor, b: torch.Tensor, max_val, win_size, sigma,
                 k1, k2) -> torch.Tensor:
    """SSIM of each frame of (N, H, W, C) float64 stacks: (N,)."""
    if min(a.shape[1], a.shape[2]) < win_size:
        raise ValueError(f"image smaller than the {win_size}x{win_size} "
                         "SSIM window")
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    k = _gaussian_kernel(win_size, sigma, a.device)
    x, y = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)  # (N, C, H, W)
    mu_x = _filter2_sep(x, k)
    mu_y = _filter2_sep(y, k)
    xx = _filter2_sep(x * x, k) - mu_x * mu_x
    yy = _filter2_sep(y * y, k) - mu_y * mu_y
    xy = _filter2_sep(x * y, k) - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (xx + yy + c2)
    return (num / den).mean(dim=(2, 3)).mean(dim=1)


def ssim(a, b, max_val: float = 255.0, win_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean structural similarity of two images, (H, W) or (H, W, C):
    scikit-image's `structural_similarity` with `gaussian_weights=True,
    use_sample_covariance=False`, channels scored apart and averaged."""
    a, b = _pair(a, b)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    return float(_ssim_frames(a[None], b[None], max_val, win_size, sigma,
                              k1, k2)[0])


def video_metrics(frames_a, frames_b, max_val: float = 255.0,
                  batch: int = 8) -> dict:
    """PSNR / SSIM summary of two equal-length frame sequences (lists of
    arrays or tensors, or stacked tensors), `batch` frames at a time:
    {"psnr": PSNR of the mean MSE over all frames (+inf only if every frame
    is identical, so one untouched frame cannot hide the others),
    "psnr_min": the worst frame's, "ssim": the frames' mean, "ssim_min":
    the worst frame's, "frames": N}."""
    n = len(frames_a)
    if n != len(frames_b):
        raise ValueError(f"frame count mismatch: {n} vs {len(frames_b)}")
    if n == 0:
        raise ValueError("empty video")
    mses, ssims = [], []
    for i in range(0, n, batch):
        a, b = _pair(torch.stack([_f64(f) for f in frames_a[i:i + batch]]),
                     torch.stack([_f64(f) for f in frames_b[i:i + batch]]))
        mses.append(((a - b) ** 2).flatten(1).mean(dim=1))
        if a.dim() == 3:
            a, b = a[..., None], b[..., None]
        ssims.append(_ssim_frames(a, b, max_val, 11, 1.5, 0.01, 0.03))
    mses = torch.cat(mses).cpu().numpy()
    ssims = torch.cat(ssims).cpu().numpy()
    return {
        "psnr": _psnr_of_mse(float(np.mean(mses)), max_val),
        "psnr_min": min(_psnr_of_mse(float(m), max_val) for m in mses),
        "ssim": float(np.mean(ssims)),
        "ssim_min": float(np.min(ssims)),
        "frames": n,
    }
