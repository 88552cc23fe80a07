"""VACE on Wan2.1 as a video remover: masked video-to-video inpainting
(github.com/Wan-Video/Wan2.1, `wan/vace.py`), PyTorch.

`WanVace.inpaint` takes frames and masks and returns the frames at the
inference size with the masked region generated:

  - resize (long side at most `max_img_size`, each side a multiple of
    16) and pad to 4k+1 frames by repeating the last one;
  - frames to [-1, 1], the masked pixels to 0 (mid-grey);
  - VACE's context latents: the Wan-VAE encodes of frames * (1 - m) and
    of frames * m (32 channels), and the mask pixel-unshuffled 8x8 to 64
    channels and taken to the latent frames by 'nearest-exact';
  - from seeded noise, `sample_steps` steps of the flow-matching UniPC
    sampler (`FlowUniPC`), each one DiT forward of the prompt's and the
    negative prompt's context together, guided by `guide_scale`;
  - the Wan-VAE decode, trimmed to the input's frames.

Stages (`utils/observability.py`): `wan.vae_encode`, `wan.step` (each
sampler step; its VV_LOG record carries tokens, ctx_len, branches and
vace_blocks), `wan.vae_decode`; the DiT's ranges `wan.dit` and `wan.vace`
lie inside each step.

Weights: {"dit", "vae"} state dicts with Wan's keys and "context" /
"context_null", the umT5 embeddings of the prompt and the negative
prompt ((L, text_dim) each). What `params` lacks takes seeded random
values at PyTorch's default scale (modulation as Wan initialises it).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videovanish_tpu_torch.config import WanConfig, default_config
from videovanish_tpu_torch.models.wan.dit import (
    LayerNorm, RMSNorm, WanDiT,
)
from videovanish_tpu_torch.models.wan.vae import RMSNorm as VaeRMSNorm
from videovanish_tpu_torch.models.wan.vae import WanVAE
from videovanish_tpu_torch.ops.resize import (
    host_resize_bilinear_u8, host_resize_nearest_2d, plan_long_side,
)
from videovanish_tpu_torch.utils.observability import stage_timer


class FlowUniPC:
    """FlowUniPCMultistepScheduler as Wan's samplers build it (order 2,
    bh2, x0-predicting, flow prediction, lower order at the last step, the
    final sigma 0) for `steps` steps at `shift`. The coefficients are f32
    scalars computed as the scheduler computes them."""

    def __init__(self, steps: int, shift: float, n: int = 1000):
        alphas = np.linspace(1, 1 / n, n)[::-1].copy()
        base = torch.from_numpy(1.0 - alphas).to(torch.float32)
        sigma_max, sigma_min = base[0].item(), base[-1].item()
        s = np.linspace(sigma_max, sigma_min, steps + 1).copy()[:-1]
        s = shift * s / (1 + (shift - 1) * s)
        self.timesteps = torch.from_numpy(s * n).to(torch.int64)
        self.sigmas = torch.from_numpy(
            np.concatenate([s, [0.0]]).astype(np.float32))
        self.outputs = [None, None]
        self.lower_order_nums = 0
        self.last_sample = None
        self.this_order = 1
        self.index = 0

    def _lambda(self, i):
        sigma = self.sigmas[i]
        return torch.log(1 - sigma) - torch.log(sigma)

    def _coefficients(self, i_t, i_s0, order, ms):
        """(sigma_t / sigma_s0, alpha_t, h_phi_1, B_h, rks, b, D1s) of an
        update from sigma[i_s0] to sigma[i_t] with the earlier outputs
        `ms` (newest first)."""
        lambda_t, lambda_s0 = self._lambda(i_t), self._lambda(i_s0)
        h = lambda_t - lambda_s0
        m0 = self.outputs[-1]
        rks, d1s = [], []
        for k in range(1, order):
            rk = (self._lambda(i_s0 - k) - lambda_s0) / h
            rks.append(rk)
            d1s.append((ms[k - 1] - m0) / rk)
        rks.append(1.0)
        rks = torch.tensor(rks)
        hh = -h
        h_phi_1 = torch.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        factorial = 1
        b_h = torch.expm1(hh)
        R, b = [], []
        for k in range(1, order + 1):
            R.append(torch.pow(rks, k - 1))
            b.append(h_phi_k * factorial / b_h)
            factorial *= k + 1
            h_phi_k = h_phi_k / hh - 1 / factorial
        ratio = self.sigmas[i_t] / self.sigmas[i_s0]
        return (ratio, 1 - self.sigmas[i_t], h_phi_1, b_h, torch.stack(R),
                torch.tensor(b), d1s)

    def _predict(self, x, order):
        i = self.index
        ratio, alpha_t, h_phi_1, b_h, _, _, d1s = self._coefficients(
            i + 1, i, order, self.outputs[-2::-1])
        x_t = ratio * x - alpha_t * h_phi_1 * self.outputs[-1]
        if d1s:  # order 2: rhos_p = 0.5
            x_t = x_t - alpha_t * b_h * (0.5 * d1s[0])
        return x_t.to(x.dtype)

    def _correct(self, model_t, last, this, order):
        i = self.index
        ratio, alpha_t, h_phi_1, b_h, R, b, d1s = self._coefficients(
            i, i - 1, order, self.outputs[-2::-1])
        rhos = torch.tensor([0.5]) if order == 1 else torch.linalg.solve(R, b)
        m0 = self.outputs[-1]
        x_t = ratio * last - alpha_t * h_phi_1 * m0
        res = rhos[-1] * (model_t - m0)
        if d1s:
            res = rhos[0] * d1s[0] + res
        return (x_t - alpha_t * b_h * res).to(this.dtype)

    def step(self, model_output, sample):
        """The next sample from the flow prediction at the current step."""
        x0 = sample - self.sigmas[self.index] * model_output
        if self.index > 0 and self.last_sample is not None:
            sample = self._correct(x0, self.last_sample, sample,
                                   self.this_order)
        self.outputs = [self.outputs[1], x0]
        order = min(2, len(self.timesteps) - self.index)
        self.this_order = min(order, self.lower_order_nums + 1)
        self.last_sample = sample
        out = self._predict(sample, self.this_order)
        self.lower_order_nums = min(self.lower_order_nums + 1, 2)
        self.index += 1
        return out


def vace_mask_latents(m: torch.Tensor, frames: int) -> torch.Tensor:
    """VACE's `vace_encode_masks`: (1, T, H, W) {0, 1} -> (1, 64, frames,
    H/8, W/8), each 8x8 block's pixels as channels, 'nearest-exact' in
    time."""
    _, T, H, W = m.shape
    h, w = H // 8, W // 8
    m = m[0].reshape(T, h, 8, w, 8).permute(2, 4, 0, 1, 3) \
        .reshape(64, T, h, w)
    return F.interpolate(m[None], size=(frames, h, w), mode="nearest-exact")


def inference_size(H: int, W: int, cfg: WanConfig,
                   max_img_size: int) -> tuple:
    """(h, w): the long side at most min(max_img_size, cfg's), each side a
    multiple of 16."""
    return plan_long_side(H, W, min(max_img_size, cfg.max_img_size), 16)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation at PyTorch's default scale: Linear and
    convolution weights and biases uniform in +-1/sqrt(fan_in), norms at
    1 (LayerNorm bias 0), modulation standard normal / sqrt(dim) as Wan
    draws it."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (RMSNorm, VaeRMSNorm, LayerNorm)):
            for name, p in m.named_parameters(recurse=False):
                p.fill_(0.0 if name == "bias" else 1.0)
        mod = getattr(m, "modulation", None)
        if isinstance(mod, nn.Parameter):
            mod.normal_(generator=generator).div_(mod.shape[-1] ** 0.5)
    return module


class WanVace:
    """Wan2.1-VACE's DiT, Wan-VAE and sampler at `config`'s widths on
    `device` (bf16 weights on the card, f32 on the CPU)."""

    def __init__(self, config: Optional[WanConfig] = None, params=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg = config or default_config().wan
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        with torch.device("meta"):
            self.dit = WanDiT(cfg)
            self.vae = WanVAE(cfg)
        params = params or {}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, m in (("dit", self.dit), ("vae", self.vae)):
            m.to_empty(device=self.device)
            sd = params.get(name)
            if sd is None:
                init_random_(m, gen)
            else:
                m.load_state_dict(sd)
        self.context = {}
        for name, rows in zip(("context", "context_null"), cfg.text_tokens):
            t = params.get(name)
            self.context[name] = torch.randn(
                (rows, cfg.text_dim), generator=gen, device=self.device) \
                if t is None else torch.as_tensor(t, device=self.device)
        self.dit.cast_for_inference(self.dtype).eval().requires_grad_(False)
        self.vae.cast_for_inference(self.dtype).eval().requires_grad_(False)
        # called with the final latents before they decode
        self.latent_hook = None

    def _text(self):
        """(2, text_len, dim): the prompt's and the negative prompt's
        embedded contexts."""
        return torch.cat([self.dit.embed_context(
            self.context[n][None].float())
            for n in ("context", "context_null")])

    def inpaint(self, frames: torch.Tensor, masks: torch.Tensor,
                max_img_size: int = 832, progress=None) -> torch.Tensor:
        """frames (T, H, W, 3) uint8 and masks (T, H, W) (nonzero = hole)
        on the device -> (T, h, w, 3) f32 in [0, 255] at the inference
        size."""
        cfg = self.cfg
        progress = progress or (lambda *_a, **_k: None)
        T, H, W = (int(s) for s in frames.shape[:3])
        h, w = inference_size(H, W, cfg, max_img_size)
        t4 = 4 * math.ceil((T - 1) / 4) + 1
        if t4 > T:
            frames = torch.cat([frames, frames[-1:].expand(t4 - T, -1, -1,
                                                           -1)])
            masks = torch.cat([masks, masks[-1:].expand(t4 - T, -1, -1)])
        fr = host_resize_bilinear_u8(frames, h, w)
        m = (host_resize_nearest_2d(masks, h, w) > 0).float()[None]
        x = (fr.float() / 127.5 - 1.0).permute(3, 0, 1, 2) * (1.0 - m)
        with stage_timer("wan.vae_encode", frames=t4):
            z = torch.cat([self.vae.encode((x * (1.0 - m))[None]),
                           self.vae.encode((x * m)[None])], dim=1)
        f = z.shape[2]
        z = torch.cat([z, vace_mask_latents(m, f).to(z.dtype)], dim=1)
        noise = torch.randn((1, cfg.vae_z_dim, f, h // 8, w // 8),
                            generator=torch.Generator().manual_seed(0))
        latents = noise.to(self.device)
        sched = FlowUniPC(cfg.sample_steps, cfg.sample_shift)
        context = self._text()
        p = cfg.patch_size
        tokens = (f // p[0]) * (h // 8 // p[1]) * (w // 8 // p[2])
        for i, t in enumerate(sched.timesteps):
            with stage_timer("wan.step", step=i, tokens=tokens,
                             ctx_len=cfg.text_len, branches=2,
                             vace_blocks=len(cfg.vace_layers)):
                pred = self.dit(latents, t.to(self.device), z, context)
                guided = pred[1:] + cfg.guide_scale * (pred[:1] - pred[1:])
                latents = sched.step(guided, latents)
            progress(10 + 80 * (i + 1) // len(sched.timesteps),
                     f"denoising step {i + 1}/{len(sched.timesteps)}")
        if self.latent_hook is not None:
            self.latent_hook(latents)
        with stage_timer("wan.vae_decode", frames=t4):
            video = self.vae.decode(latents)
        return ((video[0, :, :T].permute(1, 2, 3, 0) + 1.0) * 127.5)
