"""DiffuEraser: the end-to-end diffusion video-inpainting model, PyTorch.

Port of videovanish_tpu/models/diffueraser/model.py. Frames, masks and the
prior frames go in; inpainted frames at the inference resolution come out:

  - resize to `plan_long_side` on the device (bilinear frames, nearest
    masks);
  - VAE-encode the masked frames and the prior in chunks of 8 frames;
  - one denoise per overlapping temporal window: BrushNet features (once
    per window with brushnet_feature_reuse), the motion-module UNet for
    each PCM step (spatial attention recorded at step 1 and replayed after
    with spatial_attn_reuse), the deterministic consistency transition;
  - blend the windows' latents in f32 with linear cross-fade ramps;
  - decode each frame as soon as its last window is blended.

With a mesh (`core/mesh.py`; one process per card, every rank given the
same request) the frames shard over its "data" axis: each rank encodes its
block of every 8-frame chunk, denoises its block of every window whose
length divides by the axis (the motion modules then run ring attention,
`parallel/ring_attention.py`; a window that does not divide runs whole on
every rank, as the JAX package replicates it) and decodes its block of
every decode batch, and each result is all-gathered, so every rank blends
and returns the whole video. The weights are the same on every rank.

On the card weights and activations are bf16; normalisation statistics,
softmax, the scheduler and the blend accumulators stay f32. On the CPU
everything is f32. Noise is a pure function of the global frame index, so
overlapping windows and overlapping chunks of a long video agree.

`forward` records the JAX package's stages (`utils/observability.py`):
dn.upload_encode, dn.windows (the windows' denoise and blend) and
dn.decode_fetch (the VAE decodes, which here run between the windows). They
read the host clock and never synchronize the card (`synced` is 0), so
device work still queued bills to whichever stage next waits for it.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import time
from typing import Callable, Optional

import numpy as np
import torch

from benchmark.reference.vvref.standins import maybe_load
from benchmark.reference.vvref.config import DiffuEraserConfig, default_config
from benchmark.reference.vvref.standins import (
    jax_params_to_state_dict, published_state_dict,
)
from benchmark.reference.vvref.standins import data_coords, run_sharded
from benchmark.reference.vvref.models.diffueraser.blocks import (
    AttentionCache, cast_for_inference, init_random_,
)
from benchmark.reference.vvref.models.diffueraser.brushnet import BrushNetModel
from benchmark.reference.vvref.models.diffueraser.scheduler import (
    NoiseSchedule, consistency_step, pcm_timesteps,
)
from benchmark.reference.vvref.models.diffueraser.unet import UNetCondition
from benchmark.reference.vvref.models.diffueraser.vae import AutoencoderKL
from benchmark.reference.vvref.ops.morphology import binary_dilation
from benchmark.reference.vvref.standins import sequence_shard
from benchmark.reference.vvref.ops.resize import (
    host_resize_bilinear_u8, host_resize_nearest_2d, plan_long_side,
    resize_nearest_2d,
)
from benchmark.reference.vvref.standins import (
    record_sharding, record_stage, stage_timer, trace_annotation,
)

# (global frame indices, (h8, w8, C)) -> (T, h8, w8, C) noise
NoiseProvider = Callable[[range, tuple], torch.Tensor]


def make_window_plan(n_frames: int, clip_len: int, overlap: int):
    """(start, length) windows covering [0, n_frames) with `overlap` frames
    shared between neighbours."""
    if n_frames <= clip_len:
        return [(0, n_frames)]
    stride = clip_len - overlap
    plan = []
    for s in range(0, n_frames - clip_len + stride, stride):
        if s + clip_len >= n_frames:
            plan.append((n_frames - clip_len, clip_len))
            break
        plan.append((s, clip_len))
    return plan


def window_blend_weights(length: int, overlap: int, is_first: bool,
                         is_last: bool) -> np.ndarray:
    """Linear cross-fade ramps on the overlapped edges (f32)."""
    w = np.ones(length, dtype=np.float32)
    if overlap > 0:
        ramp = (np.arange(overlap) + 1.0) / (overlap + 1.0)
        if not is_first:
            w[:overlap] = ramp
        if not is_last:
            w[-overlap:] = ramp[::-1]
    return w


def frame_noise(seed: int) -> NoiseProvider:
    """Default noise provider: frame f's standard normal noise comes from
    a torch.Generator seeded from (seed, f)."""
    def provider(frames: range, shape: tuple) -> torch.Tensor:
        out = []
        for f in frames:
            g = torch.Generator().manual_seed(
                ((seed & 0xFFFFFFFF) << 32) | (f & 0xFFFFFFFF))
            out.append(torch.randn(shape, generator=g))
        return torch.stack(out)
    return provider


CHECKPOINT_PARTS = ("vae", "unet", "brushnet", "null_text_emb")


def load_checkpoint(cfg: DiffuEraserConfig) -> Optional[dict]:
    """DiffuEraser's weights from the config's files, as the JAX package
    reads them: the assembled checkpoint ({vae, unet, brushnet,
    null_text_emb}, written by `cli/convert.py --assemble diffueraser`),
    else the VAE alone from `vae_checkpoint` (the published file or a
    converted one), else None. A file that exists and does not load
    raises."""
    tree = maybe_load(cfg.checkpoint)
    if tree is not None:
        if set(tree) != set(CHECKPOINT_PARTS):
            raise ValueError(f"{cfg.checkpoint}: holds {sorted(tree)}, "
                             f"expected {sorted(CHECKPOINT_PARTS)}")
        return tree
    vae = maybe_load(cfg.vae_checkpoint)
    return None if vae is None else {"vae": published_state_dict(vae, "vae")}


def _null_prog(*_a, **_k):
    return None


def _host_bytes(xs, device) -> int:
    """Bytes of `xs` (a tensor, an array or a list of them) not yet on
    `device`."""
    if isinstance(xs, torch.Tensor):
        return 0 if xs.device == device else xs.numel() * xs.element_size()
    if isinstance(xs, np.ndarray):
        return xs.nbytes
    return sum(_host_bytes(x, device) for x in xs)


def stack_frames(xs, device) -> torch.Tensor:
    """A tensor, an array or a list of per-frame arrays as one tensor on
    `device` (dtype kept)."""
    if isinstance(xs, torch.Tensor):
        return xs.to(device=device)
    return torch.from_numpy(np.stack([np.asarray(x) for x in xs])).to(device)


class DiffuEraser:
    """SD1.5 + BrushNet + temporal attention + PCM few-step sampler.

    params: a dict with any of "vae", "unet", "brushnet" (each a JAX
    parameter tree of numpy arrays or the port's state dict) and
    "null_text_emb"; what it lacks (all of it for None) takes seeded random
    weights at PyTorch's default scale. `load_checkpoint` reads it from the
    config's files.
    noise: the noise provider (default `frame_noise(seed)`).
    mesh: a ("data", "model") DeviceMesh to shard the frames over, or None.
    """

    def __init__(self, config: Optional[DiffuEraserConfig] = None,
                 params=None, seed: int = 0, ckpt: str = "2-Step",
                 device="cuda", noise: Optional[NoiseProvider] = None,
                 mesh=None):
        self.cfg = config or default_config().diffueraser
        self.ckpt = "2-Step" if ckpt is None else ckpt
        m_steps = re.match(r"^(\d+)-Step$", str(self.ckpt))
        if m_steps and int(m_steps.group(1)) != self.cfg.num_inference_steps:
            self.cfg = dataclasses.replace(
                self.cfg, num_inference_steps=int(m_steps.group(1)))
        self.device = torch.device(device)
        self.dtype = torch.float32  # the reference runs in f32 everywhere
        self.seed = seed
        self.noise = noise or frame_noise(seed)
        self.schedule = NoiseSchedule()
        # called with each batch of blended latents just before it decodes
        self.latent_hook: Optional[Callable[[torch.Tensor], None]] = None
        self.mesh = mesh
        self.shard = sequence_shard(mesh) if data_coords(mesh)[1] > 1 \
            else None
        # the last forward's windows: {"sharded": n, "whole": n}
        self.window_split = {"sharded": 0, "whole": 0}

        cfg = self.cfg
        lat = cfg.sample_channels
        # shapes only; every value is set below from `params` or the seed
        with torch.device("meta"):
            self.vae = AutoencoderKL(cfg.vae_block_out_channels, 2,
                                     cfg.vae_latent_channels)
            self.unet = UNetCondition(
                lat, lat, cfg.block_out_channels, cfg.layers_per_block,
                cfg.attention_head_dim, cfg.cross_attention_dim)
            self.brushnet = BrushNetModel(
                2 * lat + 1, cfg.block_out_channels, cfg.layers_per_block,
                cfg.attention_head_dim, cfg.cross_attention_dim)
        modules = {"vae": self.vae, "unet": self.unet,
                   "brushnet": self.brushnet}
        for m in modules.values():
            m.to_empty(device=self.device)
        params = params or {}
        # no generator on the meta device, where the benchmark counts
        # the work without weights
        gen = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)
        for name, m in modules.items():
            sd = params.get(name)
            if sd is None:
                init_random_(m, gen)
                continue
            if any(isinstance(v, dict) for v in sd.values()):
                sd = jax_params_to_state_dict(sd, name)
            m.load_state_dict(sd)
        emb = params.get("null_text_emb")
        if emb is None:
            self.null_text_emb = torch.randn(
                (77, cfg.cross_attention_dim), generator=gen,
                device=self.device) * 0.02
        else:
            self.null_text_emb = torch.as_tensor(
                emb if isinstance(emb, torch.Tensor) else np.asarray(emb),
                dtype=torch.float32, device=self.device)
            if self.null_text_emb.shape != (77, cfg.cross_attention_dim):
                raise ValueError(
                    f"null_text_emb {tuple(self.null_text_emb.shape)}, "
                    f"expected (77, {cfg.cross_attention_dim})")
        for m in modules.values():
            cast_for_inference(m, self.dtype).eval().requires_grad_(False)

    # ------------------------------------------------------------------
    def _encode(self, rgb01: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) f32 in [0, 1] -> scaled latents (N, 4, h8, w8) f32."""
        x = (rgb01 * 2.0 - 1.0).permute(0, 3, 1, 2).to(self.dtype)
        return self.vae.encode(x).float() * self.cfg.vae_scaling_factor

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (N, 4, h8, w8) f32 -> RGB (N, H, W, 3) uint8."""
        record_sharding("vae_decode", latents=z)
        x = self.vae.decode((z / self.cfg.vae_scaling_factor).to(self.dtype))
        x01 = ((x.float() + 1.0) / 2.0).clamp(0.0, 1.0)
        return torch.round(x01 * 255.0).clamp(0, 255).to(torch.uint8) \
            .permute(0, 2, 3, 1)

    def _denoise_window(self, prior_lat, masked_lat, mask_lat, noise,
                        prompt_emb, guidance: float = 0.0, shard=None,
                        t_frames: Optional[int] = None) -> torch.Tensor:
        """One temporal window of PCM few-step denoising. All (T, C, h8, w8)
        f32; prompt_emb (77, D). guidance > 0 runs classifier-free
        guidance against the null-text embedding. With `shard` the inputs
        are this rank's block of a window of t_frames frames."""
        record_sharding("denoise_window", prior_lat=prior_lat)
        cfg, dt = self.cfg, self.dtype
        T = prior_lat.shape[0]
        steps = pcm_timesteps(cfg.num_inference_steps,
                              self.schedule.num_train_timesteps)
        txt = prompt_emb.to(dt)[None].expand(T, -1, -1)
        use_cfg = guidance > 0.0
        null = self.null_text_emb.to(dt)[None].expand(T, -1, -1) \
            if use_cfg else None
        x = self.schedule.add_noise(prior_lat, noise, int(steps[0]))
        feats, caches = {}, {}
        for i, t_i in enumerate(steps):
            t_vec = torch.full((T,), int(t_i), device=self.device,
                               dtype=torch.long)
            if not feats or not cfg.brushnet_feature_reuse:
                bsample = torch.cat([x, masked_lat, mask_lat], 1).to(dt)
                feats = {"c": self.brushnet(bsample, t_vec, txt)}
                if use_cfg:
                    feats["u"] = self.brushnet(bsample, t_vec, null)

            def eps_for(cond, which):
                cache = None
                if cfg.spatial_attn_reuse:
                    # record at the first step, replay at the later ones
                    cache = caches.get(which)
                    if cache is None:
                        cache = caches[which] = AttentionCache()
                    else:
                        cache.replay = True
                bd, bm, bu = feats[which]
                return self.unet(x.to(dt), t_vec, cond, t_frames or T, bd,
                                 bm, bu, cache=cache, shard=shard)

            eps = eps_for(txt, "c")
            if use_cfg:
                eps_u = eps_for(null, "u")
                eps = eps_u + guidance * (eps - eps_u)
            t_next = int(steps[i + 1]) if i + 1 < len(steps) else -1
            x = consistency_step(self.schedule, x, eps.float(), int(t_i),
                                 t_next)
        return x

    @staticmethod
    def _roi(masks, output_roi, roi_margin, h, w):
        if output_roi is None:
            return None
        if isinstance(output_roi, str) and output_roi == "auto":
            any_m = masks.any(dim=0)
            ys = torch.nonzero(any_m.any(dim=1)).flatten()
            xs = torch.nonzero(any_m.any(dim=0)).flatten()
            if ys.numel():
                mg = int(roi_margin)
                y0, y1 = int(ys.min()) - mg, int(ys.max()) + mg + 1
                x0, x1 = int(xs.min()) - mg, int(xs.max()) + mg + 1
            else:
                y0 = y1 = x0 = x1 = 0
        else:
            y0, y1, x0, x1 = (int(v) for v in output_roi)
        # snap to 16-px multiples
        y0, x0 = max(0, (y0 // 16) * 16), max(0, (x0 // 16) * 16)
        y1, x1 = min(h, -(-y1 // 16) * 16), min(w, -(-x1 // 16) * 16)
        if y1 > y0 and x1 > x0 and (y1 - y0) * (x1 - x0) < h * w:
            return (y0, y1, x0, x1)
        return None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, frames, masks, prior_frames=None,
                max_img_size: int = 960, mask_dilation_iter: int = 0,
                guidance_scale=None, progress=None, prompt_embeds=None,
                output_roi=None, roi_margin: int = 16, frame_offset: int = 0,
                latent_carry=None, return_latent_tail: int = 0):
        """Inpaint `frames` where `masks` is nonzero, seeded by
        `prior_frames`.

        frames: (T, H0, W0, 3) uint8 (array, tensor or list of frames)
        masks: (T, H0, W0) or (T, H0, W0, 3) uint8, nonzero = hole
        prior_frames: the prior (ProPainter output), any resolution; None
            seeds the holes from the masked input itself
        output_roi: None, "auto" (the mask's bounding box + roi_margin,
            snapped to 16 px) or (y0, y1, x0, x1): pixels outside it are the
            resized input's
        frame_offset / latent_carry / return_latent_tail: cross-chunk latent
            blending for a long-video job; the carry is
            ((n, h8, w8, 4), (n, 1, 1, 1)) f32 blend accumulators.

        Returns (T, h, w, 3) uint8 on the model's device at the inference
        resolution; with return_latent_tail > 0, (frames without the tail,
        (z_acc_tail, w_acc_tail)).
        """
        prog = progress or _null_prog
        cfg, dev = self.cfg, self.device
        bytes_up = _host_bytes(frames, dev) + _host_bytes(masks, dev) + (
            0 if prior_frames is None else _host_bytes(prior_frames, dev))
        frames = stack_frames(frames, dev)
        masks = stack_frames(masks, dev)
        if masks.dim() == 4:
            masks = (masks > 0).any(dim=-1)
        masks = (masks > 0).to(torch.uint8)
        T, H0, W0 = frames.shape[:3]
        h, w = plan_long_side(H0, W0, min(max_img_size, cfg.max_img_size), 8)
        h8, w8 = h // 8, w // 8
        if mask_dilation_iter > 0:
            masks = binary_dilation(masks, mask_dilation_iter).to(torch.uint8)
        if (H0, W0) != (h, w):
            frames = host_resize_bilinear_u8(frames, h, w)
            masks = host_resize_nearest_2d(masks, h, w)
        pf = None
        if prior_frames is not None:
            pf = stack_frames(prior_frames, dev)
            if tuple(pf.shape[1:3]) != (h, w):
                pf = host_resize_bilinear_u8(pf, h, w)
        roi = self._roi(masks, output_roi, roi_margin, h, w)
        clip_len = min(cfg.clip_length, T)

        prog(5, "VAE-encoding frames")
        chunk = 8
        pad = (-T) % chunk

        def padded(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) \
                if pad else x

        fr_p, mk_p = padded(frames), padded(masks)
        pf_p = None if pf is None else padded(pf)
        lat_c, mlat_c, prior_c = [], [], []
        def encode_masked(fr, m):
            record_sharding("vae_encode", frames=fr)
            x = fr.float() / 255.0
            return self._encode(x * (1.0 - m[..., None].float()))

        def encode_prior(pf):
            return self._encode(pf.float() / 255.0)

        with stage_timer("dn.upload_encode", frames=T, wire="rgb",
                         bytes_up=bytes_up):
            for i in range(0, T + pad, chunk):
                m = mk_p[i:i + chunk]
                lat_c.append(run_sharded(self.mesh, encode_masked,
                                         fr_p[i:i + chunk], m))
                mlat_c.append(
                    (resize_nearest_2d(m, h8, w8) > 0).float()[:, None])
                if pf_p is not None:
                    prior_c.append(run_sharded(self.mesh, encode_prior,
                                               pf_p[i:i + chunk]))
            masked_lat = torch.cat(lat_c)
            m_lat = torch.cat(mlat_c)
            prior_lat = torch.cat(prior_c) if prior_c else masked_lat

        noise = self.noise(range(frame_offset, frame_offset + T),
                           (h8, w8, cfg.sample_channels))
        noise = torch.as_tensor(noise, dtype=torch.float32).to(dev) \
            .permute(0, 3, 1, 2)
        plan = make_window_plan(
            T, clip_len,
            min(cfg.clip_overlap, clip_len - 1) if clip_len > 1 else 0)
        acc = torch.zeros((T, cfg.sample_channels, h8, w8),
                          dtype=torch.float32, device=dev)
        wsum = torch.zeros((T, 1, 1, 1), dtype=torch.float32, device=dev)
        carry_n = 0
        if latent_carry is not None:
            z_in, w_in = latent_carry
            carry_n = int(z_in.shape[0])
            acc[:carry_n] = torch.as_tensor(z_in, dtype=torch.float32) \
                .to(dev).permute(0, 3, 1, 2)
            wsum[:carry_n] = torch.as_tensor(w_in, dtype=torch.float32).to(dev)
        T_out = T - int(return_latent_tail)
        if T_out <= 0:
            raise ValueError("return_latent_tail must leave frames to emit")
        prompt_emb = self.null_text_emb if prompt_embeds is None else \
            torch.as_tensor(prompt_embeds, dtype=torch.float32).to(dev)

        out = torch.empty((T_out, h, w, 3), dtype=torch.uint8, device=dev)
        if roi is not None:
            out[:] = frames[:T_out]  # out-of-ROI pixels = resized input
        decoded_upto = 0
        decode_s, decodes = 0.0, 0

        def decode_final(upto):
            """Decode the finished frames [decoded_upto, upto) in batches of
            `chunk` (the last batch shifts back to stay full); frames of a
            withheld latent tail are never decoded."""
            nonlocal decoded_upto, decode_s, decodes
            t0 = time.perf_counter()
            upto = min(upto, T_out)
            while decoded_upto < upto:
                i = decoded_upto
                n = min(chunk, T_out - i)
                if n < chunk and T_out >= chunk:
                    if upto < T_out:
                        break  # wait for more finished frames
                    i, n = T_out - chunk, chunk
                nb = min(chunk, T)
                z_c = acc[i:i + nb] / wsum[i:i + nb]
                if self.latent_hook is not None:
                    self.latent_hook(z_c)
                with trace_annotation("dn.decode"):
                    u8 = run_sharded(self.mesh, self._decode, z_c)
                end = min(i + nb, T_out)
                start = decoded_upto
                if roi is None:
                    out[start:end] = u8[start - i:end - i]
                else:
                    y0, y1, x0, x1 = roi
                    out[start:end, y0:y1, x0:x1] = \
                        u8[start - i:end - i, y0:y1, x0:x1]
                decoded_upto = min(i + n, upto)
                decodes += 1
            decode_s += time.perf_counter() - t0

        t_windows = time.perf_counter()
        n_data = data_coords(self.mesh)[1]
        self.window_split = {"sharded": 0, "whole": 0}
        for wi, (s, L) in enumerate(plan):
            prog(10 + 70 * wi / max(1, len(plan)),
                 f"denoising window {wi + 1}/{len(plan)}")
            # frames split over "data" only where the window divides by it
            # (run_sharded runs it whole on every rank otherwise)
            ring = n_data > 1 and L % n_data == 0
            self.window_split["sharded" if ring else "whole"] += 1
            with trace_annotation("dn.window"):
                z = run_sharded(self.mesh, functools.partial(
                    self._denoise_window, prompt_emb=prompt_emb,
                    guidance=float(guidance_scale or 0.0),
                    shard=self.shard if ring else None, t_frames=L),
                    prior_lat[s:s + L], masked_lat[s:s + L], m_lat[s:s + L],
                    noise[s:s + L])
            bw = window_blend_weights(
                L, min(cfg.clip_overlap, L - 1) if L > 1 else 0,
                # with a latent carry the first edge ramps up from the
                # previous chunk; with a withheld tail the last edge ramps
                # down into the next one
                is_first=(wi == 0 and carry_n == 0),
                is_last=(wi == len(plan) - 1 and return_latent_tail == 0))
            bwt = torch.from_numpy(bw).to(dev)[:, None, None, None]
            acc[s:s + L] += bwt * z
            wsum[s:s + L] += bwt
            decode_final(plan[wi + 1][0] if wi + 1 < len(plan) else T)
        record_stage("dn.windows",
                     time.perf_counter() - t_windows - decode_s,
                     windows=len(plan), synced=0)
        record_stage("dn.decode_fetch", decode_s, frames=T_out, synced=0,
                     fetch_bytes=0,
                     dispatches=len(lat_c) + len(prior_c) + len(plan)
                     + decodes)
        prog(100, "diffusion inpainting done")
        if return_latent_tail:
            return out, (acc[T_out:].permute(0, 2, 3, 1), wsum[T_out:])
        return out

    __call__ = forward
