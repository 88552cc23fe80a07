"""Make Vanish with Wan2.1-VACE: the port's
`pipeline.infill.run_infill_on_frames` with `infill.model = "vace"`, as
Make Vanish and `diffuerase --model vace` call it (dilate, the VACE
remover at up to 832 px, feathered composite).

The configuration's `wan` section holds every field of the port's
`WanConfig`, and is read here: `configs.SECTIONS` does not name it, and
the reference takes the same dict.

Weights are drawn from the seed by `benchmark/weights.py`'s rules, with
two mends of its own: Wan-VAE's `RMS_norm.gamma` at 1 (the shared rules
give every `gamma` SAM2's layer scale), and each block's and the head's
`modulation` standard normal over sqrt(dim), as Wan draws it. Wan's
zero-initialised `head.head`, `before_proj` and `after_proj` are drawn
like any linear layer, so the hints and the output carry the weights'
work. The umT5 embeddings of the prompt and the negative prompt are
standard normal, `text_tokens` rows each.

The check: the sampled request's output and its final latents (caught
through the program's `WanVace.latent_hook`) against the reference on
the same clip and weights:
  frames_rms      RMS of output - reference output where the feathered
                  alpha is above 0, uint8 levels
  outside_px      pixels outside the feathered mask that differ (exact: 0)
  latent_rel_rms  RMS of latents - reference latents over the reference
                  latents' RMS
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import weights
from benchmark.counts.model import maybe_counting
from benchmark.traffic.clip import make_clip

# tensors Wan draws apart from the shared rules: (rule, value) by name
OWN = {"gamma": ("const", 1.0)}


def _plan(module) -> list:
    """weights.module_plan's entries of `module` (on the meta device) under
    the shared rules and OWN; `modulation` standard normal / sqrt(dim)."""
    out = []
    for mname, m in module.named_modules():
        persistent = set(m.state_dict(keep_vars=True).keys())
        for name, t in m.named_parameters(recurse=False):
            if name not in persistent:
                continue
            key = f"{mname}.{name}" if mname else name
            if name == "modulation":
                r = ("normal", t.shape[-1] ** -0.5)
            else:
                r = OWN.get(name) or weights._rule(m, name, t)
            if r is None:
                raise ValueError(f"no weight rule for {key}")
            out.append([key, list(t.shape),
                        str(t.dtype).removeprefix("torch."), r[0], r[1]])
    return out


class Entry:
    def __init__(self, spec: dict, wl: dict, seed: int, device: str,
                 program: bool = True):
        self.spec, self.wl, self.seed = spec, wl, seed
        self.device = torch.device(device)
        self.wcfg = dict(spec["wan"])
        self.icfg = dict(spec["infill"])
        if program:
            from videovanish_tpu_torch import config as pconfig
            base = pconfig.default_config()
            wan = pconfig.WanConfig(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in self.wcfg.items()})
            self.pcfg = dataclasses.replace(
                base, wan=wan,
                infill=dataclasses.replace(base.infill, **self.icfg))
        self.frames_per_request = wl["traffic"]["frames"]
        self.dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        self.pool = []
        self._capturing = False
        self._latents = None
        self.sample = None
        self.timings: dict = {}

    # -- weights ---------------------------------------------------------
    def weights(self) -> dict:
        """{dit, vae, context, context_null} drawn from the seed on the
        device."""
        from benchmark.reference.vvref.models.wan.model import build
        t0 = time.perf_counter()
        with torch.device("meta"):
            dit, vae = build(self.wcfg, device=None)
        plans = {"dit": _plan(dit), "vae": _plan(vae)}
        self.timings["plans"] = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        out = {n: weights.seeded_state(plans[n], gen, self.dtype)
               for n in ("dit", "vae")}
        for name, rows in zip(("context", "context_null"),
                              self.wcfg["text_tokens"]):
            out[name] = torch.randn((rows, self.wcfg["text_dim"]),
                                    generator=gen, device=self.device) \
                .to(self.dtype)
        return out

    # -- the program -----------------------------------------------------
    def setup(self) -> None:
        from videovanish_tpu_torch.models.wan.model import WanVace
        from videovanish_tpu_torch.pipeline import infill
        self.infill = infill
        infill.set_config(self.pcfg)
        t0 = time.perf_counter()
        torch.zeros(1, device=self.device)
        self._sync()
        self.timings["device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        w = self.weights()
        self._sync()
        self.timings["weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        infill.wan = WanVace(config=self.pcfg.wan, params=w,
                             device=self.device.type)
        del w
        infill.wan.latent_hook = self._hook
        self._sync()
        self.timings["program"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.pool_from(np.random.default_rng(self.seed))
        self.timings["clips"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(self.wl["warmup"]):
            self.request(i, capture=False)
        self.timings["warmup"] = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def pool_from(self, rng) -> None:
        self.pool = [make_clip(self.wl["traffic"], rng, self.device)[:2]
                     for _ in range(self.wl["pool"])]

    def _hook(self, latents):
        if self._capturing:
            self._latents = latents.float().clone()

    def request(self, i: int, capture: bool) -> None:
        frames, masks = self.pool[i % len(self.pool)]
        self._capturing = capture
        out = self.infill.run_infill_on_frames(
            list(frames), list(masks), device=self.device.type)
        if capture:
            self.sample = (i % len(self.pool), out)
        self._capturing = False

    def release(self) -> None:
        if self._latents is not None:
            self._latents = self._latents.cpu()
        self.infill.set_config(self.pcfg)

    # -- the check -------------------------------------------------------
    def reference(self, clip: int, count: bool = False,
                  control: bool = False) -> tuple:
        """(output, final latents, dilated masks, counts) of the reference
        on pool clip `clip`; `control` rounds its linear and convolution
        layers to fp8."""
        from benchmark.reference import vace as ref
        from benchmark.reference.fp8 import emulate_fp8
        from benchmark.reference.vvref.models.wan.model import build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w = weights.to_f32(self.weights())
        dit, vae = build(self.wcfg, {"dit": w["dit"], "vae": w["vae"]},
                         device=self.device)
        if control:
            emulate_fp8(dit)
            emulate_fp8(vae)
        frames, masks = self.pool[clip]
        with maybe_counting(count) as counter:
            if counter is not None:
                counter.part = "wan"
            out, latents, dilated = ref.request(
                dit, vae, frames, masks, self.wcfg, self.icfg,
                w["context"], w["context_null"], self.device)
        del dit, vae, w
        return (out, latents.float().cpu(), dilated,
                counter.as_dict() if counter else {})

    def compare(self, out, latents, ref_out, ref_latents, dilated) -> dict:
        from benchmark.reference.vvref.ops.edt import feather_alpha
        alpha = feather_alpha(dilated > 0,
                              float(self.icfg["feather_px"])).cpu()
        inside = (alpha > 0).numpy()
        out = np.stack(out).astype(np.float32)
        diff = out - ref_out.astype(np.float32)
        frames_rms = float(np.sqrt((diff[inside] ** 2).mean())) \
            if inside.any() else 0.0
        outside_px = int(np.any(diff != 0, axis=-1)[~inside].sum())
        ref_latents = ref_latents.reshape(latents.shape)
        latent_rel_rms = float((latents - ref_latents).pow(2).mean().sqrt()
                               / ref_latents.pow(2).mean().sqrt())
        return {"frames_rms": frames_rms, "outside_px": outside_px,
                "latent_rel_rms": latent_rel_rms}

    def compare_references(self, control, ref) -> dict:
        return self.compare(control[0], control[1], ref[0], ref[1], ref[2])

    def check(self, count: bool = False) -> tuple:
        clip, out = self.sample
        ref_out, ref_latents, dilated, counts = self.reference(clip, count)
        return self.compare(out, self._latents, ref_out, ref_latents,
                            dilated), counts
