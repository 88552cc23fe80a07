"""Clip infill through the port's `pipeline.infill.run_infill_on_frames`
at its defaults, the ProPainter prior computed, as Make Vanish and the
`diffuerase` CLI call it. Several ranks (a cell of several chips) each
pass the same clip, and the pipeline shards it over its mesh.

The check: the sampled request's output frames and its prior (caught
through the program's `Propainter.stage_hook` as the generator stage
ends) against the reference on the same clip and weights:
  prior_rms    RMS of prior - reference prior inside the resized hole,
               uint8 levels
  frames_rms   RMS of output - reference output where the feathered
               alpha is above 0, uint8 levels
  outside_px   pixels outside the feathered mask that differ (exact: 0)
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import configs, weights
from benchmark.counts.model import maybe_counting
from benchmark.traffic.clip import make_clip


class Entry:
    def __init__(self, spec: dict, wl: dict, seed: int, device: str,
                 program: bool = True):
        from benchmark.reference.vvref import config as rconfig
        self.spec, self.wl, self.seed = spec, wl, seed
        self.device = torch.device(device)
        self.rcfg = configs.build(rconfig, spec)
        if program:
            from videovanish_tpu_torch import config as pconfig
            self.pcfg = configs.build(pconfig, spec)
        self.frames_per_request = wl["traffic"]["frames"]
        self.dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        self.pool = []
        self._capturing = False
        self._prior = None
        self.sample = None
        # seconds of each part of set-up, printed by the harness
        self.timings: dict = {}
        self.mesh = None

    # -- weights ---------------------------------------------------------
    def weights(self) -> tuple:
        """({vae, unet, brushnet, null_text_emb}, {raft, flow_comp,
        generator}) state dicts drawn from the seed on the device."""
        d, p = self.rcfg.diffueraser, self.rcfg.propainter

        def skeletons():
            from benchmark.reference.vvref.models.diffueraser.model import (
                DiffuEraser as RefDiffuEraser,
            )
            from benchmark.reference.vvref.models.propainter import (
                inpaint_generator,
            )
            from benchmark.reference.vvref.models.propainter.model import (
                Propainter as RefPropainter,
            )
            de = RefDiffuEraser(config=d, device="meta")
            pp = RefPropainter(config=p, device="meta")
            return {"vae": (de.vae, None), "unet": (de.unet, None),
                    "brushnet": (de.brushnet, None),
                    "raft": (pp.raft, None), "flow_comp": (pp.flow_comp, None),
                    "generator": (pp.generator,
                                  lambda: inpaint_generator.InpaintGenerator(
                                      p.channels, p.hidden, p.depths,
                                      p.num_heads, tuple(p.window),
                                      tuple(p.pool), p.t_dilation,
                                      p.ffn_channels))}
        t0 = time.perf_counter()
        plans = weights.plans({"config": self.spec, "entry": "infill"},
                              skeletons)
        self.timings["plans"] = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        dw = {n: weights.seeded_state(plans[n], gen, self.dtype)
              for n in ("vae", "unet", "brushnet")}
        dw["null_text_emb"] = (torch.randn(
            (77, d.cross_attention_dim), generator=gen, device=self.device)
            * 0.02).to(self.dtype)
        pw = {n: weights.seeded_state(plans[n], gen, self.dtype)
              for n in ("raft", "flow_comp", "generator")}
        return dw, pw

    # -- the program -----------------------------------------------------
    def setup(self) -> None:
        from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
        from videovanish_tpu_torch.models.propainter.model import Propainter
        from videovanish_tpu_torch.pipeline import infill
        self.infill = infill
        infill.set_config(self.pcfg)
        self.mesh = infill._get_mesh(self.device.type) \
            if int(self.wl["chips"]) > 1 else None
        t0 = time.perf_counter()
        torch.zeros(1, device=self.device)
        self._sync()
        self.timings["device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dw, pw = self.weights()
        self._sync()
        self.timings["weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        infill.video_inpainting_sd = DiffuEraser(
            config=infill._clip_for_mesh(self.pcfg.diffueraser, self.mesh),
            params=dw, device=self.device.type, mesh=self.mesh)
        infill.last_ckpt = "2-Step"
        infill.propainter = Propainter(config=self.pcfg.propainter,
                                       device=self.device.type, params=pw,
                                       mesh=self.mesh)
        del dw, pw
        infill.propainter.stage_hook = self._hook
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

    def _hook(self, name, *outputs):
        if self._capturing and name == "generator":
            self._prior = outputs[0]

    def request(self, i: int, capture: bool) -> None:
        frames, masks = self.pool[i % len(self.pool)]
        self._capturing = capture
        out = self.infill.run_infill_on_frames(
            list(frames), list(masks), device=self.device.type)
        if capture:
            self.sample = (i % len(self.pool), out)
        self._capturing = False

    def release(self) -> None:
        if self._prior is not None:
            self._prior = self._prior.float().cpu()
        self.infill.set_config(self.pcfg)

    # -- the check -------------------------------------------------------
    def reference(self, clip: int, count: bool = False,
                  control: bool = False) -> tuple:
        """(output, prior (T, 3, h, w) f32 in [0, 1], dilated masks,
        counts) of the reference on pool clip `clip`; `control` rounds its
        linear and convolution layers to fp8."""
        from benchmark.reference import infill as ref
        from benchmark.reference.fp8 import emulate_fp8
        from benchmark.reference.vvref.models.diffueraser.model import (
            DiffuEraser as RefDiffuEraser,
        )
        from benchmark.reference.vvref.models.propainter.model import (
            Propainter as RefPropainter,
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dw, pw = self.weights()
        dw = weights.to_f32(dw)
        pw = weights.to_f32(pw)
        pp = RefPropainter(config=self.rcfg.propainter, device=self.device,
                           params=pw)
        de = RefDiffuEraser(config=self.window_config(), params=dw,
                            device=self.device)
        del dw, pw
        if control:
            for m in (pp.raft, pp.flow_comp, pp.generator, de.vae, de.unet,
                      de.brushnet):
                emulate_fp8(m)
        caught = {}
        pp.stage_hook = lambda name, *o: caught.__setitem__(name, o[0])
        frames, masks = self.pool[clip]
        icfg, pcfg = self.rcfg.infill, self.rcfg.propainter
        with maybe_counting(count) as counter:
            if counter is not None:
                counter.part = "prior"
            fr, dilated, pri = ref.prior(pp, frames, masks, icfg, pcfg,
                                         self.device)
            if counter is not None:
                counter.part = "diffueraser"
            out = ref.diffuerase(de, fr, dilated, pri, icfg)
        prior01 = caught["generator"].float().cpu()
        del pp, de
        return out, prior01, dilated, counter.as_dict() if counter else {}

    def window_config(self):
        """DiffuEraser's config as the pipeline runs it: on a mesh whose
        "data" axis (every chip: the cell's model axis is 1) does not divide
        the window length, the window is rounded up to a multiple of it
        (`pipeline/infill.py`, `_clip_for_mesh`), so that it shards."""
        d, n = self.rcfg.diffueraser, int(self.wl["chips"])
        if n > 1 and d.clip_length % n:
            d = dataclasses.replace(d, clip_length=-(-d.clip_length // n) * n)
        return d

    def compare(self, out, prior01, ref_out, ref_prior01, dilated) -> dict:
        from benchmark.reference.vvref.ops.edt import feather_alpha
        from benchmark.reference.vvref.ops.resize import resize_nearest_2d
        h, w = ref_prior01.shape[-2:]
        hole = (resize_nearest_2d(dilated, h, w) > 0).cpu()[:, None] \
            .expand_as(ref_prior01)
        d = (prior01.float() - ref_prior01) * 255.0
        prior_rms = float(d[hole].pow(2).mean().sqrt()) if hole.any() \
            else 0.0
        alpha = feather_alpha(dilated > 0,
                              float(self.rcfg.infill.feather_px)).cpu()
        inside = (alpha > 0).numpy()
        out = np.stack(out).astype(np.float32)
        ref_out = ref_out.astype(np.float32)
        diff = out - ref_out
        frames_rms = float(np.sqrt((diff[inside] ** 2).mean())) \
            if inside.any() else 0.0
        outside_px = int(np.any(diff != 0, axis=-1)[~inside].sum())
        return {"prior_rms": prior_rms, "frames_rms": frames_rms,
                "outside_px": outside_px}

    def compare_references(self, control, ref) -> dict:
        return self.compare(control[0], control[1], ref[0], ref[1], ref[2])

    def check(self, count: bool = False) -> tuple:
        clip, out = self.sample
        ref_out, ref_prior, dilated, counts = self.reference(clip, count)
        return self.compare(out, self._prior, ref_out, ref_prior,
                            dilated), counts
