"""Clip masking through the port's `pipeline.masker.run_sam2_on_frames`,
as Generate Mask and the `sam2_masker` CLI call it: clicks and boxes on
the first frames, the objects propagated through the clip, coloured
masks back.

The weights come from the workload's "weight_seed" where it has one, else
from the run's seed; the clips and annotations always from the run's
seed. At random weights the masks' cover is a lottery of the weight draw
(from a few to most of the frame), and the port renders the masks on the
host at a cost that grows with their cover, so a weight draw of its own
per seed would change a request's work from seed to seed.

The check: the sampled request against the reference on the same clip,
annotations and weights. The mask logits of every decode (each prompt and
each propagated frame, all objects; caught through the program's
`Sam2VideoPredictor.stage_hook` into pinned host memory) and the coloured
masks:
  logit_rel_rms_median
                  per decode, the RMS of logits - reference logits over
                  the RMS of the reference logits; the median over the
                  request's decodes
  mask_mismatch   share of pixels whose colour differs, all frames
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import configs, weights
from benchmark.counts.model import maybe_counting
from benchmark.traffic.annotations import make_annotations
from benchmark.traffic.clip import make_clip

NO_OBJ_SCORE = -1024.0  # the predictor's logits of an absent object


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
        self._caught = None
        self.sample = None
        self.detail: dict = {}
        # seconds of each part of set-up, printed by the harness
        self.timings: dict = {}

    def weights(self) -> dict:
        def skeleton():
            from benchmark.reference.vvref.models.sam2.predictor import (
                Sam2Model,
            )
            with torch.device("meta"):
                return {"sam2": (Sam2Model(self.rcfg.sam2), None)}
        t0 = time.perf_counter()
        plan = weights.plans({"config": self.spec, "entry": "mask"},
                             skeleton)["sam2"]
        self.timings["plans"] = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(
            self.wl.get("weight_seed", self.seed))
        return weights.seeded_state(plan, gen, self.dtype)

    def setup(self) -> None:
        from videovanish_tpu_torch.models.sam2.predictor import (
            Sam2VideoPredictor,
        )
        from videovanish_tpu_torch.pipeline import infill, masker
        self.masker = masker
        infill.set_config(self.pcfg)
        t0 = time.perf_counter()
        torch.zeros(1, device=self.device)
        self._sync()
        self.timings["device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = self.weights()
        self._sync()
        self.timings["weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        masker.predictor = Sam2VideoPredictor(
            self.pcfg.sam2, params=state, device=self.device.type)
        del state
        self._sync()
        self.timings["program"] = time.perf_counter() - t0
        masker._predictor_key = (self.pcfg.sam2, self.device.type)
        masker.predictor.stage_hook = self._hook
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
        t = self.wl["traffic"]
        self.pool = []
        for _ in range(self.wl["pool"]):
            frames, _, boxes = make_clip(t, rng, self.device)
            self.pool.append((frames, make_annotations(t, boxes)))

    def _hook(self, name, *outputs):
        if self._caught is not None and name == "decode":
            x = outputs[0]
            host = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                               pin_memory=x.is_cuda)
            host.copy_(x, non_blocking=True)
            self._caught.append(host)

    def request(self, i: int, capture: bool) -> None:
        frames, ann = self.pool[i % len(self.pool)]
        self._caught = [] if capture else None
        out = self.masker.run_sam2_on_frames(list(frames), ann,
                                             device=self.device.type)
        if capture:
            self.sample = (i % len(self.pool), out, self._caught)
        self._caught = None

    def release(self) -> None:
        self.masker.reset_predictor()

    def reference(self, clip: int, count: bool = False,
                  control: bool = False) -> tuple:
        """(coloured masks, the logits of each decode, counts) of the
        reference on pool clip `clip`."""
        from benchmark.reference.fp8 import emulate_fp8
        from benchmark.reference.masker import run_sam2_on_frames
        from benchmark.reference.vvref.models.sam2.predictor import (
            Sam2VideoPredictor,
        )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        pred = Sam2VideoPredictor(self.rcfg.sam2,
                                  params=weights.to_f32(self.weights()),
                                  device=self.device)
        if control:
            emulate_fp8(pred.model)
        caught = []
        pred.stage_hook = lambda name, *o: caught.append(o[0].float().cpu()) \
            if name == "decode" else None
        frames, ann = self.pool[clip]
        with maybe_counting(count) as counter:
            if counter is not None:
                counter.part = "sam2"
            out = run_sam2_on_frames(pred, list(frames), ann)
        del pred
        return out, caught, counter.as_dict() if counter else {}

    def compare(self, out, logits, ref_out, ref_logits) -> dict:
        if len(logits) != len(ref_logits) or any(
                a.shape != b.shape for a, b in zip(logits, ref_logits)):
            return {"logit_rel_rms_median": float("inf"),
                    "mask_mismatch": float("inf")}
        per = [float((a.float() - b).pow(2).mean().sqrt()
                     / b.pow(2).mean().sqrt().clamp(min=1e-30))
               for a, b in zip(logits, ref_logits)]
        absent = [int(bool((a == NO_OBJ_SCORE).all()))
                  + 2 * int(bool((b == NO_OBJ_SCORE).all()))
                  for a, b in zip(logits, ref_logits)]
        self.detail = {"per_decode_max": max(per),
                       "per_decode_argmax": int(np.argmax(per)),
                       "decodes": len(per), "absent": [
                           i for i, a in enumerate(absent) if a]}
        out, ref_out = np.stack(out), np.stack(ref_out)
        self.detail["cover"] = float(np.any(ref_out != 0, -1).mean())
        return {"logit_rel_rms_median": float(np.median(per)),
                "mask_mismatch": float(np.any(out != ref_out, -1).mean())}

    def compare_references(self, control, ref) -> dict:
        return self.compare(control[0], control[1], ref[0], ref[1])

    def check(self, count: bool = False) -> tuple:
        clip, out, logits = self.sample
        ref_out, ref_logits, counts = self.reference(clip, count)
        return self.compare(out, logits, ref_out, ref_logits), counts
