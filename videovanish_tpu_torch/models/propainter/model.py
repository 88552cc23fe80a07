"""Propainter: the flow-guided video inpainting prior, PyTorch.

Port of videovanish_tpu/models/propainter/model.py, with the reference's
call surface: Propainter(repo_id, device) and .forward(frames, masks,
ref_stride=10, neighbor_length=10, subvideo_length=50, mask_dilation=0,
progress) -> prior frames for DiffuEraser. For each sub-video chunk:

  1. RAFT flows of every consecutive pair, both directions;
  2. recurrent flow completion inside the holes;
  3. image propagation along the completed flows (nearest warps,
     forward-backward consistency checks);
  4. the InpaintGenerator over neighbour windows (length neighbor + 1,
     stride neighbor // 2, the last start appended) with every
     `ref_stride`-th frame outside the window as a global reference;
     windows are averaged per frame and composited over the input outside
     the mask.

With a mesh (`core/mesh.py`, every rank given the same request) the work
shards over its "data" axis and every rank returns the whole prior: RAFT
over the frame pairs (each rank takes its pairs from the frames all ranks
hold), the flow completion's convolutions over frames (its recurrence and
the image propagation, both sequential over frames, run whole on every
rank), and the generator's windows, grouped by their reference count and
each group padded to a multiple of the axis by repeating its last window;
each result is all-gathered.

Chunks of `subvideo_length` frames overlap by min(4, sub // 2); each is
padded back to the full length and the chunks are averaged. Everything
runs on the model's device at the internal resolution (long side capped at
`max_img_size`); only `return_device=False` copies the frames back. On the
card the networks run in bf16 with f32 normalisation statistics, softmax,
deformable sampling, correlation volumes and flow accumulation; on the
CPU everything is f32.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from videovanish_tpu_torch.checkpoint import maybe_load
from videovanish_tpu_torch.config import ProPainterConfig
from videovanish_tpu_torch.convert import (
    jax_params_to_state_dict, published_state_dict,
)
from videovanish_tpu_torch.core.mesh import data_coords, run_sharded
from videovanish_tpu_torch.models.diffueraser.model import stack_frames
from videovanish_tpu_torch.models.propainter.deform import (
    SecondOrderDeformableAlignment,
)
from videovanish_tpu_torch.models.propainter.flow_completion import (
    RecurrentFlowCompleteNet,
)
from videovanish_tpu_torch.models.propainter.inpaint_generator import (
    InpaintGenerator,
)
from videovanish_tpu_torch.models.propainter.propagation import (
    image_propagation,
)
from videovanish_tpu_torch.models.propainter.raft import RAFT
from videovanish_tpu_torch.ops.morphology import binary_dilation
from videovanish_tpu_torch.ops.resize import (
    host_resize_bilinear_u8, host_resize_nearest_2d, plan_long_side,
)
from videovanish_tpu_torch.utils.observability import (
    record_sharding, trace_annotation,
)

_CONVS = (nn.Conv2d, nn.Conv3d, nn.Linear)


def _null_prog(*_a, **_k):
    return None


@torch.no_grad()
def _init_random_(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded weights at PyTorch's default scale: every conv, linear and
    deformable-conv weight and bias uniform in +-1/sqrt(fan_in); norms at
    weight 1, bias 0, running mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, _CONVS + (SecondOrderDeformableAlignment,)):
            bound = 1.0 / np.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=gen)
            m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()


def load_checkpoints(cfg: ProPainterConfig) -> dict:
    """The weights of the config's three files (published or converted):
    {"raft", "flow_comp", "generator"} for those that exist. A file that
    exists and does not load raises."""
    out = {}
    for name, path, model in (
            ("raft", cfg.raft_checkpoint, "raft"),
            ("flow_comp", cfg.flowcomp_checkpoint, "flow_completion"),
            ("generator", cfg.checkpoint, "propainter")):
        state = maybe_load(path)
        if state is not None:
            out[name] = published_state_dict(state, model)
    return out


def window_plan(T: int, neighbor_length: int, ref_stride: int):
    """(NL, [(start, ref frame ids), ...]) of one chunk: windows of
    NL = min(T, neighbor + 1) frames at stride neighbor // 2, the last
    start appended, and every ref_stride-th frame outside the window as a
    reference (the published choice, so the count varies per window)."""
    NL = min(T, neighbor_length + 1)
    starts = list(range(0, max(T - NL, 0) + 1, max(1, neighbor_length // 2)))
    if starts[-1] != T - NL:
        starts.append(T - NL)
    return NL, [(s, [i for i in range(0, T, max(1, ref_stride))
                     if i < s or i >= s + NL]) for s in starts]


class Propainter:
    """params: a dict with any of "raft", "flow_comp" and "generator", each
    a JAX parameter tree (numpy) or the port's state dict; what it lacks
    (all of it for None) takes seeded random weights. `load_checkpoints`
    reads it from the config's files. compute_dtype: None gives bf16 on
    CUDA and f32 on the CPU. `stage_hook`, if set, is called as each stage of a chunk is
    enqueued, with its name and outputs: ("raft", flows_f, flows_b),
    ("flow_completion", completed_f, completed_b), ("propagation",
    propagated frames, updated masks), ("generator", composited chunk).
    mesh: a ("data", "model") DeviceMesh to shard the work over, or None."""

    def __init__(self, repo_id=None, device="cuda",
                 config: Optional[ProPainterConfig] = None, params=None,
                 seed: int = 0, compute_dtype=None, mesh=None):
        # repo_id is accepted for the reference constructor's signature
        self.cfg = cfg = config or ProPainterConfig()
        self.device = torch.device(device or "cuda")
        self.dtype = compute_dtype or (
            torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.stage_hook: Optional[Callable[..., None]] = None
        self.mesh = mesh
        with torch.device(self.device):
            self.raft = RAFT(iters=cfg.raft_iters)
            self.flow_comp = RecurrentFlowCompleteNet(cfg.flowcomp_base)
            self.generator = InpaintGenerator(
                cfg.channels, cfg.hidden, cfg.depths, cfg.num_heads,
                tuple(cfg.window), tuple(cfg.pool), cfg.t_dilation,
                cfg.ffn_channels)
        modules = {"raft": self.raft, "flow_comp": self.flow_comp,
                   "generator": self.generator}
        params = params or {}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, m in modules.items():
            sd = params.get(name)
            if sd is None:
                _init_random_(m, gen)
                continue
            if any(isinstance(v, dict) for v in sd.values()):
                sd = jax_params_to_state_dict(sd, name)
            m.load_state_dict(sd)
        for m in modules.values():
            for sub in m.modules():
                if isinstance(sub, _CONVS):
                    sub.to(self.dtype)
            m.eval().requires_grad_(False)

    def _stage(self, name: str, *outputs) -> None:
        if self.stage_hook is not None:
            self.stage_hook(name, *outputs)

    # ------------------------------------------------------------------
    def _stage1(self, fr, mk):
        """RAFT both ways, flow completion and image propagation of one
        chunk. fr (T, h, w, 3) uint8, mk (T, h, w) bool -> frames01 and
        masks1 (f32), the propagated frames (compute dtype, in [-1, 1]), the
        updated masks and the completed flows, all NCHW."""
        dt = self.dtype
        frames01 = fr.permute(0, 3, 1, 2).float() / 255.0
        masks1 = mk.float()[:, None]
        imgs = (frames01 * 2.0 - 1.0).to(dt)

        def raft(a, b):
            record_sharding("propainter_stage1", frames=a)
            return self.raft(a, b)
        with trace_annotation("pp.raft"):
            fl_f = run_sharded(self.mesh, raft, imgs[:-1], imgs[1:],
                               even=False)
            fl_b = run_sharded(self.mesh, raft, imgs[1:], imgs[:-1],
                               even=False)
        self._stage("raft", fl_f, fl_b)
        with trace_annotation("pp.flow_completion"):
            comp_f, comp_b = self.flow_comp.forward_bidirect_flow(
                fl_f, fl_b, masks1, self.mesh)
        self._stage("flow_completion", comp_f, comp_b)
        with trace_annotation("pp.propagation"):
            masked = imgs.float() * (1.0 - masks1)
            prop, upd_masks = image_propagation(masked, masks1, comp_f,
                                                comp_b, "nearest")
            updated = (imgs.float() * (1.0 - masks1) + prop * masks1).to(dt)
        self._stage("propagation", updated, upd_masks)
        return frames01, masks1, updated, upd_masks, comp_f, comp_b

    def _window(self, stage1, start: int, NL: int, refs):
        """The InpaintGenerator over frames start .. start + NL - 1 and the
        reference frames `refs`: (NL, 3, h, w) f32 in [0, 1]."""
        _, masks1, updated, upd_masks, comp_f, comp_b = stage1
        ids = list(range(start, start + NL)) + list(refs)
        pred = self.generator(
            updated[ids], (comp_f[start:start + NL - 1],
                           comp_b[start:start + NL - 1]),
            masks1[ids], upd_masks[ids], NL)
        return (pred + 1.0) / 2.0

    def _windows(self, stage1, NL: int, plan):
        """The generator's prediction of every window of `plan`, in order.
        With a mesh each rank runs its share of each group of windows with
        one reference count (a group padded to a multiple of "data" by
        repeating its last window) and the predictions are all-gathered."""
        if data_coords(self.mesh)[1] == 1:
            return [self._window(stage1, s, NL, refs) for s, refs in plan]
        groups: dict[int, list] = {}
        for i, (_, refs) in enumerate(plan):
            groups.setdefault(len(refs), []).append(i)
        preds = [None] * len(plan)
        for ids in groups.values():
            def run(mine):
                record_sharding("propainter_window", starts=mine)
                return torch.stack([self._window(stage1, plan[i][0], NL,
                                                 plan[i][1])
                                    for i in mine.tolist()])
            out = run_sharded(self.mesh, run, torch.tensor(ids), even=False)
            for j, i in enumerate(ids):
                preds[i] = out[j]
        return preds

    def _run_chunk(self, fr, mk, neighbor_length: int, ref_stride: int):
        """One chunk -> the composited prior (T, h, w, 3) f32 in [0, 1]:
        the windows averaged per frame inside the mask, the input outside."""
        stage1 = self._stage1(fr, mk)
        frames01, masks1 = stage1[:2]
        T = fr.shape[0]
        NL, plan = window_plan(T, neighbor_length, ref_stride)
        with trace_annotation("pp.generator"):
            preds = self._windows(stage1, NL, plan)
        acc = torch.zeros_like(frames01)
        wsum = torch.zeros(T, 1, 1, 1, device=fr.device)
        for (s, _), pred in zip(plan, preds):
            acc[s:s + NL] += pred
            wsum[s:s + NL] += 1.0
        out01 = frames01 * (1.0 - masks1) + acc / wsum * masks1
        self._stage("generator", out01)
        return out01.clamp(0.0, 1.0).permute(0, 2, 3, 1)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, frames, masks, ref_stride: int = 10,
                neighbor_length: int = 10, subvideo_length: int = 50,
                mask_dilation: int = 0, progress=None,
                return_device: bool = False):
        """frames: (T, H, W, 3) RGB uint8 (list, array or tensor); masks:
        (T, H, W) or (T, H, W, 3) uint8, nonzero = hole. Returns a list of
        (H, W, 3) uint8 arrays, or with return_device=True one (T, h, w, 3)
        uint8 tensor on the device at the internal resolution (what
        DiffuEraser takes)."""
        prog = progress or _null_prog
        fr = stack_frames(frames, self.device)
        mk = stack_frames(masks, self.device)
        if mk.dim() == 4:
            mk = (mk > 0).any(-1)
        m_bool = binary_dilation(mk, mask_dilation) if mask_dilation > 0 \
            else mk > 0
        T, H0, W0 = fr.shape[:3]
        h, w = plan_long_side(H0, W0, self.cfg.max_img_size, 8)
        resized = (H0, W0) != (h, w)

        if T < 2:
            # one frame has nothing to propagate from: fill the hole with
            # the mean colour of the known pixels
            known = ~m_bool[..., None]
            f64 = fr.double()
            ksum = known.sum((1, 2), keepdim=True).clamp(min=1)
            mean = (f64 * known).sum((1, 2), keepdim=True) / ksum
            out = torch.round(torch.where(known, f64, mean)).clamp(0, 255) \
                .to(torch.uint8)
            if return_device:
                return host_resize_bilinear_u8(out, h, w) if resized else out
            return list(out.cpu().numpy())

        if resized:
            fr = host_resize_bilinear_u8(fr, h, w)
            m_bool = host_resize_nearest_2d(m_bool.to(torch.uint8), h, w) > 0
        sub = max(2, min(subvideo_length, T))
        overlap = min(4, sub // 2) if T > sub else 0
        n_chunks = max(1, -(-(T - overlap) // (sub - overlap))) \
            if T > sub else 1
        out = torch.zeros(T, h, w, 3, device=self.device)
        wsum = torch.zeros(T, 1, 1, 1, device=self.device)
        start = ci = 0
        while start < T:
            end = min(start + sub, T)
            s = max(0, end - sub)  # pad the chunk back to the full length
            prog(20 + 28 * ci / n_chunks, f"propainter chunk {ci + 1}")
            out[s:s + sub] += self._run_chunk(
                fr[s:s + sub], m_bool[s:s + sub], neighbor_length,
                ref_stride) * 255.0
            wsum[s:s + sub] += 1.0
            ci += 1
            if end >= T:
                break
            start = end - overlap
        out = torch.round(out / wsum).clamp(0, 255).to(torch.uint8)
        if return_device:
            return out
        if resized:
            out = host_resize_bilinear_u8(out, H0, W0)
        return list(out.cpu().numpy())

    __call__ = forward
