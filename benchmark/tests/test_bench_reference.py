"""The reference against the port at tiny_config on the CPU, and the
check's faults: a run of the harness with the timed path broken
underneath comes out not correct, once for each fault the cells can
have (an answer altered where it is produced, a step that returns its
state unchanged, half of the batch left out). On the CPU the port and
the reference both run f32."""
import pytest
import torch

from .helpers import run_tiny

torch.set_num_threads(1)
INFILL, MASK = "infill.720p.24f", "mask.720p.48f.2obj"


@pytest.mark.parametrize("cell,frames", [(INFILL, 8), (MASK, 6)])
def test_reference_agrees_with_the_port(cell, frames):
    r = run_tiny(cell, frames)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 3
    for c in r["checks"].values():
        assert c["value"] <= 1e-3 * max(c["limit"], 1e-3)


def test_traced_run_on_the_cpu():
    """The traced run: three timed requests, one profiled, the check; no
    device activity on the CPU, so no per-layer metric reads anything."""
    r = run_tiny(MASK, 6, trace=True)
    assert r["correct"] and r["attempted"] == 4 and r["metrics"] == {}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert list(r)[-1] == "checks"


def _alter_output(mp):
    from videovanish_tpu_torch.pipeline import infill
    orig = infill.feathered_composite

    def altered(inpainted, frames, dilated, *a, **k):
        out = orig(inpainted, frames, dilated, *a, **k)
        return torch.where(dilated[..., None] > 0, 255 - out, out)
    mp.setattr(infill, "feathered_composite", altered)


def _step_unchanged(mp):
    from videovanish_tpu_torch.models.diffueraser import model
    mp.setattr(model, "consistency_step",
               lambda schedule, x, eps, t, t_next: x)


def _half_of_each_window(mp):
    from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
    orig = DiffuEraser._denoise_window

    def half(self, prior_lat, masked_lat, mask_lat, noise, **kw):
        n = max(1, prior_lat.shape[0] // 2)
        z = orig(self, prior_lat[:n], masked_lat[:n], mask_lat[:n],
                 noise[:n], **dict(kw, t_frames=n))
        rest = z.mean(0, keepdim=True).expand(prior_lat.shape[0] - n,
                                              *z.shape[1:])
        return torch.cat([z, rest])
    mp.setattr(DiffuEraser, "_denoise_window", half)


def _prior_windows_unchanged(mp):
    from videovanish_tpu_torch.models.propainter.model import Propainter

    def passthrough(self, stage1, start, NL, refs):
        updated = stage1[2]
        return (updated[start:start + NL].float() + 1.0) / 2.0
    mp.setattr(Propainter, "_window", passthrough)


def _alter_masks(mp):
    from videovanish_tpu_torch.pipeline import masker
    orig = masker.render_colored_masks

    def altered(segments, H, W):
        out = orig(segments, H, W)
        out[: H // 2] = 255 - out[: H // 2]
        return out
    mp.setattr(masker, "render_colored_masks", altered)


def _bank_unchanged(mp):
    from videovanish_tpu_torch.models.sam2.predictor import (
        Sam2VideoPredictor,
    )
    orig = Sam2VideoPredictor.step

    def frozen(self, f16, f4, f8, bank_feats, bank_ptrs, *a, **k):
        keep = bank_feats.clone(), bank_ptrs.clone()
        out = orig(self, f16, f4, f8, bank_feats, bank_ptrs, *a, **k)
        bank_feats.copy_(keep[0])
        bank_ptrs.copy_(keep[1])
        return out
    mp.setattr(Sam2VideoPredictor, "step", frozen)


def _half_of_the_objects(mp):
    from videovanish_tpu_torch.pipeline import masker
    orig = masker.run_sam2_on_frames

    def first_object(frames, ann, **k):
        kfs = [dict(kf, rects=[r for r in kf.get("rects", [])
                               if r.get("obj", 1) == 1])
               for kf in ann["keyframes"]]
        return orig(frames, {"keyframes": kfs}, **k)
    mp.setattr(masker, "run_sam2_on_frames", first_object)


@pytest.mark.parametrize("cell,frames,fault", [
    (INFILL, 8, _alter_output), (INFILL, 8, _step_unchanged),
    (INFILL, 8, _half_of_each_window), (INFILL, 8, _prior_windows_unchanged),
    (MASK, 6, _alter_masks), (MASK, 6, _bank_unchanged),
    (MASK, 6, _half_of_the_objects)],
    ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_fault_is_not_correct(cell, frames, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(cell, frames)
    assert not r["correct"], r["checks"]
