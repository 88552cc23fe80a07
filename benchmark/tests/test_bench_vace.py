"""The VACE cell at tiny widths on the CPU: the reference against the port
through the harness, a broken sampler caught by the check, the counts
behind `attn_roofline.vace`, and that the attention calls the reference
takes in query blocks cost what the whole calls cost at the cell's
shapes."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark import configs, harness
from benchmark.counts.roofline import least_seconds

torch.set_num_threads(1)
CELL = "vace.720p.81f"


def tiny_vace(frames: int = 9):
    from videovanish_tpu_torch.config import tiny_wan_config
    spec = configs.load(harness.workload(CELL)["config"])
    spec = dict(spec, wan=dataclasses.asdict(tiny_wan_config()))
    wl = harness.workload(CELL)
    wl["traffic"] = dict(wl["traffic"], frames=frames, height=64, width=96)
    wl["limits"] = {"frames_rms": 0.05, "outside_px": 0,
                    "latent_rel_rms": 1e-4}
    return spec, wl


def run(trace=False, seed=4):
    spec, wl = tiny_vace()
    return harness.run_cell(CELL, seed, 0.5, trace, time.perf_counter(),
                            device="cpu", wl=wl, cfg=spec)


def test_reference_agrees_with_the_port():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 3
    assert r["checks"]["latent_rel_rms"]["value"] < 1e-5


def test_a_sampler_that_keeps_its_state_is_caught(monkeypatch):
    from videovanish_tpu_torch.models.wan.model import FlowUniPC
    orig = FlowUniPC.step

    def unchanged(self, model_output, sample):
        orig(self, model_output, sample)
        return sample
    monkeypatch.setattr(FlowUniPC, "step", unchanged)
    r = run()
    assert not r["correct"]
    assert r["checks"]["latent_rel_rms"]["value"] > 0.1


def test_counts_at_tiny_widths():
    """9 frames of 64x96 at 48x64 inference: 3 x 3 x 4 = 36 tokens, two
    heads of 32; per step two forwards of 4 main and 2 VACE blocks, each a
    self-attention and a 16-row cross-attention; the VAE's mid-block (one
    head of 32 over 6 x 8 latent pixels) once a latent frame in each of
    the two encodes and the decode."""
    from benchmark.entries.vace import Entry
    spec, wl = tiny_vace()
    e = Entry(spec, wl, 5, "cpu", program=False)
    e.pool_from(np.random.default_rng(5))
    *_, counts = e.reference(0, count=True)
    calls = counts["attention"]["wan"]
    steps, blocks = spec["wan"]["sample_steps"], 4 + 2
    assert calls.count((1, 2, 36, 36, 32)) == 2 * steps * blocks
    assert calls.count((1, 2, 36, 16, 32)) == 2 * steps * blocks
    assert calls.count((1, 1, 48, 48, 32)) == 3 * 3
    assert len(calls) == 4 * steps * blocks + 9
    assert counts["flops"] > 0


@pytest.mark.parametrize("call", [
    (1, 12, 31668, 31668, 128), (1, 12, 31668, 512, 128),
    (1, 1, 6032, 6032, 384)])
def test_query_blocks_cost_the_whole_call(call):
    """The reference's plain attention takes its queries in blocks that
    keep 4 GiB of f32 scores; at each of the cell's shapes every block is
    bound by its operations, so the blocks' least times add up to the
    whole call's."""
    B, H, Sq, Sk, D = call
    rows = max(1, (1 << 32) // (B * H * Sk * 4))
    blocks = [(B, H, min(rows, Sq - i), Sk, D) for i in range(0, Sq, rows)]
    peak = harness.peaks("NVIDIA H100 80GB HBM3")
    args = (peak["bf16_flops"], peak["hbm_bytes_per_s"])
    assert least_seconds(blocks, *args) == pytest.approx(
        least_seconds([call], *args), rel=1e-12)
