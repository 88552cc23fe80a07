"""The port's chunked long-video pipeline (pipeline/chunking.py) against the
JAX package's and against its own single pass, on 20-frame 64x64 files
(chunks of 8 overlapping by 2: (0, 8), (6, 14), (12, 20)).

The DiffuEraser runs one temporal window per chunk (clip_length 8 >=
chunk_frames 8, as tiny_config has): the JAX package's decode of a call
that emits fewer than 8 frames from two or more windows is wrong (ROADMAP,
Queue 3), and a chunk that withholds its overlap tail emits 6. The
networks are the one-level UNet and BrushNet of tests/test_torch_infill.py
and the Propainter of tests/test_torch_end2end_propainter.py, the same
weights in both packages.
"""
import json
import os

import numpy as np
import pytest
import torch

import videovanish_tpu.pipeline.infill as jinfill
from test_torch_end2end_propainter import PCFG, propainters
from test_torch_infill import (
    GEOMETRY, ONE_LEVEL, _jax_diffueraser, _scene, assert_matches_jax,
)
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.config import ChunkingConfig as JChunkingConfig
from videovanish_tpu.config import DiffuEraserConfig as JCfg
from videovanish_tpu.config import ProPainterConfig as JPCfg
from videovanish_tpu.config import VVConfig as JVV
from videovanish_tpu.config import tiny_config as j_tiny
from videovanish_tpu.pipeline.chunking import (
    _chunk_plan as j_chunk_plan, _pair_overlaps as j_pair_overlaps,
    vanish_video_chunked as j_vanish_video_chunked,
)
from videovanish_tpu.utils.observability import (
    collect_stages as j_collect_stages,
)
from videovanish_tpu.video import io as jio
from videovanish_tpu_torch.config import (
    ChunkingConfig, DiffuEraserConfig, ProPainterConfig, VVConfig,
)
from videovanish_tpu_torch.core.prog import CancelledError
from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
from videovanish_tpu_torch.pipeline import infill as pinfill
from videovanish_tpu_torch.pipeline.chunking import (
    _chunk_plan, _pair_overlaps, vanish_video_chunked,
)
from videovanish_tpu_torch.utils.observability import collect_stages
from videovanish_tpu_torch.video import io as pio

T, H, W = 20, 64, 64
CHUNK, OVERLAP = 8, 2
# one window of 8 per chunk
FLAGS = dict(ONE_LEVEL, clip_length=8, clip_overlap=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Shared weights, the JAX noise of frames 0-19, and the color and
    mask files (a moving textured scene under a rectangle)."""
    params, _, _, _, _ = _scene(**ONE_LEVEL)
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key, i), (H // 8, W // 8, 4), jnp.float32))(
        jnp.arange(T)))
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (H // 8, W // 8 + T, 3), np.uint8)
    base = np.repeat(np.repeat(base, 8, 0), 8, 1)
    frames = np.stack([base[:, t:t + W] for t in range(T)])
    masks = np.zeros((T, H, W, 3), np.uint8)
    for t in range(T):
        masks[t, 16:36, 12 + t:36 + t] = 255
    d = tmp_path_factory.mktemp("chunked")
    color, mask = str(d / "color.mkv"), str(d / "mask.mkv")
    pio.write_video_frames_to_path(color, list(frames), 24.0, H, W)
    pio.write_video_frames_to_path(mask, list(masks), 24.0, H, W)
    return params, noise, frames, masks, color, mask


def _port_models(params, noise):
    dcfg = DiffuEraserConfig(**{**GEOMETRY, **FLAGS})
    pinfill.set_config(VVConfig(
        diffueraser=dcfg, propainter=ProPainterConfig(**PCFG),
        chunking=ChunkingConfig(chunk_frames=CHUNK, overlap_frames=OVERLAP)))
    pinfill.video_inpainting_sd = DiffuEraser(
        config=dcfg, params=params, device="cpu",
        noise=lambda idx, shape: torch.from_numpy(noise[list(idx)]))
    pinfill.last_ckpt = "2-Step"
    pinfill.propainter = propainters()[0]


def _run_port(setup, out, **kw):
    params, noise, _, _, color, mask = setup
    _port_models(params, noise)
    try:
        return vanish_video_chunked(color, mask, out, max_img_size=H,
                                    device="cpu", **kw)
    finally:
        pinfill.set_config(VVConfig())


def _read(path):
    frames, fps = pio.load_video_frames_from_path(path)
    assert fps == 24.0
    return np.stack(frames)


def test_chunk_plan_matches_jax():
    for total, chunk, ov in [(1, 8, 2), (8, 8, 2), (9, 8, 2), (20, 8, 2),
                             (100, 48, 8), (88, 48, 8), (49, 48, 8),
                             (1000, 48, 8), (10, 4, 1), (7, 3, 2)]:
        plan = _chunk_plan(total, chunk, ov)
        assert plan == j_chunk_plan(total, chunk, ov), (total, chunk, ov)
        assert _pair_overlaps(plan) == j_pair_overlaps(plan)
    assert _chunk_plan(88, 48, 8) == [(0, 48), (40, 88)]


def test_chunked_matches_jax_and_single_pass(setup, tmp_path):
    """The port's chunked file against the JAX package's chunked file
    (uint8-identical outside the feathered mask, PSNR > 45 dB inside), and
    its stage records: every stage of the JAX run with the JAX fields,
    plus the chunked run's own; then, with a prior that is a function of
    each frame alone (so that chunks and the single pass see the same
    prior), the chunked file within 1 of the port's single pass over all
    20 frames, whose windows are the chunks'."""
    params, noise, frames, masks, color, mask = setup
    with collect_stages([]) as stages:
        got = _read(_run_port(setup, str(tmp_path / "port.mkv")))

    dcfg = JCfg(**{**GEOMETRY, **FLAGS})
    jinfill.set_config(JVV(
        diffueraser=dcfg, propainter=JPCfg(**PCFG),
        chunking=JChunkingConfig(chunk_frames=CHUNK,
                                 overlap_frames=OVERLAP)))
    jinfill.video_inpainting_sd = _jax_diffueraser(params, dcfg)
    jinfill.last_ckpt = "2-Step"
    jinfill.propainter = propainters()[1]
    try:
        with j_collect_stages([]) as j_stages:
            j_vanish_video_chunked(color, mask, str(tmp_path / "jax.mkv"),
                                   max_img_size=H)
    finally:
        jinfill.set_config(j_tiny())
    want = np.stack(jio.load_video_frames_from_path(
        str(tmp_path / "jax.mkv"))[0])
    assert_matches_jax(list(got), list(want), frames, masks[..., 0])
    fields = {name: set(f) for name, _, f in stages}
    j_fields = {name: set(f) for name, _, f in j_stages}
    assert {name: fields.get(name) for name in j_fields} == j_fields
    assert set(fields) - set(j_fields) == {"chunk", "chunk_save",
                                           "assemble"}

    def frame_prior(frames_t, dilated, prog, device):
        return frames_t  # each frame's own pixels: the same in any chunk

    orig = pinfill._prior
    pinfill._prior = frame_prior
    try:
        chunked = _read(_run_port(setup, str(tmp_path / "framewise.mkv")))
        _port_models(params, noise)
        single = np.stack(pinfill.run_infill_on_frames(
            list(frames), list(masks), max_img_size=H, device="cpu"))
    finally:
        pinfill._prior = orig
        pinfill.set_config(VVConfig())
    assert chunked.shape == single.shape == frames.shape
    assert np.abs(chunked.astype(int) - single).max() <= 1


def test_resume_after_cancel_is_bitwise(setup, tmp_path):
    """A run cancelled once chunk 0 is saved, then resumed, computes only
    chunks 1 and 2 and writes the file of an uninterrupted run bitwise; a
    second uninterrupted run writes it again; the work directory goes
    once the file is written. A work directory left by another job id (the
    JAX package's, or another device's) is not resumed: every chunk is
    computed again and the file is the uninterrupted run's."""
    first = _read(_run_port(setup, str(tmp_path / "a.mkv")))
    again = _read(_run_port(setup, str(tmp_path / "b.mkv")))
    np.testing.assert_array_equal(first, again)

    cancel = []

    def prog(pct, status="", **_):
        if status == "[chunk 1/3] done":
            cancel.append(True)

    out, wd = str(tmp_path / "c.mkv"), str(tmp_path / "work")
    with pytest.raises(CancelledError):
        _run_port(setup, out, work_dir=wd, prog=prog,
                  is_canceled=lambda: bool(cancel))
    with open(os.path.join(wd, "manifest.json")) as f:
        assert json.load(f)["completed"] == [0]
    assert not os.path.exists(out)

    calls = []
    orig = pinfill.run_infill_on_frames

    def counting(*a, **k):
        calls.append(k["frame_offset"])
        return orig(*a, **k)

    pinfill.run_infill_on_frames = counting
    try:
        _run_port(setup, out, work_dir=wd)
    finally:
        pinfill.run_infill_on_frames = orig
    assert calls == [6, 12]
    np.testing.assert_array_equal(_read(out), first)
    assert not os.path.exists(wd)

    # a foreign manifest claiming every chunk, beside a wrong chunk file
    os.makedirs(wd)
    with open(os.path.join(wd, "manifest.json"), "w") as f:
        json.dump({"job_id": "0123456789abcdef", "chunks": 3,
                   "completed": [0, 1, 2]}, f)
    np.savez_compressed(os.path.join(wd, "chunk_00000.npz"),
                        frames=np.zeros((6, H, W, 3), np.uint8),
                        carry_z=np.zeros((2, H // 8, W // 8, 4), np.float32),
                        carry_w=np.ones((2,), np.float32))
    calls.clear()
    pinfill.run_infill_on_frames = counting
    try:
        _run_port(setup, out, work_dir=wd)
    finally:
        pinfill.run_infill_on_frames = orig
    assert calls == [0, 6, 12]
    np.testing.assert_array_equal(_read(out), first)
