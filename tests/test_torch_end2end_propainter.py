"""The port's Propainter against the JAX package's on the CPU (f32, 64x64),
with the same weights (made by the port, carried by the JAX package's
converter) and the same frames: a chunk's first stage (RAFT both ways, flow
completion, image propagation), the InpaintGenerator over each window of
the chunk, and forward end to end with the chunk blend.

Windows (neighbor 4, ref stride 4): NL = 5 frames at starts 0 and 1 of a
6-frame chunk, the first with no reference and the second with frame 0
(l_t = 5 of 6 frames; the windows overlap); 8 frames with subvideo 6 run
two chunks of 6 that overlap by 3 and blend; a third case dilates the
masks by 2 before the prior. Stages and windows are held
to max|port - JAX| <= 1e-4 * max|JAX|; the uint8 prior must equal the JAX
one outside the mask and stay above 40 dB PSNR inside.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from videovanish_tpu.config import ProPainterConfig as JProPainterConfig
from videovanish_tpu.core.convert import (
    FLOWCOMP_RULES, PROPAINTER_RULES, RAFT_RULES, convert_state_dict,
)
from videovanish_tpu.models.propainter import Propainter as JPropainter
from videovanish_tpu_torch.config import ProPainterConfig, tiny_config
from videovanish_tpu_torch.models.propainter.model import (
    Propainter, window_plan,
)

# tiny_config's ProPainter with sub-videos of 6 frames
PCFG = dict(tiny_config().propainter.__dict__, subvideo_length=6)
PSNR_MIN = 40.0
REL = 1e-4


@functools.lru_cache(maxsize=None)
def propainters():
    """(port Propainter, JAX Propainter) with the same seeded weights,
    built once per process: the JAX instance keeps its compiled programs
    for every test that reuses it (tests/test_torch_infill.py does)."""
    port = Propainter(config=ProPainterConfig(**PCFG), device="cpu", seed=4)
    rules = {"raft": RAFT_RULES, "flow_comp": FLOWCOMP_RULES,
             "generator": PROPAINTER_RULES}
    params = {name: convert_state_dict(
        {k: v.numpy() for k, v in getattr(port, name).state_dict().items()},
        rule) for name, rule in rules.items()}
    return port, JPropainter(config=JProPainterConfig(**PCFG), params=params)


def scene(T, H, W, seed=0):
    """Textured frames shifting right 2 px per frame under a moving
    rectangle mask (uint8; masks in {0, 255})."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H // 4, W // 4 + T, 3), np.uint8)
    base = np.repeat(np.repeat(base, 4, 0), 4, 1)
    frames = np.stack([base[:, 2 * t:2 * t + W] for t in range(T)])
    masks = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        masks[t, H // 4:H // 2 + 4, W // 4 + 3 * t:W // 2 + 3 * t] = 255
    return frames, masks


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    limit = rel * max(np.abs(want).max(), 1e-6)
    assert err <= limit, f"max|port - jax| = {err:.3e} > {limit:.3e}"


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def _jax_stage1(jpp, frames, masks):
    T, H, W = masks.shape
    return jpp._stage1_fn(T, H, W)(
        jpp.params, jnp.asarray(frames),
        jnp.asarray(np.packbits(masks > 0, axis=-1)))


def test_stage1_matches_jax():
    """Completed flows within the tolerance; the propagated frames and the
    updated masks identical (the propagation's rounding and thresholds see
    flows equal to about 1e-6)."""
    port, jpp = propainters()
    frames, masks = scene(6, 64, 64, seed=6)
    want = _jax_stage1(jpp, frames, masks)
    with torch.no_grad():
        got = port._stage1(torch.from_numpy(frames),
                           torch.from_numpy(masks > 0))
    _, _, upd_j, upd_m_j, cf_j, cb_j = (np.asarray(a) for a in want)
    _, _, upd_p, upd_m_p, cf_p, cb_p = (_nhwc(t) for t in got)
    assert_close(cf_p, cf_j)
    assert_close(cb_p, cb_j)
    flips = int((upd_m_p != upd_m_j).sum())
    assert flips == 0, f"{flips} updated-mask pixels differ"
    assert_close(upd_p, upd_j)
    # the propagation filled part of the holes
    assert 0 < upd_m_j.sum() < (masks > 0).sum()


@pytest.mark.parametrize("window", [0, 1], ids=["no_ref", "one_ref"])
def test_generator_window_matches_jax(window):
    """The InpaintGenerator over a window of a 6-frame chunk (frames 0-4
    without a reference; frames 1-5 with frame 0 as reference, l_t = 5 < 6
    frames), fed the JAX first stage's outputs on both sides."""
    port, jpp = propainters()
    frames, masks = scene(6, 64, 64, seed=6)
    stage1 = _jax_stage1(jpp, frames, masks)
    NL, plan = window_plan(6, PCFG["neighbor_length"], PCFG["ref_stride"])
    s, refs = plan[window]
    assert len(refs) == window
    want = jpp._window_fn(NL, len(refs), 64, 64)(
        jpp.params, *(stage1[i] for i in (2, 3, 1, 4, 5)),
        jnp.int32(s), jnp.asarray(refs, jnp.int32))
    with torch.no_grad():
        got = port._window(tuple(_nchw(a) for a in stage1), s, NL, refs)
    assert_close(_nhwc(got), want)


def check_prior(got, want, frames, masks):
    """uint8-identical outside the mask (and equal to the input there),
    PSNR inside; the message counts the pixels that differ inside."""
    assert got.shape == want.shape == frames.shape and got.dtype == np.uint8
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], want[~hole])
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    err = got[hole].astype(np.float64) - want[hole]
    psnr = 10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12))
    n_diff = int((np.abs(err) > 1).any(-1).sum())
    assert psnr > PSNR_MIN, (f"PSNR inside the mask {psnr:.2f} dB; "
                             f"{n_diff} of {hole.sum()} pixels differ by > 1")
    # the prior really painted the hole
    assert np.abs(got[hole].astype(int) - frames[hole]).mean() > 4


@pytest.mark.parametrize("T,dilation", [(6, 0), (8, 0), (6, 2)],
                         ids=["one_chunk", "two_chunks", "mask_dilation"])
def test_forward_matches_jax(T, dilation):
    port, jpp = propainters()
    frames, masks = scene(T, 64, 64, seed=T + dilation)
    kw = dict(ref_stride=PCFG["ref_stride"],
              neighbor_length=PCFG["neighbor_length"],
              subvideo_length=PCFG["subvideo_length"],
              mask_dilation=dilation)
    want = np.stack(jpp.forward(list(frames), list(masks), **kw))
    got = np.stack(port.forward(list(frames), list(masks), **kw))
    if dilation:
        masks = np.stack([binary_dilation(m > 0, iterations=dilation)
                          for m in masks])
    check_prior(got, want, frames, masks)


def test_single_frame_with_internal_resize():
    """T = 1 at 300x300 (internal size 256x256): the mean-colour fill at
    the input resolution, identical to JAX's; the device hand-off is the
    fill resized to the internal size."""
    port, jpp = propainters()
    rng = np.random.default_rng(5)
    f = rng.integers(0, 256, (300, 300, 3), np.uint8)
    m = np.zeros((300, 300), np.uint8)
    m[100:150, 100:150] = 255
    want = jpp.forward([f], [m])
    got = port.forward([f], [m])
    assert len(got) == 1 and got[0].shape == (300, 300, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][:100], f[:100])
    assert (got[0][100:150, 100:150] != f[100:150, 100:150]).any()
    dev = port.forward([f], [m], return_device=True)
    assert tuple(dev.shape) == (1, 256, 256, 3)
