"""The port's run_infill_on_frames against the JAX package's, end to end on
the CPU at a small geometry (64x64, 8 frames: two windows of 6 overlapping
by 2, so the window blend runs; a two-level UNet and BrushNet, which have
every block kind of SD1.5's four levels at half the JAX compile time), with
the same weights and noise, the prior passed in or computed by each
package's Propainter (the same weights on both sides; sub-videos of 6
frames): uint8-identical where the feathered alpha is 0, PSNR above 45 dB
where it is not. Plus the window plan, the blend ramps, the resizes against
cv2, and a call without a prior.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videovanish_tpu.pipeline.infill as jinfill
from test_torch_end2end_propainter import PCFG, propainters
from videovanish_tpu.config import DiffuEraserConfig as JCfg
from videovanish_tpu.config import ProPainterConfig as JPCfg
from videovanish_tpu.config import VVConfig as JVV
from videovanish_tpu.config import tiny_config as j_tiny
from videovanish_tpu.core.convert import (
    UNET_RULES, UNET_SPECIALS, VAE_RULES, convert_state_dict,
)
from videovanish_tpu.models.diffueraser import DiffuEraser as JDiffuEraser
from videovanish_tpu.models.diffueraser.model import (
    make_window_plan as j_plan, window_blend_weights as j_weights,
)
from videovanish_tpu_torch.config import (
    DiffuEraserConfig, ProPainterConfig, VVConfig,
)
from videovanish_tpu_torch.models.diffueraser.model import (
    DiffuEraser, make_window_plan, window_blend_weights,
)
from videovanish_tpu_torch.ops import resize as presize
from videovanish_tpu_torch.ops.edt import feather_alpha
from videovanish_tpu_torch.ops.morphology import binarize_and_dilate
from videovanish_tpu_torch.pipeline import infill as pinfill

H = W = 64
T = 8
GEOMETRY = dict(max_img_size=H, clip_length=6, clip_overlap=2,
                block_out_channels=(32, 64), layers_per_block=1,
                cross_attention_dim=64, attention_head_dim=8,
                vae_block_out_channels=(16, 16, 16, 16))
FEATHER = 3
DILATE = 8


@pytest.fixture(scope="module")
def shared():
    """Seeded random weights as a JAX parameter tree (made by the port,
    carried over by the JAX package's own converter), the JAX noise, and
    the test_e2e_quality scene."""
    port = DiffuEraser(config=DiffuEraserConfig(**GEOMETRY), device="cpu",
                       seed=3)

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    rng = np.random.default_rng(11)
    params = {
        "vae": convert_state_dict(sd(port.vae), VAE_RULES),
        "unet": convert_state_dict(sd(port.unet), UNET_RULES, UNET_SPECIALS),
        "brushnet": convert_state_dict(sd(port.brushnet), UNET_RULES,
                                       UNET_SPECIALS),
        "null_text_emb": (rng.standard_normal((77, 64)) * 0.1)
        .astype(np.float32),
    }
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key, i), (H // 8, W // 8, 4), jnp.float32))(
        jnp.arange(T)))
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (T, H // 8, W // 8, 3), np.uint8)
    frames = np.repeat(np.repeat(base, 8, 1), 8, 2)
    masks = np.zeros((T, H, W), np.uint8)
    masks[:, 16:32, 24:48] = 255
    prior = np.repeat(np.repeat(
        rng.integers(0, 255, (T, H // 16, W // 16, 3), np.uint8), 16, 1),
        16, 2)
    return params, noise, frames, masks, prior


_JAX_MODELS = {}


def _jax_diffueraser(params, dcfg):
    """One JAX DiffuEraser per weights and config in a process: it keeps
    its compiled programs for every test that reuses it."""
    key = (id(params), dcfg)
    if key not in _JAX_MODELS:
        _JAX_MODELS[key] = JDiffuEraser(config=dcfg, params=params, seed=0)
    return _JAX_MODELS[key]


def _run_jax(params, frames, masks, prior, **flags):
    """prior None: the JAX Propainter of `propainters()` computes it."""
    dcfg = JCfg(**GEOMETRY, **flags)
    jinfill.set_config(JVV(diffueraser=dcfg, propainter=JPCfg(**PCFG)))
    jinfill.video_inpainting_sd = _jax_diffueraser(params, dcfg)
    jinfill.last_ckpt = "2-Step"
    # the prior is passed in (never called), or computed by the shared one
    jinfill.propainter = object() if prior is not None else propainters()[1]
    try:
        return np.stack(jinfill.run_infill_on_frames(
            list(frames), list(masks), mask_dilation_iter=DILATE,
            propainer_frames=None if prior is None else list(prior),
            max_img_size=H, feather_px=FEATHER))
    finally:
        jinfill.set_config(j_tiny())


def _run_port(params, noise, frames, masks, prior, **flags):
    dcfg = DiffuEraserConfig(**GEOMETRY, **flags)
    pinfill.set_config(VVConfig(diffueraser=dcfg,
                                propainter=ProPainterConfig(**PCFG)))
    pinfill.video_inpainting_sd = DiffuEraser(
        config=dcfg, params=params, device="cpu",
        noise=lambda idx, shape: torch.from_numpy(noise[list(idx)]))
    pinfill.last_ckpt = "2-Step"
    pinfill.propainter = propainters()[0]
    try:
        return np.stack(pinfill.run_infill_on_frames(
            list(frames), list(masks), mask_dilation_iter=DILATE,
            propainer_frames=None if prior is None else list(prior),
            max_img_size=H, feather_px=FEATHER, device="cpu"))
    finally:
        pinfill.set_config(VVConfig())


def check_pipeline_matches_jax(shared, computed_prior=False, **flags):
    params, noise, frames, masks, prior = shared
    if computed_prior:
        prior = None
    ref = _run_jax(params, frames, masks, prior, **flags)
    got = _run_port(params, noise, frames, masks, prior, **flags)
    assert got.shape == ref.shape == frames.shape and got.dtype == np.uint8
    dil = binarize_and_dilate(torch.from_numpy(masks[..., None]), DILATE)
    alpha = feather_alpha(dil > 0, float(FEATHER)).numpy()
    outside = alpha == 0
    assert outside.any() and (~outside).any()
    np.testing.assert_array_equal(got[outside], ref[outside])
    np.testing.assert_array_equal(got[outside], frames[outside])
    err = got[~outside].astype(np.float64) - ref[~outside]
    psnr = 10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12))
    assert psnr > 45.0, f"PSNR inside the mask {psnr:.2f} dB"
    # the model really changed the masked pixels
    assert np.abs(got[~outside].astype(int) - frames[~outside]).max() > 8


def test_pipeline_matches_jax(shared):
    """brushnet_feature_reuse and spatial_attn_reuse at their default (on);
    tests/test_torch_infill_exact.py runs both off."""
    check_pipeline_matches_jax(shared)


def test_pipeline_with_computed_prior_matches_jax(shared):
    """propainer_frames=None: each package computes the ProPainter prior
    from the dilated masks (two chunks of 6 frames) and goes on into
    DiffuEraser."""
    check_pipeline_matches_jax(shared, computed_prior=True)


@pytest.mark.parametrize("n,clip,ov", [(12, 6, 2), (22, 22, 6), (5, 22, 6),
                                       (50, 22, 6), (23, 22, 6), (9, 8, 2)])
def test_window_plan_and_weights_match_jax(n, clip, ov):
    plan = make_window_plan(n, clip, ov)
    assert plan == j_plan(n, clip, ov)
    for wi, (s, L) in enumerate(plan):
        o = min(ov, L - 1) if L > 1 else 0
        for first, last in ((wi == 0, wi == len(plan) - 1), (False, False)):
            np.testing.assert_array_equal(window_blend_weights(L, o, first, last),
                                          j_weights(L, o, first, last))


def test_resize_matches_cv2_on_720p_frame():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (720, 1280, 3), np.uint8)
    h, w = presize.plan_long_side(720, 1280, 960, 8)
    assert (h, w) == (544, 960)
    got = presize.host_resize_bilinear_u8(torch.from_numpy(frame[None]), h, w)
    ref = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
    assert np.abs(got[0].numpy().astype(int) - ref).max() <= 1
    mask = (rng.random((720, 1280)) > 0.5).astype(np.uint8)
    got = presize.host_resize_nearest_2d(torch.from_numpy(mask[None]), h, w)
    ref = cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_missing_prior_raises():
    """A call without a prior no longer raises: the port computes the prior
    (here with tiny seeded networks) and returns the frames, unchanged
    outside the feathered mask."""
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (3, 32, 48, 3), np.uint8)
    masks = np.zeros((3, 32, 48), np.uint8)
    masks[:, 8:16, 12:24] = 255
    pinfill.set_config(VVConfig(
        diffueraser=DiffuEraserConfig(**dict(GEOMETRY, max_img_size=48)),
        propainter=ProPainterConfig(**PCFG)))
    try:
        out = pinfill.run_infill_on_frames(list(frames), list(masks),
                                           mask_dilation_iter=1,
                                           max_img_size=48, device="cpu")
    finally:
        pinfill.set_config(VVConfig())
    assert len(out) == 3 and out[0].shape == (32, 48, 3)
    assert out[0].dtype == np.uint8
    np.testing.assert_array_equal(np.stack(out)[:, :, 32:], frames[:, :, 32:])
