"""The port's run_infill_on_frames against the JAX package's, end to end on
the CPU at a small geometry (64x64, 8 frames: two windows of 6 overlapping
by 2, so the window blend runs; a two-level UNet and BrushNet, which have
every block kind of SD1.5's four levels at half the JAX compile time), with
the same weights and noise, the prior passed in or computed by each
package's Propainter (the same weights on both sides; sub-videos of 6
frames): uint8-identical where the feathered alpha is 0, PSNR above 45 dB
where it is not. Plus the window plan, the blend ramps, the resizes against
cv2, and a call without a prior. The paths above the networks (guidance,
a prompt embedding, the full-frame output, the latent carry across two
calls) run the same way on a one-level UNet and BrushNet.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videovanish_tpu.pipeline.infill as jinfill
from test_torch_end2end_propainter import PCFG, propainters
from torch_threads import one_torch_thread  # noqa: F401
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
# the guidance / prompt / full-frame and latent-carry tests hold code
# above the networks, so they run a one-level UNet and BrushNet, whose JAX
# programs compile in about a third of the time
ONE_LEVEL = dict(block_out_channels=(32,))
FEATHER = 3
DILATE = 8


def _scene(**geometry):
    """Seeded random weights as a JAX parameter tree (made by the port,
    carried over by the JAX package's own converter), the JAX noise, and
    the test_e2e_quality scene."""
    port = DiffuEraser(config=DiffuEraserConfig(**{**GEOMETRY, **geometry}),
                       device="cpu", seed=3)

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


@pytest.fixture(scope="module")
def shared():
    return _scene()


@pytest.fixture(scope="module")
def shared_one_level():
    return _scene(**ONE_LEVEL)


_JAX_MODELS = {}


def _jax_diffueraser(params, dcfg):
    """One JAX DiffuEraser per weights and config in a process: it keeps
    its compiled programs for every test that reuses it."""
    key = (id(params), dcfg)
    if key not in _JAX_MODELS:
        _JAX_MODELS[key] = JDiffuEraser(config=dcfg, params=params, seed=0)
    return _JAX_MODELS[key]


def _with_forward_args(model, forward_args):
    """The model with `forward_args` overriding those of the pipeline's
    forward call (which passes guidance_scale=None and no prompt)."""
    if forward_args:
        orig = type(model).forward

        def forward(*a, **k):
            return orig(model, *a, **{**k, **forward_args})
        model.forward = forward
    return model


def _run_jax(params, frames, masks, prior, forward_args=None, call=None,
             **flags):
    """prior None: the JAX Propainter of `propainters()` computes it.
    forward_args go into DiffuEraser.forward, call into
    run_infill_on_frames."""
    dcfg = JCfg(**{**GEOMETRY, **flags})
    jinfill.set_config(JVV(diffueraser=dcfg, propainter=JPCfg(**PCFG)))
    model = _jax_diffueraser(params, dcfg)
    jinfill.video_inpainting_sd = _with_forward_args(model, forward_args)
    jinfill.last_ckpt = "2-Step"
    # the prior is passed in (never called), or computed by the shared one
    jinfill.propainter = object() if prior is not None else propainters()[1]
    try:
        return jinfill.run_infill_on_frames(
            list(frames), list(masks), mask_dilation_iter=DILATE,
            propainer_frames=None if prior is None else list(prior),
            max_img_size=H, feather_px=FEATHER, **(call or {}))
    finally:
        model.__dict__.pop("forward", None)
        jinfill.set_config(j_tiny())


def _run_port(params, noise, frames, masks, prior, forward_args=None,
              call=None, latent_hook=None, **flags):
    dcfg = DiffuEraserConfig(**{**GEOMETRY, **flags})
    pinfill.set_config(VVConfig(diffueraser=dcfg,
                                propainter=ProPainterConfig(**PCFG)))
    model = DiffuEraser(
        config=dcfg, params=params, device="cpu",
        noise=lambda idx, shape: torch.from_numpy(noise[list(idx)]))
    model.latent_hook = latent_hook
    pinfill.video_inpainting_sd = _with_forward_args(model, forward_args)
    pinfill.last_ckpt = "2-Step"
    pinfill.propainter = propainters()[0]
    try:
        return pinfill.run_infill_on_frames(
            list(frames), list(masks), mask_dilation_iter=DILATE,
            propainer_frames=None if prior is None else list(prior),
            max_img_size=H, feather_px=FEATHER, device="cpu",
            **(call or {}))
    finally:
        pinfill.set_config(VVConfig())


def _outside(masks):
    """Where the feathered alpha of the dilated masks is 0."""
    dil = binarize_and_dilate(torch.from_numpy(masks[..., None]), DILATE)
    return feather_alpha(dil > 0, float(FEATHER)).numpy() == 0


def _psnr(a, b) -> float:
    err = a.astype(np.float64) - b
    return 10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12))


def assert_matches_jax(got, ref, frames, masks, keep_unmasked=True):
    """uint8-identical to the JAX output (and the input, keeping it) where
    the feathered alpha is 0, PSNR above 45 dB where it is not; without
    keep_unmasked, PSNR above 45 dB on both sides."""
    got, ref = np.stack(got), np.stack(ref)
    assert got.shape == ref.shape == frames.shape and got.dtype == np.uint8
    outside = _outside(masks)
    assert outside.any() and (~outside).any()
    if keep_unmasked:
        np.testing.assert_array_equal(got[outside], ref[outside])
        np.testing.assert_array_equal(got[outside], frames[outside])
    else:
        psnr = _psnr(got[outside], ref[outside])
        assert psnr > 45.0, f"PSNR outside the mask {psnr:.2f} dB"
    psnr = _psnr(got[~outside], ref[~outside])
    assert psnr > 45.0, f"PSNR inside the mask {psnr:.2f} dB"
    # the model really changed the masked pixels
    assert np.abs(got[~outside].astype(int) - frames[~outside]).max() > 8


def check_pipeline_matches_jax(shared, computed_prior=False,
                               forward_args=None, call=None, **flags):
    params, noise, frames, masks, prior = shared
    if computed_prior:
        prior = None
    ref = _run_jax(params, frames, masks, prior, forward_args, call, **flags)
    got = _run_port(params, noise, frames, masks, prior, forward_args, call,
                    **flags)
    assert_matches_jax(got, ref, frames, masks,
                       (call or {}).get("keep_unmasked_original", True))


def test_pipeline_matches_jax(shared):
    """brushnet_feature_reuse and spatial_attn_reuse at their default (on);
    tests/test_torch_infill_exact.py runs both off."""
    check_pipeline_matches_jax(shared)


def test_pipeline_with_computed_prior_matches_jax(shared):
    """propainer_frames=None: each package computes the ProPainter prior
    from the dilated masks (two chunks of 6 frames) and goes on into
    DiffuEraser."""
    check_pipeline_matches_jax(shared, computed_prior=True)


def test_guidance_prompt_and_full_frame_paths_match_jax(shared_one_level):
    """The paths the other tests leave out: classifier-free guidance at
    2.0, a prompt embedding in place of the null one, both together (into
    DiffuEraser.forward, which run_infill_on_frames calls with neither),
    and keep_unmasked_original=False (the whole decoded frame comes
    back)."""
    prompt = (np.random.default_rng(21).standard_normal((77, 64)) * 0.1) \
        .astype(np.float32)
    for forward_args in ({"guidance_scale": 2.0}, {"prompt_embeds": prompt},
                         {"guidance_scale": 2.0, "prompt_embeds": prompt}):
        check_pipeline_matches_jax(shared_one_level,
                                   forward_args=forward_args, **ONE_LEVEL)
    check_pipeline_matches_jax(shared_one_level,
                               call={"keep_unmasked_original": False},
                               **ONE_LEVEL)


def test_latent_carry_matches_single_pass_and_jax(shared_one_level):
    """A 14-frame clip in one call (windows [0, 6), [4, 10), [8, 14)) and
    in two: frames [0, 10) withholding a latent tail of 2 (8 frames out,
    two windows) and frames [8, 14) at frame_offset=8 from the carry (one
    window), so each call's windows are the single pass's and the JAX
    package's first call emits 8 frames. The carried accumulation gives
    the single pass's blended latents bitwise, the chunked frames are
    within 1 of the single pass's, and the chunked run matches the JAX
    package's (its carry within 1e-5 of max|JAX|)."""
    params = shared_one_level[0]
    T = 14
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (T, H // 8, W // 8, 3), np.uint8)
    frames = np.repeat(np.repeat(base, 8, 1), 8, 2)
    masks = np.zeros((T, H, W), np.uint8)
    masks[:, 16:32, 24:48] = 255
    prior = np.repeat(np.repeat(
        rng.integers(0, 255, (T, H // 16, W // 16, 3), np.uint8), 16, 1),
        16, 2)
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key, i), (H // 8, W // 8, 4), jnp.float32))(
        jnp.arange(T)))
    first = dict(return_latent_tail=2)
    calls = []
    single = _run_port(params, noise, frames, masks, prior,
                       latent_hook=calls.append, **ONE_LEVEL)
    single_last = calls[-1]  # the last decode batch: frames 6..13, final
    calls.clear()
    out0, carry = _run_port(params, noise, frames[:10], masks[:10],
                            prior[:10], call=first, latent_hook=calls.append,
                            **ONE_LEVEL)
    last0 = calls[-1]  # frames 0..7, final
    calls.clear()
    second = dict(frame_offset=8, latent_carry=carry)
    out1 = _run_port(params, noise, frames[8:], masks[8:], prior[8:],
                     call=second, latent_hook=calls.append, **ONE_LEVEL)
    assert [c.shape[0] for c in calls] == [6] and single_last.shape[0] == 8
    assert len(out0) == 8 and len(out1) == 6
    assert torch.equal(torch.cat([last0[6:], calls[0]]), single_last)
    chunked = np.stack(out0 + out1)
    assert np.abs(chunked.astype(int) - np.stack(single)).max() <= 1

    ref0, ref_carry = _run_jax(params, frames[:10], masks[:10], prior[:10],
                               call=first, **ONE_LEVEL)
    ref1 = _run_jax(params, frames[8:], masks[8:], prior[8:],
                    call=dict(second, latent_carry=ref_carry), **ONE_LEVEL)
    for got, want in zip(carry, ref_carry):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert_matches_jax(out0 + out1, ref0 + ref1, frames, masks)


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
