"""The port's plain ops (GroupNorm, resizes, dilation, feathered alpha,
composite) against the JAX package's, f32 on the CPU, seeded inputs."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.ops.composite import feathered_composite as j_composite
from videovanish_tpu.ops.edt import feather_alpha as j_feather
from videovanish_tpu.ops.groupnorm import group_norm as j_gn
from videovanish_tpu.ops.groupnorm import group_norm_silu as j_gn_silu
from videovanish_tpu.ops.morphology import binarize_and_dilate as j_dilate
from videovanish_tpu_torch.ops import resize as pr
from videovanish_tpu_torch.ops.composite import feathered_composite
from videovanish_tpu_torch.ops.edt import feather_alpha
from videovanish_tpu_torch.ops.groupnorm import group_norm, group_norm_silu
from videovanish_tpu_torch.ops.morphology import (
    binarize_and_dilate, binary_dilation,
)

jr = importlib.import_module("videovanish_tpu.ops.resize")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm(silu):
    x = _rng(0).standard_normal((2, 5, 7, 64)).astype(np.float32) * 3 + 1
    w = _rng(1).standard_normal(64).astype(np.float32)
    b = _rng(2).standard_normal(64).astype(np.float32)
    ref = np.asarray((j_gn_silu if silu else j_gn)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-6))
    got = (group_norm_silu if silu else group_norm)(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
        torch.from_numpy(b), 32, 1e-6).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((37, 53), (20, 32)), ((20, 32), (37, 53))])
def test_resizes_match_jax(src, dst):
    img = _rng(3).random((2,) + src + (3,)).astype(np.float32) * 255
    np.testing.assert_allclose(
        pr.resize_bilinear(torch.from_numpy(img), *dst).numpy(),
        np.asarray(jr.resize_bilinear(jnp.asarray(img), *dst)), atol=1e-3)
    m = (_rng(4).random((2,) + src) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        pr.resize_nearest_2d(torch.from_numpy(m), *dst).numpy(),
        np.asarray(jr.resize_nearest_2d(jnp.asarray(m), *dst)))


@pytest.mark.parametrize("iters", [0, 1, 8])
def test_dilation_matches_scipy_and_jax(iters):
    m = np.zeros((3, 40, 50, 3), np.uint8)
    m[0, 10:14, 20:30, 1] = 7
    m[1, 0, 0, 2] = 255
    m[2, 39, 25:49, 0] = 1
    got = binarize_and_dilate(torch.from_numpy(m), iters).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_dilate(jnp.asarray(m),
                                                           iters)))
    for i in range(3):
        ref = scipy.ndimage.binary_dilation(m[i].any(-1), iterations=iters) \
            if iters else m[i].any(-1)
        np.testing.assert_array_equal(got[i] > 0, ref)
    assert binary_dilation(torch.from_numpy(m[..., 0]), iters).dtype \
        == torch.bool


@pytest.mark.parametrize("feather", [0.0, 3.0, 5.0])
def test_feather_alpha(feather):
    m = np.zeros((2, 48, 64), bool)
    m[0, 10:30, 12:40] = True
    m[1, 0:5, 50:64] = True
    np.testing.assert_allclose(
        feather_alpha(torch.from_numpy(m), feather).numpy(),
        np.asarray(j_feather(jnp.asarray(m), feather)), atol=1e-6)


@pytest.mark.parametrize("keep", [True, False])
def test_composite_with_rescale(keep):
    inp = _rng(5).integers(0, 256, (2, 24, 32, 3), np.uint8)
    orig = _rng(6).integers(0, 256, (2, 48, 64, 3), np.uint8)
    mask = np.zeros((2, 48, 64), np.uint8)
    mask[:, 10:30, 12:40] = 255
    ref = np.asarray(j_composite(jnp.asarray(inp), jnp.asarray(orig),
                                 jnp.asarray(mask), 3.0,
                                 keep_unmasked_original=keep))
    got = feathered_composite(torch.from_numpy(inp), torch.from_numpy(orig),
                              torch.from_numpy(mask), 3.0,
                              keep_unmasked_original=keep).numpy()
    assert np.abs(got.astype(int) - ref).max() <= 1
    assert (got != ref).mean() < 1e-3
