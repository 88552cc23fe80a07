"""The port's ProPainter modules against the JAX package's, f32 on the CPU at
small size: the same seeded inputs, and weights made by the port and
carried to the JAX side by the JAX package's own converter
(`convert_state_dict` with RAFT_RULES / FLOWCOMP_RULES / PROPAINTER_RULES).
Layouts are transposed at the boundary (JAX NHWC, port NCHW).

Tolerance: max|port - JAX| <= 1e-4 * max|JAX| per module; the resizes and
bilinear warps 1e-6 (XLA on the CPU contracts the corner sum into fused
multiply-adds, so the last bit may differ). Nearest warps, whose
half-to-even rounding is discontinuous, are held bitwise, also at
coordinates exactly on .5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.core.convert import (
    FLOWCOMP_RULES, PROPAINTER_RULES, RAFT_RULES, convert_state_dict,
)
from videovanish_tpu.models.propainter import deform as jdeform
from videovanish_tpu.models.propainter import inpaint_generator as jgen
from videovanish_tpu.models.propainter import raft as jraft
from videovanish_tpu.models.propainter.flow_completion import (
    RecurrentFlowCompleteNet as JFlowComp,
)
from videovanish_tpu.models.propainter.propagation import (
    image_propagation as j_image_propagation,
)
from videovanish_tpu.ops import flow as jflow
from videovanish_tpu.ops import resize as jresize
from videovanish_tpu_torch.config import tiny_config
from videovanish_tpu_torch.convert import jax_params_to_state_dict
from videovanish_tpu_torch.models.propainter import deform as pdeform
from videovanish_tpu_torch.models.propainter import inpaint_generator as pgen
from videovanish_tpu_torch.models.propainter import raft as praft
from videovanish_tpu_torch.models.propainter.model import Propainter
from videovanish_tpu_torch.models.propainter.propagation import (
    image_propagation,
)
from videovanish_tpu_torch.ops import flow as pflow
from videovanish_tpu_torch.ops import resize as presize

CFG = tiny_config().propainter
RULES = {"raft": RAFT_RULES, "flow_comp": FLOWCOMP_RULES,
         "generator": PROPAINTER_RULES}
REL = 1e-4


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def port():
    """A tiny-config Propainter with seeded weights and random batch-norm
    running statistics (so that the frozen norm's use of them shows), and
    its weights carried to JAX parameter trees."""
    pp = Propainter(config=CFG, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    for m in pp.raft.modules():
        if isinstance(m, praft.FrozenBatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3, generator=gen)
            m.running_var.uniform_(0.6, 1.4, generator=gen)
            m.weight.uniform_(0.7, 1.3, generator=gen)
            m.bias.uniform_(-0.2, 0.2, generator=gen)
    params = {name: convert_state_dict(_sd(getattr(pp, name)), RULES[name])
              for name in RULES}
    return pp, params


def _nhwc(t):
    return np.ascontiguousarray(np.asarray(t).transpose(0, 2, 3, 1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    limit = rel * max(np.abs(want).max(), 1e-6)
    assert err <= limit, f"max|port - jax| = {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("name", list(RULES))
def test_state_dict_round_trip(port, name):
    """Port state dict -> JAX tree (the JAX package's rules) -> the port's
    inverse gives back every tensor bitwise, and a Propainter built from
    the JAX trees holds the same weights (num_batches_tracked, which the
    JAX rules drop, loads as 0)."""
    pp, params = port
    sd = getattr(pp, name).state_dict()
    back = jax_params_to_state_dict(params[name], name)
    kept = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == kept
    for k in kept:
        assert back[k].shape == sd[k].shape, k
        assert torch.equal(back[k], sd[k].float()), k
    loaded = getattr(Propainter(config=CFG, device="cpu", params=params),
                     name).state_dict()
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k


@pytest.mark.parametrize("kind", ["align_corners", "half_pixel"])
def test_resize_matches_jax(kind):
    x = _randn(0, 3, 9, 14, 2, scale=4.0)
    if kind == "align_corners":
        want = jresize.resize_bilinear_align_corners(jnp.asarray(x), 18, 28)
        got = presize.resize_bilinear_align_corners(_nchw(x), 18, 28)
    else:
        want = jresize.resize_bilinear_torch_half_pixel(jnp.asarray(x), 3, 4)
        got = presize.resize_bilinear_torch_half_pixel(_nchw(x), 3, 4)
    assert_close(_nhwc(got), want, rel=1e-6)


def _half_flows(B, H, W, seed):
    """Flows whose sample coordinates fall exactly on .5 (both rounding
    directions of half-to-even), plus some far outside the image."""
    rng = np.random.default_rng(seed)
    fl = rng.integers(-4, 5, (B, H, W, 2)).astype(np.float32) + 0.5
    fl[:, ::3] += rng.integers(-30, 30, (B, (H + 2) // 3, W, 2))
    return fl


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "prop_warp"])
def test_flow_warps_match_jax(mode):
    B, H, W = 2, 11, 13
    img = _randn(1, B, H, W, 3)
    fl = _half_flows(B, H, W, 2) if mode == "nearest" \
        else _randn(3, B, H, W, 2, scale=4.0)
    if mode == "prop_warp":
        mask = (np.random.default_rng(4).random((B, H, W, 1)) > 0.5) \
            .astype(np.float32)
        chk = _randn(5, B, H, W, 2, scale=3.0)
        want = jflow.fused_prop_warp(*(jnp.asarray(a) for a in
                                       (img, mask, chk, fl)), "nearest")
        got = pflow.prop_warp(*(_nchw(a) for a in (img, mask, chk)),
                              _nchw(fl), "nearest")
        np.testing.assert_array_equal(_nhwc(got[0]), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            assert_close(_nhwc(g), w, rel=1e-6)
        return
    want = jflow.flow_warp_mode(jnp.asarray(img), jnp.asarray(fl), mode)
    got = pflow.flow_warp_mode(_nchw(img), _nchw(fl), mode)
    if mode == "nearest":
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    else:
        assert_close(_nhwc(got), want, rel=1e-6)


def test_corr_pyramid_and_lookup():
    """Level-major, x-offset-major channels, zero padding far outside."""
    b, c, h, w = 2, 32, 12, 16
    f1, f2 = _randn(6, b, h, w, c), _randn(7, b, h, w, c)
    coords = _randn(8, b, h, w, 2, scale=6.0)
    coords[..., 0] += np.arange(w)[None, None, :]
    coords[..., 1] += np.arange(h)[None, :, None]
    vols_j, want = jax.jit(lambda a, b, c: (
        lambda v: (v, jraft.corr_lookup(v, c, 4)))(
        jraft.corr_volume_pyramid(a, b, 4)))(
        *(jnp.asarray(a) for a in (f1, f2, coords)))
    vols_p = praft.corr_volume_pyramid(_nchw(f1), _nchw(f2), 4)
    for vj, vp in zip(vols_j, vols_p):
        assert_close(vp, vj)
    got = praft.corr_lookup(vols_p, _nchw(coords), 4)
    assert_close(_nhwc(got), want)


def test_upsample_flow_convex():
    flow, mask = _randn(9, 2, 6, 8, 2), _randn(10, 2, 6, 8, 576)
    want = jraft.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask))
    got = praft.upsample_flow_convex(_nchw(flow), _nchw(mask))
    assert_close(_nhwc(got), want)


def test_raft_matches_jax(port):
    """Both encoders (instance norm, frozen batch norm with random running
    statistics), the correlation pyramid and 2 update iterations."""
    pp, params = port
    img1 = np.random.default_rng(11).random((2, 64, 64, 3)) \
        .astype(np.float32) * 2 - 1
    img2 = np.roll(img1, 3, axis=2) * 0.9 + 0.1 * _randn(12, 2, 64, 64, 3)
    m = jraft.RAFT(iters=CFG.raft_iters)
    want = jax.jit(m.apply)({"params": params["raft"]}, jnp.asarray(img1),
                            jnp.asarray(img2))
    with torch.no_grad():
        got = pp.raft(_nchw(img1), _nchw(img2))
    assert_close(_nhwc(got), want)


@pytest.mark.parametrize("scale", [2.0, 20.0])
def test_modulated_deform_conv2d(scale):
    """Offsets of a few pixels, and far outside the image (zero corners)."""
    B, H, W, Cin, Cout, G = 2, 10, 12, 32, 16, 4
    x = _randn(13, B, H, W, Cin)
    off = _randn(14, B, H, W, G, 9, 2, scale=scale)
    mask = np.random.default_rng(15).random((B, H, W, G, 9)) \
        .astype(np.float32)
    kernel = _randn(16, 3, 3, Cin, Cout, scale=0.1)
    bias = _randn(17, Cout)
    want = jax.jit(jdeform.modulated_deform_conv2d)(
        *(jnp.asarray(a) for a in (x, off, mask, kernel, bias)))
    got = pdeform.modulated_deform_conv2d(
        _nchw(x), torch.from_numpy(off).permute(0, 3, 4, 5, 1, 2),
        torch.from_numpy(mask).permute(0, 3, 4, 1, 2),
        torch.from_numpy(kernel).permute(3, 2, 0, 1), torch.from_numpy(bias))
    assert_close(_nhwc(got), want)


def test_flow_completion_matches_jax(port):
    """RecurrentFlowCompleteNet.forward_bidirect_flow: the P3D encoder, the
    deformable propagation both ways, the decoder, and the pass-through of
    the input flow outside the holes."""
    pp, params = port
    T, H, W = 4, 32, 32
    ff, fb = _randn(18, T - 1, H, W, 2, scale=3.0), \
        _randn(19, T - 1, H, W, 2, scale=3.0)
    masks = np.zeros((T, H, W, 1), np.float32)
    masks[:, 8:20, 6:22] = 1.0
    m = JFlowComp(base=CFG.flowcomp_base)
    want = jax.jit(lambda p, a, b, c: m.apply(
        {"params": p}, a, b, c, method=m.forward_bidirect_flow))(
        params["flow_comp"], jnp.asarray(ff), jnp.asarray(fb),
        jnp.asarray(masks))
    with torch.no_grad():
        got = pp.flow_comp.forward_bidirect_flow(_nchw(ff), _nchw(fb),
                                                 _nchw(masks))
    for g, w in zip(got, want):
        assert_close(_nhwc(g), w)
    hole = masks[:-1, ..., 0] > 0
    np.testing.assert_array_equal(_nhwc(got[0])[~hole], ff[~hole])


def test_image_propagation_matches_jax_bitwise():
    """Fed identical flows, the nearest-mode propagation gives identical
    frames and updated masks: the consistency threshold and the 0.1
    binarisations see the same numbers on both sides."""
    T, H, W = 6, 24, 28
    rng = np.random.default_rng(20)
    frames = rng.random((T, H, W, 3)).astype(np.float32) * 2 - 1
    masks = np.zeros((T, H, W, 1), np.float32)
    for t in range(T):
        masks[t, 6:16, 4 + 3 * t:12 + 3 * t] = 1.0
    flow = np.zeros((T - 1, H, W, 2), np.float32)
    flow[..., 0] = 3.0
    ff = flow + _randn(21, T - 1, H, W, 2, scale=0.7)
    fb = -flow + _randn(22, T - 1, H, W, 2, scale=0.7)
    masked = frames * (1 - masks)
    want_f, want_m = j_image_propagation(
        *(jnp.asarray(a) for a in (masked, masks, ff, fb)), "nearest")
    got_f, got_m = image_propagation(
        *(_nchw(a) for a in (masked, masks, ff, fb)), "nearest")
    np.testing.assert_array_equal(_nhwc(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(_nhwc(got_f), np.asarray(want_f))
    # the propagation filled some of the holes and left others
    assert 0 < np.asarray(want_m).sum() < masks.sum()


def test_soft_split_comp(port):
    pp, params = port
    gp = params["generator"]
    T, H, W = 3, 24, 36
    x = _randn(23, T, H, W, CFG.channels)
    mid, want = jax.jit(lambda p, a: (lambda m: (m, jgen.SoftComp(
        CFG.channels).apply({"params": p["sc"]}, m, (H, W))))(
        jgen.SoftSplit(CFG.hidden).apply({"params": p["ss"]}, a)))(
        gp, jnp.asarray(x))
    with torch.no_grad():
        mid_p = pp.generator.ss(_nchw(x))
        got = pp.generator.sc(mid_p, (H, W))
    assert_close(mid_p, mid)
    assert_close(_nhwc(got), want)


def test_sparse_window_attention_padded(port):
    """(H, W) = (12, 20) is padded to whole (5, 9) windows; keys and values
    of frames 1 and 3 only."""
    pp, params = port
    blk = params["generator"]["transformers"]["transformer_1"]
    T, H, W = 4, 12, 20
    x = _randn(24, T, H, W, CFG.hidden)
    want = jax.jit(lambda p, a: jgen.SparseWindowAttention(
        CFG.hidden, CFG.num_heads).apply({"params": p}, a, (1, 3)))(
        blk["attention"], jnp.asarray(x))
    with torch.no_grad():
        got = pp.generator.transformers.transformer[1].attention(
            torch.from_numpy(x), range(1, T, 2))
    assert_close(got, want)


def test_fusion_feed_forward(port):
    pp, params = port
    blk = params["generator"]["transformers"]["transformer_0"]
    T, H, W = 2, 24, 30
    fh, fw = pgen.t2t_hw(H, W)
    x = _randn(25, T, fh, fw, CFG.hidden)
    want = jax.jit(lambda p, a: jgen.FusionFeedForward(
        CFG.hidden, 49 * CFG.ffn_channels).apply({"params": p}, a, (H, W)))(
        blk["mlp"], jnp.asarray(x))
    with torch.no_grad():
        got = pp.generator.transformers.transformer[0].mlp(
            torch.from_numpy(x), (H, W))
    assert_close(got, want)
