"""The port's SAM2 modules against the JAX package's, f32 on the CPU at the
tiny config: the same seeded inputs, and weights made by the port
(seeded, then perturbed so that no parameter keeps a trivial value) and
carried to the JAX side by the JAX package's own converter
(`sam2_fb_preprocess`, SAM2_RULES, SAM2_SPECIALS). Both sides are
channel-last.

Tolerance: max|port - JAX| <= 1e-4 * max|JAX| per module; the resize and
the colour conversion back to RGB 1e-6 of max|JAX|; the host I420
conversion bitwise against cv2, and the converter's round trip bitwise.
"""
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.config import tiny_config as j_tiny
from videovanish_tpu.core.convert import (
    SAM2_RULES, SAM2_SPECIALS, convert_state_dict, sam2_fb_preprocess,
)
from videovanish_tpu.models.sam2 import decoder as jdec
from videovanish_tpu.models.sam2 import hiera as jhiera
from videovanish_tpu.models.sam2 import memory as jmem
from videovanish_tpu.models.sam2 import neck as jneck
from videovanish_tpu.models.sam2 import prompt as jprompt
from videovanish_tpu.ops import colorspace as jcolor
from videovanish_tpu.ops import resize as jresize
from videovanish_tpu.ops import rope as jrope
from videovanish_tpu_torch.config import tiny_config
from videovanish_tpu_torch.convert import (
    jax_params_to_state_dict, published_state_dict,
)
from videovanish_tpu_torch.models.sam2 import decoder as pdec
from videovanish_tpu_torch.models.sam2 import hiera as phiera
from videovanish_tpu_torch.models.sam2.neck import sine_pos_embed_2d
from videovanish_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
from videovanish_tpu_torch.ops import colorspace as pcolor
from videovanish_tpu_torch.ops import resize as presize
from videovanish_tpu_torch.ops import rope as prope

CFG = tiny_config().sam2
JCFG = j_tiny().sam2
REL = 1e-4


@functools.lru_cache(maxsize=None)
def weights(seed: int = 0):
    """(port state dict of numpy arrays, JAX parameter tree): the port's
    seeded weights plus 0.05 of standard normal noise on every entry, and
    the object-score head's bias lowered by 0.3, so that in the predictor
    tests the objects are absent on about a third of the frames
    (NO_OBJ_SCORE, the no-object pointer and the occlusion embedding run;
    the scores stay more than 7e-4 from 0)."""
    pred = Sam2VideoPredictor(CFG, device="cpu", seed=seed)
    rng = np.random.default_rng(seed + 100)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in pred.model.state_dict().items()}
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"] -= 0.3
    tree = convert_state_dict(sam2_fb_preprocess(sd), SAM2_RULES,
                              SAM2_SPECIALS)
    return sd, tree


@functools.lru_cache(maxsize=None)
def port_model(seed: int = 0):
    return Sam2VideoPredictor(CFG, params=weights(seed)[0],
                              device="cpu").model


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jit_apply(module):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------
def test_sam2_converter_round_trip_is_bitwise():
    sd, tree = weights()
    back = jax_params_to_state_dict(tree, "sam2")
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert np.array_equal(back[k].numpy(), v), k


def test_published_file_loads_without_its_unused_keys(tmp_path):
    """A published-layout file (the port's keys plus the mask-prompt and
    no_mem_pos_enc entries the port has no module for) loads with
    load_state_dict; any other unknown key is refused."""
    from videovanish_tpu_torch.models.sam2.predictor import (
        build_sam2_video_predictor,
    )
    sd = {k: torch.from_numpy(v) for k, v in weights()[0].items()}
    extra = {"sam_prompt_encoder.mask_downscaling.0.weight":
             torch.zeros(4, 1, 2, 2),
             "mask_downsample.weight": torch.zeros(1, 1, 4, 4),
             "no_mem_pos_enc": torch.zeros(1, 1, 64)}
    assert published_state_dict({**sd, **extra}, "sam2").keys() == sd.keys()
    path = tmp_path / "sam2.pt"
    torch.save({"model": {**sd, **extra}}, path)
    pred = build_sam2_video_predictor(ckpt_path=str(path), device="cpu",
                                      config=CFG)
    got = pred.model.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(RuntimeError):
        Sam2VideoPredictor(CFG, params={**sd, "stray.weight": torch.zeros(1)},
                           device="cpu")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side,head_dim", [(8, 16), (4, 64)])
def test_rope_matches_jax(side, head_dim):
    sin, cos = prope.axial_rope_tables(side, side, head_dim)
    jsin, jcos = jrope.axial_rope_tables(side, side, head_dim)
    assert np.array_equal(sin, jsin) and np.array_equal(cos, jcos)
    x = np.random.default_rng(1).standard_normal(
        (2, 1, side * side, head_dim)).astype(np.float32)
    _close(prope.apply_rope(_t(x), _t(sin), _t(cos)),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(jsin),
                            jnp.asarray(jcos)), 1e-6)


@pytest.mark.parametrize("src,dst", [((7, 7), (32, 32)), ((7, 7), (64, 48)),
                                     ((8, 5), (6, 11))])
def test_resize_bicubic_matches_jax(src, dst):
    x = np.random.default_rng(2).standard_normal((1, *src, 5)).astype(
        np.float32)
    _close(presize.resize_bicubic_torch(_t(x), *dst),
           jresize.resize_bicubic_torch(jnp.asarray(x), *dst), 1e-6)


@pytest.mark.parametrize("H,W", [(2, 2), (4, 6), (96, 128), (72, 130)])
def test_rgb_to_yuv420_host_equals_cv2(H, W):
    frames = np.random.default_rng(H * W).integers(
        0, 256, (3, H, W, 3), dtype=np.uint8)
    frames[0, :2, :2] = [[0, 0, 0], [255, 255, 255]]
    got = pcolor.rgb_to_yuv420_host(frames)
    want = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in frames])
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_yuv420_to_rgb01_matches_jax():
    frames = np.random.default_rng(5).integers(0, 256, (2, 96, 128, 3),
                                               dtype=np.uint8)
    yuv = pcolor.rgb_to_yuv420_host(frames)
    _close(pcolor.yuv420_to_rgb01(torch.from_numpy(yuv)),
           jcolor.yuv420_to_rgb01(jnp.asarray(yuv)), 1e-6)


def test_window_partition_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 10, 14, 3)).astype(
        np.float32)
    w, pad = phiera.window_partition(_t(x), 4)
    jw, jpad = jhiera.window_partition(jnp.asarray(x), 4)
    assert pad == jpad
    _close(w, jw, 0)
    _close(phiera.window_unpartition(w, 4, pad, (10, 14)), x, 0)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
def _jhiera(cfg):
    return jhiera.Hiera(
        embed_dim=cfg.hiera_embed_dim, num_heads=cfg.hiera_num_heads,
        stages=cfg.hiera_stages, window_spec=cfg.hiera_window_spec,
        global_att_blocks=cfg.hiera_global_att_blocks,
        pos_embed_bkg_size=cfg.hiera_window_pos_embed_bkg_spatial_size)


# the tiny config (one windowed block per stage between q-pool and global
# blocks) and a deeper one with runs of consecutive windowed blocks that
# stay in the partitioned layout, and a window change inside stage 3
HIERA_CFGS = {
    "tiny": dict(),
    "runs": dict(hiera_stages=(2, 3, 3, 1), hiera_window_spec=(4, 2, 4, 2),
                 hiera_global_att_blocks=(6,)),
}


@pytest.mark.parametrize("name", sorted(HIERA_CFGS))
def test_hiera_matches_jax(name):
    import dataclasses
    cfg = dataclasses.replace(CFG, **HIERA_CFGS[name])
    jcfg = dataclasses.replace(JCFG, **HIERA_CFGS[name])
    port = Sam2VideoPredictor(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(7)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in port.model.state_dict().items()}
    port.model.load_state_dict({k: _t(v) for k, v in sd.items()})
    tree = convert_state_dict(sam2_fb_preprocess(sd), SAM2_RULES,
                              SAM2_SPECIALS)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    got = port.model.image_encoder.trunk(_t(x))
    want = _jit_apply(_jhiera(jcfg))(tree["hiera"], jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)


def test_hiera_grid_that_does_not_tile_raises():
    """96x96 input: the 6x6 stage-3 grid does not divide into 4x4 windows;
    both packages refuse it."""
    x = np.zeros((1, 96, 96, 3), np.float32)
    with pytest.raises(ValueError):
        port_model().image_encoder.trunk(_t(x))
    with pytest.raises(ValueError):
        _jit_apply(_jhiera(JCFG))(weights()[1]["hiera"], jnp.asarray(x))


def test_neck_matches_jax():
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, 32 // s, 32 // s, c)).astype(np.float32)
          for s, c in zip((1, 2, 4, 8), (32, 64, 128, 256))]
    neck = port_model().image_encoder.neck
    got = neck([_t(x) for x in xs])
    jf, jp = _jit_apply(jneck.FpnNeck(d_model=CFG.neck_d_model))(
        weights()[1]["neck"], [jnp.asarray(x) for x in xs])
    for g, w in zip(got, jf):
        _close(g, w)
    for g, w in zip(got, jp):
        _close(sine_pos_embed_2d(g.shape[1], g.shape[2], CFG.neck_d_model),
               w, 0)


def test_prompt_encoder_matches_jax():
    """Clicks of both labels, a box, and padded slots; the dense PE."""
    rng = np.random.default_rng(9)
    P = jprompt.MAX_POINTS
    pts = (rng.random((3, P, 2)) * CFG.image_size).astype(np.float32)
    labels = np.full((3, P), -1, np.int32)
    labels[0, :2] = [1, 0]
    labels[1, :2] = [2, 3]
    labels[2, :4] = [1, 1, 2, 3]
    enc = port_model().sam_prompt_encoder
    sparse, no_mask = enc(_t(pts), torch.from_numpy(labels).long())
    jpe = jprompt.PromptEncoder(embed_dim=CFG.neck_d_model,
                                image_size=CFG.image_size)
    params = weights()[1]["prompt_encoder"]
    js, jn = _jit_apply(jpe)(params, jnp.asarray(pts), jnp.asarray(labels))
    _close(sparse, js)
    _close(no_mask, jn, 0)
    _close(enc.dense_pe(8, 8), jax.jit(
        lambda p: jpe.apply({"params": p}, 8, 8, method=jpe.dense_pe))(params))


def test_mask_decoder_matches_jax():
    """Masks, IoU, object score and every token's pointer, with padded
    prompt slots masked out of the attention."""
    rng = np.random.default_rng(10)
    B, C, s = 2, CFG.neck_d_model, 8
    img = rng.standard_normal((B, s, s, C)).astype(np.float32)
    pe = rng.standard_normal((B, s, s, C)).astype(np.float32)
    sparse = rng.standard_normal((B, jprompt.MAX_POINTS, C)).astype(
        np.float32)
    s4 = rng.standard_normal((B, 4 * s, 4 * s, C)).astype(np.float32)
    s8 = rng.standard_normal((B, 2 * s, 2 * s, C)).astype(np.float32)
    valid = np.zeros((B, jprompt.MAX_POINTS), bool)
    valid[0, :2] = True
    valid[1, :5] = True
    m = port_model()
    got = m.sam_mask_decoder(_t(img), _t(pe), _t(sparse), _t(s4), _t(s8),
                             torch.from_numpy(valid), m.obj_ptr_proj)
    jd = jdec.MaskDecoder(embed_dim=C,
                          num_multimask_outputs=CFG.num_multimask_outputs,
                          iou_head_depth=CFG.iou_head_depth)
    want = _jit_apply(jd)(weights()[1]["decoder"], jnp.asarray(img),
                          jnp.asarray(pe), jnp.asarray(sparse),
                          jnp.asarray(s4), jnp.asarray(s8),
                          jnp.asarray(valid))
    for key in ("masks", "iou", "obj_ptrs", "obj_score"):
        _close(got[key], want[key])


def test_transposed_conv_is_the_jax_package_s():
    """The decoder's 2x2 transposed convs give what flax's ConvTranspose
    gives on the JAX converter's kernel: torch's ConvTranspose2d with the
    checkpoint kernel flipped in both spatial axes."""
    import flax.linen as nn

    from videovanish_tpu.core.convert import t_conv_transpose
    rng = np.random.default_rng(13)
    w = rng.standard_normal((6, 4, 2, 2)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    conv = pdec.ConvTranspose2x2(6, 4)
    conv.load_state_dict({"weight": _t(w), "bias": _t(b)})
    want = nn.ConvTranspose(4, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": t_conv_transpose(w), "bias": b}},
        jnp.asarray(x))
    _close(conv(_t(x)), want, 1e-6)
    flipped = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), _t(w).flip(2, 3), _t(b), stride=2)
    _close(flipped.permute(0, 2, 3, 1), want, 1e-6)


def test_memory_attention_matches_jax():
    """Spatial slots and pointer tokens, some slots invalid, and one object
    whose bank holds no valid key at all (uniform softmax, finite)."""
    rng = np.random.default_rng(11)
    B, d, m = 3, CFG.memory_attention_d_model, CFG.mem_dim
    S = 64  # an 8x8 grid
    M = 3 * S + 8
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    x_pos = rng.standard_normal((1, S, d)).astype(np.float32)
    kv = rng.standard_normal((B, M, m)).astype(np.float32)
    pos = rng.standard_normal((B, M, m)).astype(np.float32)
    valid = rng.random((B, M)) > 0.3
    valid[1, :S] = False
    valid[2] = False
    got = port_model().memory_attention(_t(x), _t(x_pos), _t(kv), _t(pos),
                                        torch.from_numpy(valid))
    jma = jmem.MemoryAttention(num_layers=CFG.memory_attention_layers,
                               d_model=d, kv_dim=m)
    want = _jit_apply(jma)(weights()[1]["memory_attention"], jnp.asarray(x),
                           jnp.asarray(x_pos), jnp.asarray(kv),
                           jnp.asarray(pos), jnp.asarray(valid))
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_memory_encoder_matches_jax():
    rng = np.random.default_rng(12)
    B, d = 2, CFG.neck_d_model
    feat = rng.standard_normal((B, 8, 8, d)).astype(np.float32)
    mask = (rng.standard_normal((B, 128, 128, 1)) * 10).astype(np.float32)
    got = port_model().memory_encoder(_t(feat), _t(mask))
    want = _jit_apply(jmem.MemoryEncoder(d_model=d, mem_dim=CFG.mem_dim))(
        weights()[1]["memory_encoder"], jnp.asarray(feat), jnp.asarray(mask))
    _close(got, want)
