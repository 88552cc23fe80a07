"""Wan2.1-VACE in the port (`models/wan/`, the "vace" route of
`run_infill_on_frames`) against the plain f32 reference of
`oracles_wan.py`, at tiny widths on the CPU with shared seeded weights:
one DiT + VACE forward, a chunked VAE encode and decode, and the whole
request; and the published widths on the meta device with Wan's keys.
Module tolerances are the ROADMAP's 1e-4 of the reference's largest
magnitude (both sides f32; RoPE is f64 in the reference)."""
import dataclasses

import numpy as np
import pytest
import torch

import oracles_wan as ref
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.ops.composite import feathered_composite as j_composite
from videovanish_tpu.ops.edt import feather_alpha as j_feather_alpha
from videovanish_tpu.ops.morphology import binarize_and_dilate as j_dilate
from videovanish_tpu_torch.config import (
    InfillConfig, WanConfig, tiny_config, tiny_wan_config,
)
from videovanish_tpu_torch.models.wan.dit import WanDiT
from videovanish_tpu_torch.models.wan.model import WanVace, inference_size
from videovanish_tpu_torch.models.wan.vae import WanVAE
from videovanish_tpu_torch.pipeline import infill as pinfill

TOL = 1e-4


def _close(got, want, tol=TOL):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max())


@pytest.fixture(scope="module")
def wan():
    """The port's tiny remover (seeded weights) and the reference built
    from its state dicts."""
    cfg = tiny_wan_config()
    model = WanVace(cfg, seed=3, device="cpu")
    dit, vae = ref.build(dataclasses.asdict(cfg), {
        "dit": model.dit.state_dict(), "vae": model.vae.state_dict()})
    return cfg, model, dit, vae


def test_dit_vace_forward_matches_reference(wan):
    cfg, model, dit, _ = wan
    g = torch.Generator().manual_seed(0)
    x = torch.randn(cfg.in_dim, 3, 4, 6, generator=g)
    z = torch.randn(cfg.vace_in_dim, 3, 4, 6, generator=g)
    t = torch.tensor(941)
    ctx = [model.context[n] for n in ("context", "context_null")]
    with torch.no_grad():
        got = model.dit(x[None], t, z[None], model._text())
        for i, c in enumerate(ctx):
            _close(got[i], dit(x, t, z, c))
    assert got.shape == (2, cfg.out_dim, 3, 4, 6)


def test_vae_chunked_encode_decode_matches_reference(wan):
    _, model, _, vae = wan
    x = torch.rand(1, 3, 9, 32, 48, generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        z = model.vae.encode(x)
        z_ref = vae.encode(x)
        assert z.shape == (1, 16, 3, 4, 6)
        _close(z, z_ref)
        _close(model.vae.decode(z_ref), vae.decode(z_ref))


def _clip(T, H, W):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    masks = np.zeros((T, H, W, 3), np.uint8)
    for t in range(T):
        masks[t, 10:22, 8 + 3 * t:30 + 3 * t] = 255
    return frames, masks


def test_run_infill_vace_matches_reference(wan):
    """7 frames (padded to 9) of 40x72, inference at 32x64: outside the
    feathered mask the output is the input, byte for byte, on both sides;
    inside it the port is within 45 dB of the reference. What the route
    does not take raises."""
    cfg, model, dit, vae = wan
    frames, masks = _clip(7, 40, 72)
    vcfg = dataclasses.replace(
        tiny_config(), wan=cfg,
        infill=dataclasses.replace(InfillConfig(), model="vace"))
    pinfill.set_config(vcfg)
    try:
        pinfill.wan = model
        out = np.stack(pinfill.run_infill_on_frames(
            list(frames), list(masks), device="cpu"))
        for bad in (dict(propainer_frames=list(frames)),
                    dict(latent_carry=(np.zeros(1),)),
                    dict(return_latent_tail=2)):
            with pytest.raises(ValueError, match="vace"):
                pinfill.run_infill_on_frames(list(frames), list(masks),
                                             device="cpu", **bad)
    finally:
        pinfill.set_config(tiny_config())
    ic = vcfg.infill
    dilated = np.asarray(j_dilate(masks, ic.mask_dilation_iter))
    size = inference_size(40, 72, cfg, ic.max_img_size)
    assert size == (32, 64)
    with torch.no_grad():
        inpainted = ref.inpaint(
            dit, vae, torch.from_numpy(frames),
            torch.from_numpy(dilated.copy()),
            dataclasses.asdict(cfg), model.context["context"],
            model.context["context_null"], size)
    want = np.asarray(j_composite(inpainted.numpy(), frames, dilated,
                                  float(ic.feather_px)))
    inside = np.asarray(j_feather_alpha(dilated > 0,
                                        float(ic.feather_px))) > 0
    assert inside.any() and not inside.all()
    np.testing.assert_array_equal(out[~inside], frames[~inside])
    np.testing.assert_array_equal(want[~inside], frames[~inside])
    diff = out[inside].astype(np.float64) - want[inside]
    psnr = 10 * np.log10(255.0 ** 2 / max(np.mean(diff ** 2), 1e-12))
    assert psnr > 45.0, psnr


def test_published_widths_build_on_meta_with_wan_keys():
    """Wan2.1-VACE-1.3B's DiT and the Wan-VAE at the published widths hold
    exactly the reference's state-dict keys and shapes (Wan's own)."""
    cfg = WanConfig()
    with torch.device("meta"):
        port = {"dit": WanDiT(cfg).state_dict(),
                "vae": WanVAE(cfg).state_dict()}
        dit, vae = ref.build(dataclasses.asdict(cfg), device=None)
    for name, want in (("dit", dit.state_dict()), ("vae", vae.state_dict())):
        assert {k: tuple(v.shape) for k, v in port[name].items()} == \
            {k: tuple(v.shape) for k, v in want.items()}, name
    d = port["dit"]
    assert len([k for k in d if k.endswith("self_attn.q.weight")]) == 45
    for key, shape in {
            "patch_embedding.weight": (1536, 16, 1, 2, 2),
            "vace_patch_embedding.weight": (1536, 96, 1, 2, 2),
            "text_embedding.0.weight": (1536, 4096),
            "time_embedding.0.weight": (1536, 256),
            "time_projection.1.weight": (9216, 1536),
            "blocks.29.ffn.0.weight": (8960, 1536),
            "blocks.0.modulation": (1, 6, 1536),
            "blocks.0.norm3.weight": (1536,),
            "blocks.0.self_attn.norm_q.weight": (1536,),
            "vace_blocks.0.before_proj.weight": (1536, 1536),
            "vace_blocks.14.after_proj.weight": (1536, 1536),
            "head.head.weight": (64, 1536),
            "head.modulation": (1, 2, 1536)}.items():
        assert tuple(d[key].shape) == shape, key
    assert "vace_blocks.1.before_proj.weight" not in d
    v = port["vae"]
    for key, shape in {
            "encoder.conv1.weight": (96, 3, 3, 3, 3),
            "encoder.middle.1.to_qkv.weight": (1152, 384, 1, 1),
            "encoder.head.2.weight": (32, 384, 3, 3, 3),
            "conv1.weight": (32, 32, 1, 1, 1),
            "conv2.weight": (16, 16, 1, 1, 1),
            "decoder.upsamples.3.resample.1.weight": (192, 384, 3, 3),
            "decoder.upsamples.3.time_conv.weight": (768, 384, 3, 1, 1),
            "decoder.head.2.weight": (3, 96, 3, 3, 3)}.items():
        assert tuple(v[key].shape) == shape, key
