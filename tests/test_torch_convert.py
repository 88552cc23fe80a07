"""Weights between the JAX package and the port.

- JAX parameter trees -> the port's state dicts (videovanish_tpu_torch.
  convert) invert the JAX package's own converter (core/convert.
  convert_state_dict with VAE_RULES / UNET_RULES / UNET_SPECIALS) exactly;
- DiffuEraser takes JAX trees and port state dicts alike;
- the port's UNet, BrushNet and VAE, built at production width on the meta
  device, have exactly the key inventory and shapes of the published
  checkpoints (tests/fixtures/manifests). The published VAE file carries
  the pre-0.18 diffusers attention names (query/key/value/proj_attn): the
  port's AutoencoderKL renames them in a load_state_dict hook
  (convert.rename_legacy_vae_keys), so the manifest is compared after that
  renaming and a legacy-named state dict loads as it is.
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.core.convert import (
    UNET_RULES, UNET_SPECIALS, VAE_RULES, convert_state_dict,
)
from videovanish_tpu_torch.config import tiny_config
from videovanish_tpu_torch.convert import (
    jax_params_to_state_dict, rename_legacy_vae_keys,
)
from videovanish_tpu_torch.models.diffueraser.blocks import init_random_
from videovanish_tpu_torch.models.diffueraser.brushnet import BrushNetModel
from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition
from videovanish_tpu_torch.models.diffueraser.vae import AutoencoderKL

MANIFESTS = os.path.join(os.path.dirname(__file__), "fixtures", "manifests")
TINY = tiny_config().diffueraser
RULES = {"vae": (VAE_RULES, ()), "unet": (UNET_RULES, UNET_SPECIALS),
         "brushnet": (UNET_RULES, UNET_SPECIALS)}


def _tiny(name):
    c = TINY
    torch.manual_seed(0)
    m = {"vae": lambda: AutoencoderKL(c.vae_block_out_channels, 2, 4),
         "unet": lambda: UNetCondition(4, 4, c.block_out_channels,
                                       c.layers_per_block, 8,
                                       c.cross_attention_dim),
         "brushnet": lambda: BrushNetModel(9, c.block_out_channels,
                                           c.layers_per_block, 8,
                                           c.cross_attention_dim)}[name]()
    return init_random_(m, torch.Generator().manual_seed(1))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.mark.parametrize("name", ["vae", "unet", "brushnet"])
def test_round_trip_through_core_convert(name):
    sd = {k: v.numpy() for k, v in _tiny(name).state_dict().items()}
    tree = convert_state_dict(sd, *RULES[name])
    back = jax_params_to_state_dict(tree, name)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # and the other way: port state dict -> JAX tree -> the same tree
    again = convert_state_dict({k: v.numpy() for k, v in back.items()},
                               *RULES[name])
    a, b = dict(_leaves(tree)), dict(_leaves(again))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_diffueraser_takes_jax_trees_and_state_dicts():
    mods = {n: _tiny(n) for n in ("vae", "unet", "brushnet")}
    sds = {n: m.state_dict() for n, m in mods.items()}
    null = np.random.default_rng(0).standard_normal((77, 64)).astype(np.float32)
    trees = {n: convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                   *RULES[n]) for n, sd in sds.items()}
    a = DiffuEraser(config=TINY, params={**trees, "null_text_emb": null},
                    device="cpu")
    b = DiffuEraser(config=TINY, params={**sds, "null_text_emb": null},
                    device="cpu")
    for n in sds:
        for (ka, va), (kb, vb) in zip(getattr(a, n).state_dict().items(),
                                      getattr(b, n).state_dict().items()):
            assert ka == kb
            assert torch.equal(va, vb), ka
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(a._encode(x), b._encode(x))
    assert torch.equal(a.null_text_emb, b.null_text_emb)


@pytest.mark.parametrize("name,manifest", [
    ("unet", "diffueraser_unet_main.json"),
    ("brushnet", "brushnet.json"),
    ("vae", "sd_vae_ft_mse.json"),
])
def test_manifest_inventory(name, manifest):
    with open(os.path.join(MANIFESTS, manifest)) as f:
        want = json.load(f)
    if name == "vae":
        want = rename_legacy_vae_keys(want)
    with torch.device("meta"):
        m = {"unet": UNetCondition, "brushnet": BrushNetModel,
             "vae": AutoencoderKL}[name]()
    got = {k: list(v.shape) for k, v in m.state_dict().items()}
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert [k for k in want if got[k] != want[k]] == []
    # the checkpoint loads as published (legacy VAE names included)
    with open(os.path.join(MANIFESTS, manifest)) as f:
        published = {k: torch.empty(s, device="meta")
                     for k, s in json.load(f).items()}
    m.load_state_dict(published, assign=True)


def test_legacy_vae_names_load():
    src = _tiny("vae")
    legacy = {}
    for k, v in src.state_dict().items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
            k = k.replace(new, old) if "mid_block.attentions" in k else k
        legacy[k] = v
    assert any(".proj_attn." in k for k in legacy)
    dst = AutoencoderKL(TINY.vae_block_out_channels, 2, 4)
    dst.load_state_dict(legacy)
    for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
        assert torch.equal(a, b), k
