"""Published weight files into the port, against the JAX package, on the
CPU.

Every model is written at a small size as a file in its published layout,
from seeded port weights: the VAE with sd-vae-ft-mse's legacy attention
names (.safetensors, f32), the UNet in f16 (.safetensors), BrushNet as
.bin, CLIP's text tower with its position-id buffer (.safetensors), a PCM
style LoRA in peft names, RAFT with DataParallel's `module.` prefix and its
batch-norm counters (.pth), flow completion with the training-only edge
head, the InpaintGenerator, and SAM2's fb `{"model": ...}` .pt with the
mask-prompt keys the port drops.

- `test_files_cli_and_fallback`: the .safetensors reader against the
  safetensors package (F32, F16, BF16, I64, I32, an empty `__metadata__`,
  data off its alignment), `maybe_load`'s three cases (an absent path is
  None and one log line, a present one loads, a corrupt one raises), the
  entry points keeping seeded weights only for absent paths and raising on
  corrupt or mismatched files, and the convert CLI's round trip: each
  piece converted (the LoRA merged into the UNet), then `--assemble
  diffueraser`, then `get_model` on the assembled file.
- `test_published_files_match_jax`: each file loaded by the port equals the
  JAX package's `convert_torch_file` carried back by
  `jax_params_to_state_dict`, bitwise; `parse_lora_state` + `merge_lora`
  against the JAX pair on the peft, old diffusers, kohya-with-alpha and raw
  peft layouts, with 2-D factors onto a 1x1 conv and conv factors onto a
  3x3 conv; a LoRA entry that matches no weight raises in both.
"""
import dataclasses
import json
import logging
import struct

import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from test_torch_text_encoder import seeded_clip_state
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.core.convert import (
    FLOWCOMP_RULES, PROPAINTER_RULES, RAFT_RULES, SAM2_RULES, SAM2_SPECIALS,
    UNET_RULES, UNET_SPECIALS, VAE_RULES, convert_torch_file,
    sam2_fb_preprocess,
)
from videovanish_tpu.core.convert import merge_lora as j_merge_lora
from videovanish_tpu.core.convert import parse_lora_state as j_parse_lora
from videovanish_tpu.models.diffueraser.text_encoder import (
    CLIP_RULES, CLIP_SPECIAL,
)
from videovanish_tpu_torch import checkpoint
from videovanish_tpu_torch.cli import convert as cli
from videovanish_tpu_torch.config import (
    DiffuEraserConfig, VVConfig, tiny_config,
)
from videovanish_tpu_torch.convert import (
    jax_params_to_state_dict, merge_lora, parse_lora_state,
    published_state_dict,
)
from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
from videovanish_tpu_torch.models.diffueraser.text_encoder import (
    CLIPTextModel, derive_null_text_emb,
)
from videovanish_tpu_torch.models.propainter.model import (
    Propainter, load_checkpoints,
)
from videovanish_tpu_torch.models.sam2.predictor import (
    Sam2VideoPredictor, build_sam2_video_predictor,
)
from videovanish_tpu_torch.pipeline import infill as pinfill
from videovanish_tpu_torch.pipeline import masker as pmasker

GEOMETRY = dict(block_out_channels=(32, 64), layers_per_block=1,
                cross_attention_dim=64, attention_head_dim=8,
                vae_block_out_channels=(16, 16, 16, 16))
PCFG = tiny_config().propainter
SCFG = tiny_config().sam2
# as wide as the UNet's cross-attention, so one head of CLIP's 64
CLIP_DIMS = dict(vocab_size=300, max_positions=77, width=64, layers=2,
                 num_heads=1)
RANK = 4
# LoRA targets: linears, the 64-wide text cross-attention, the 1x1 proj_in
# conv with 2-D factors, and the 3x3 conv_in with conv factors
LORA_TARGETS = (
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
    "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k",
    "up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0",
    "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj",
    "mid_block.attentions.0.proj_in",
    "conv_in",
)
_LEGACY = ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
           (".to_out.0.", ".proj_attn."))


def _state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def lora_factors(unet_state: dict, seed: int = 7) -> dict:
    """{target: (down, up, alpha)} in torch layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(LORA_TARGETS):
        w = unet_state[name + ".weight"]
        conv = name == "conv_in"
        down = rng.uniform(-1, 1, (RANK,) + tuple(w.shape[1:]) if conv
                           else (RANK, int(np.prod(w.shape[1:]))))
        up = rng.uniform(-0.1, 0.1, (w.shape[0], RANK) + ((1, 1) if conv
                                                           else ()))
        out[name] = (torch.from_numpy(down.astype(np.float32)),
                     torch.from_numpy(up.astype(np.float32)), 2.0 + i)
    return out


def lora_layout(factors: dict, layout: str) -> dict:
    """The factors under one public LoRA layout's key names."""
    out = {}
    for name, (down, up, alpha) in factors.items():
        if layout == "peft":
            out[f"unet.{name}.lora_A.weight"] = down
            out[f"unet.{name}.lora_B.weight"] = up
        elif layout == "diffusers_old":
            out[f"unet.{name}.lora.down.weight"] = down
            out[f"unet.{name}.lora.up.weight"] = up
        elif layout == "kohya":
            flat = "lora_unet_" + name.replace(".", "_")
            out[f"{flat}.lora_down.weight"] = down
            out[f"{flat}.lora_up.weight"] = up
            out[f"{flat}.alpha"] = torch.tensor(alpha)
        else:  # a raw peft save of the UNet
            out[f"base_model.model.{name}.lora_A.default.weight"] = down
            out[f"base_model.model.{name}.lora_B.default.weight"] = up
    return out


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """{model: (path, the state written)} of seeded port weights in the
    published layouts, plus "lora"."""
    d = tmp_path_factory.mktemp("published")
    de = DiffuEraser(config=DiffuEraserConfig(**GEOMETRY), device="cpu",
                     seed=1)
    pp = Propainter(config=PCFG, device="cpu", seed=2)
    sam = Sam2VideoPredictor(SCFG, device="cpu", seed=3)
    vae = {}
    for k, v in _state(de.vae).items():
        for new, old in _LEGACY:
            if "mid_block.attentions" in k:
                k = k.replace(new, old)
        vae[k] = v
    unet = {k: v.half() for k, v in _state(de.unet).items()}
    files = {
        "vae": ("vae.safetensors", vae),
        "unet": ("unet.safetensors", unet),
        "brushnet": ("brushnet.bin", _state(de.brushnet)),
        "clip": ("clip.safetensors", seeded_clip_state(dims=CLIP_DIMS)),
        "lora": ("lora.safetensors",
                 lora_layout(lora_factors(_state(de.unet)), "peft")),
        "raft": ("raft-things.pth", {"module." + k: v for k, v in
                                     _state(pp.raft).items()}),
        "flow_completion": ("recurrent_flow_completion.pth", {
            **_state(pp.flow_comp),
            "edgeDetector.out_layer.weight": torch.ones(1, 2, 3, 3),
            "edgeDetector.out_layer.bias": torch.zeros(1)}),
        "propainter": ("ProPainter.pth", _state(pp.generator)),
        "sam2": ("sam2.1_hiera_large.pt", {
            **_state(sam.model),
            "sam_prompt_encoder.mask_downscaling.0.weight":
                torch.ones(4, 1, 2, 2),
            "no_mem_pos_enc": torch.zeros(1, 1, SCFG.mem_dim)}),
    }
    out = {}
    for model, (name, state) in files.items():
        path = str(d / name)
        if name.endswith(".safetensors"):
            save_file({k: v.contiguous() for k, v in state.items()}, path)
        else:
            torch.save({"model": state} if model == "sam2" else state, path)
        out[model] = (path, state)
    return out


def _write_unaligned(path, tensors: dict) -> None:
    """A .safetensors file whose data starts 3 bytes past 8-byte
    alignment (the format does not require padding)."""
    header, blobs, off = {"__metadata__": {}}, [], 0
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32"}
    for k, t in tensors.items():
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * ((3 - 8 - len(head)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _assert_states_equal(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), label
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), \
            f"{label}: {k}"


def test_files_cli_and_fallback(published, tmp_path, caplog):
    # -- the .safetensors reader against the safetensors package
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i64": torch.arange(-5, 6, dtype=torch.int64).reshape(1, 11),
        "i32": torch.arange(9, dtype=torch.int32),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={})
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        assert b'"__metadata__":{}' in f.read(n)
    for p in (path, str(tmp_path / "u.safetensors")):
        if p != path:
            _write_unaligned(p, tensors)
        got = checkpoint.load_torch_state(p)
        _assert_states_equal(got, load_file(p), p)
        _assert_states_equal(got, tensors, p)
    # the aligned file's tensors are views of the mapping, not copies
    assert checkpoint.load_torch_state(path)["f32"].untyped_storage() \
        .nbytes() == (tmp_path / "t.safetensors").stat().st_size

    # -- maybe_load: absent, present, corrupt
    absent = str(tmp_path / "absent.pt")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert checkpoint.maybe_load(absent) is None
    assert [r.getMessage() for r in caplog.records] == [
        f"no checkpoint at {absent!r}: seeded random weights"]
    _assert_states_equal(checkpoint.maybe_load(published["clip"][0]),
                         published["clip"][1], "clip")
    corrupt = {}
    with open(published["vae"][0], "rb") as f:
        head = f.read()
    for name, data in (("cut.safetensors", head[:len(head) // 2]),
                       ("header.safetensors", struct.pack("<Q", 1 << 40)
                        + head[8:]),
                       ("garbage.pt", b"\x80not a torch file" * 8)):
        corrupt[name] = str(tmp_path / name)
        with open(corrupt[name], "wb") as f:
            f.write(data)
        with pytest.raises(Exception):
            checkpoint.maybe_load(corrupt[name])

    # -- the convert CLI: each piece, then --assemble on the CPU
    out = {}
    for model in ("vae", "unet", "brushnet", "clip"):
        out[model] = str(tmp_path / f"{model}.pt")
        argv = ["--input", published[model][0], "--model", model,
                "--output", out[model]]
        cli.main(argv + (["--lora", published["lora"][0]]
                         if model == "unet" else []))
    cli.main(["--input", published["raft"][0], "--model", "raft",
              "--output", "unused.pt", "--dry_run"])
    assembled = str(tmp_path / "diffueraser.pt")
    cli.main(["--assemble", "diffueraser", "--vae", out["vae"], "--unet",
              out["unet"], "--brushnet", out["brushnet"], "--clip",
              out["clip"], "--output", assembled, "--device", "cpu"])
    tree = checkpoint.load_torch_state(assembled)
    assert sorted(tree) == ["brushnet", "null_text_emb", "unet", "vae"]
    merged = merge_lora(published["unet"][1],
                        parse_lora_state(published["lora"][1]))
    assert all(merged[k].dtype == torch.float16 for k in merged)
    _assert_states_equal(tree["unet"], merged, "unet")
    _assert_states_equal(tree["vae"], published_state_dict(
        published["vae"][1], "vae"), "vae")
    _assert_states_equal(tree["brushnet"], published["brushnet"][1],
                         "brushnet")
    assert torch.equal(tree["null_text_emb"], derive_null_text_emb(
        published["clip"][1], device="cpu"))

    # -- the entry points: the assembled file, the VAE alone, absent paths
    # (seeded weights and a log line each), corrupt and mismatched files
    def diffueraser(**paths):
        pinfill.set_config(VVConfig(diffueraser=DiffuEraserConfig(
            **GEOMETRY, **paths), propainter=PCFG, sam2=SCFG))
        try:
            return pinfill.get_model("2-Step", device="cpu")
        finally:
            pinfill.set_config(VVConfig())

    model = diffueraser(checkpoint=assembled, vae_checkpoint=absent)
    for name in ("vae", "unet", "brushnet"):
        got = getattr(model, name).state_dict()
        for k, v in tree[name].items():
            assert torch.equal(got[k], v.float()), f"{name}: {k}"
    assert torch.equal(model.null_text_emb, tree["null_text_emb"])
    model = diffueraser(checkpoint=absent,
                        vae_checkpoint=published["vae"][0])
    _assert_states_equal(model.vae.state_dict(), published_state_dict(
        published["vae"][1], "vae"), "vae alone")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        model = diffueraser(checkpoint=absent, vae_checkpoint=absent)
    assert len(caplog.records) == 2
    seeded = DiffuEraser(config=DiffuEraserConfig(**GEOMETRY), device="cpu")
    _assert_states_equal(model.unet.state_dict(), seeded.unet.state_dict(),
                         "seeded unet")
    assert torch.equal(model.null_text_emb, seeded.null_text_emb)
    bad_tree = dict(tree, unet={k: v for k, v in tree["unet"].items()
                                if k != "conv_in.weight"})
    torch.save(bad_tree, tmp_path / "mismatched.pt")
    for bad in (*corrupt.values(), str(tmp_path / "mismatched.pt"),
                published["brushnet"][0]):
        with pytest.raises(Exception):
            diffueraser(checkpoint=bad, vae_checkpoint=absent)
    torch.save({"module.fnet.conv1.weight": torch.zeros(1)},
               tmp_path / "raft_mismatched.pth")
    for bad in (corrupt["garbage.pt"], str(tmp_path / "raft_mismatched.pth")):
        pinfill.set_config(VVConfig(propainter=dataclasses.replace(
            PCFG, raft_checkpoint=bad)))
        try:
            with pytest.raises(Exception):
                pinfill.get_propainter(device="cpu")
        finally:
            pinfill.set_config(VVConfig())
    pinfill.set_config(VVConfig(sam2=dataclasses.replace(
        SCFG, checkpoint=corrupt["garbage.pt"])))
    try:
        with pytest.raises(Exception):
            pmasker._get_predictor("cpu")
    finally:
        pmasker.reset_predictor()
        pinfill.set_config(VVConfig())


def _jax_back(path, rules, model, special=(), preprocess=None) -> dict:
    tree = convert_torch_file(path, rules, special=special,
                              preprocess=preprocess)
    return jax_params_to_state_dict(tree, model)


def test_published_files_match_jax(published):
    # -- DiffuEraser's pieces through the CLI's converter, CLIP's tower
    de = DiffuEraser(config=DiffuEraserConfig(**GEOMETRY), device="cpu",
                     params={m: cli.convert_file(published[m][0], m)[0]
                             for m in ("vae", "unet", "brushnet")})
    for model, rules, special in (("vae", VAE_RULES, ()),
                                  ("unet", UNET_RULES, UNET_SPECIALS),
                                  ("brushnet", UNET_RULES, UNET_SPECIALS)):
        _assert_states_equal(getattr(de, model).state_dict(), _jax_back(
            published[model][0], rules, model, special), model)
    clip = CLIPTextModel(**CLIP_DIMS)
    clip.load_state_dict(cli.convert_file(published["clip"][0], "clip")[0])
    _assert_states_equal(clip.state_dict(), _jax_back(
        published["clip"][0], CLIP_RULES, "clip", CLIP_SPECIAL), "clip")

    # -- ProPainter's three files and SAM2's as the config names them
    cfg = dataclasses.replace(
        PCFG, raft_checkpoint=published["raft"][0],
        flowcomp_checkpoint=published["flow_completion"][0],
        checkpoint=published["propainter"][0])
    pp = Propainter(config=cfg, device="cpu", params=load_checkpoints(cfg))
    for name, model, rules in (("raft", "raft", RAFT_RULES),
                               ("flow_comp", "flow_completion",
                                FLOWCOMP_RULES),
                               ("generator", "propainter", PROPAINTER_RULES)):
        got = {k: v for k, v in getattr(pp, name).state_dict().items()
               if not k.endswith("num_batches_tracked")}
        _assert_states_equal(got, _jax_back(published[model][0], rules,
                                            name), model)
    sam = build_sam2_video_predictor(ckpt_path=published["sam2"][0],
                                     config=SCFG, device="cpu")
    _assert_states_equal(sam.model.state_dict(), _jax_back(
        published["sam2"][0], SAM2_RULES, "sam2", SAM2_SPECIALS,
        sam2_fb_preprocess), "sam2")

    # -- the LoRA parse and merge on every layout, f32 base weights
    base = {k: v.float() for k, v in published["unet"][1].items()}
    base_np = {k: v.numpy() for k, v in base.items()}
    factors = lora_factors(base)
    for layout in ("peft", "diffusers_old", "kohya", "raw_peft"):
        state = lora_layout(factors, layout)
        lora = parse_lora_state(state)
        j_lora = j_parse_lora({k: v.numpy() for k, v in state.items()})
        assert sorted(lora) == sorted(j_lora), layout
        assert parse_lora_state(state, "text_encoder") == {} == \
            j_parse_lora({k: v.numpy() for k, v in state.items()},
                         "text_encoder")
        got = merge_lora(base, lora, scale=0.7)
        want = j_merge_lora(base_np, j_lora, scale=0.7)
        assert sorted(got) == sorted(want)
        changed = 0
        for k, w in want.items():
            g = got[k].numpy()
            if np.array_equal(w, base_np[k]):
                assert np.array_equal(g, w), f"{layout}: {k}"
                continue
            changed += 1
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{layout}: {k}")
        assert changed == len(LORA_TARGETS), layout
    # a miss raises, as in JAX's strict mode
    stray = lora_layout({"down_blocks.9.nothing": factors["conv_in"]},
                        "peft")
    state = {**lora_layout(factors, "peft"), **stray}
    with pytest.raises(ValueError, match="matched no base weight"):
        merge_lora(base, parse_lora_state(state))
    with pytest.raises(ValueError, match="matched no base weight"):
        j_merge_lora(base_np, j_parse_lora(
            {k: v.numpy() for k, v in state.items()}))
    with pytest.raises(ValueError, match="missing its up factor"):
        parse_lora_state({"unet.conv_in.lora_A.weight": torch.zeros(4, 4)})
