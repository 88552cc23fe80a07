"""The port's CLIs (videovanish_tpu_torch/cli) and what they stand on,
against the JAX package: the parsers' flags, PSNR / SSIM and the compare
CLI, the VV_LOG=json stage lines, the files the diffuerase and sam2_masker
CLIs write under VV_PLATFORM=cpu, and their refusal to run on the CPU
unasked."""
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_end2end_propainter import PCFG
from test_torch_infill import GEOMETRY, ONE_LEVEL, _scene
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.cli import compare as jcompare
from videovanish_tpu.cli import diffuerase as jdiffuerase
from videovanish_tpu.cli import sam2_masker as jsam2_masker
from videovanish_tpu.utils import quality as jquality
from videovanish_tpu_torch.cli import compare as pcompare
from videovanish_tpu_torch.cli import diffuerase as pdiffuerase
from videovanish_tpu_torch.cli import sam2_masker as psam2_masker
from videovanish_tpu_torch.config import (
    DiffuEraserConfig, InfillConfig, ProPainterConfig, VVConfig, tiny_config,
    tiny_wan_config,
)
from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
from videovanish_tpu_torch.pipeline import infill as pinfill
from videovanish_tpu_torch.pipeline import masker as pmasker
from videovanish_tpu_torch.utils import observability as pobs
from videovanish_tpu_torch.utils import quality as pquality
from videovanish_tpu_torch.video import io as pio

ROOT = Path(__file__).resolve().parents[1]
CLIS = [(pdiffuerase, jdiffuerase), (psam2_masker, jsam2_masker),
        (pcompare, jcompare)]
DENOISE_STAGES = {"mask_dilate", "diffueraser_denoise", "rescale_composite",
                  "dn.upload_encode", "dn.windows", "dn.decode_fetch"}


def _actions(parser):
    return [(a.dest, a.default, a.required, a.choices, a.type, a.nargs,
             tuple(a.option_strings)) for a in parser._actions]


def test_parsers_match_jax():
    """Flag for flag the JAX CLIs', and the port's diffuerase adds --model
    (its remover), last, defaulting to the JAX package's one."""
    for port, ref in CLIS:
        got = _actions(port.build_parser())
        if port is pdiffuerase:
            assert got[-1] == ("model", "diffueraser", False,
                               ["diffueraser", "vace"], None, None,
                               ("--model",))
            got = got[:-1]
        assert got == _actions(ref.build_parser())
        assert port.build_parser().description == \
            ref.build_parser().description


def test_clis_refuse_without_cuda(tmp_path):
    """With no card and no VV_PLATFORM=cpu, each CLI raises before it
    reads a frame (here in a process that sees no CUDA device)."""
    env = {k: v for k, v in os.environ.items() if k != "VV_PLATFORM"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    (tmp_path / "v.mkv").write_bytes(b"")
    script = (
        "import sys\n"
        "from videovanish_tpu_torch.cli import compare, diffuerase, "
        "sam2_masker\n"
        "for main, argv in [\n"
        "    (diffuerase.main, ['--color_video', 'v.mkv', '--mask_video', "
        "'v.mkv']),\n"
        "    (sam2_masker.main, ['--color_video', 'v.mkv', '--annotations', "
        "'a.json']),\n"
        "    (compare.main, ['--a', 'v.mkv', '--b', 'v.mkv'])]:\n"
        "    try:\n"
        "        main(argv)\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "        print('refused')\n"
    )
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["refused"] * 3


def test_quality_and_compare_match_jax(tmp_path, monkeypatch, capsys):
    """psnr, ssim (2-D and 3-D) and video_metrics within 1e-6 relative of
    the JAX package's numpy, and the compare CLI's line and exit code
    equal to the JAX CLI's (an identical frame included, so the video PSNR
    stays finite)."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (6, 40, 56, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-12, 13, a.shape), 0,
                255).astype(np.uint8)
    b[3] = a[3]

    def close(got, want):
        assert got == pytest.approx(want, rel=1e-6, abs=0)

    close(pquality.psnr(a, b), jquality.psnr(a, b))
    assert pquality.psnr(a[3], b[3]) == jquality.psnr(a[3], b[3]) == np.inf
    close(pquality.ssim(a[0], b[0]), jquality.ssim(a[0], b[0]))
    close(pquality.ssim(a[1, ..., 2], b[1, ..., 2]),
          jquality.ssim(a[1, ..., 2], b[1, ..., 2]))
    got = pquality.video_metrics([torch.from_numpy(f) for f in a], list(b),
                                 batch=4)
    want = jquality.video_metrics(list(a), list(b))
    assert set(got) == set(want) and got["frames"] == want["frames"] == 6
    for k in ("psnr", "psnr_min", "ssim", "ssim_min"):
        close(got[k], want[k])
    with pytest.raises(ValueError):
        pquality.ssim(a[0, :8], b[0, :8])

    pa, pb = str(tmp_path / "a.mkv"), str(tmp_path / "b.mkv")
    pio.write_video_frames_to_path(pa, list(a), 24.0, 40, 56)
    pio.write_video_frames_to_path(pb, list(b[:5]), 24.0, 40, 56)
    monkeypatch.setenv("VV_PLATFORM", "cpu")
    for limit in (None, 30.0, 99.0):
        argv = ["--a", pa, "--b", pb] + (
            [] if limit is None else ["--min_psnr", str(limit)])
        rc_port = pcompare.main(argv)
        line_port = json.loads(capsys.readouterr().out.splitlines()[-1])
        rc_jax = jcompare.main(argv)
        line_jax = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rc_port == rc_jax == (1 if limit == 99.0 else 0)
        assert set(line_port) == set(line_jax)
        for k, v in line_jax.items():
            if isinstance(v, float):
                close(line_port[k], v)
            else:
                assert line_port[k] == v


@pytest.fixture
def stage_lines(monkeypatch):
    """The port's log lines under VV_LOG=json, captured."""
    monkeypatch.setenv("VV_LOG", "json")
    pobs._LOGGER = None
    lines = []
    lg = pobs.get_logger()
    capture = logging.Handler()
    capture.emit = lambda r: r.name == lg.name and lines.append(
        r.getMessage())  # not the checkpoint module's warnings
    lg.addHandler(capture)
    yield lines
    for h in list(lg.handlers):
        lg.removeHandler(h)
    pobs._LOGGER = None


def test_cli_files_and_stage_log(tmp_path, monkeypatch, stage_lines):
    """Under VV_PLATFORM=cpu: the diffuerase CLI with --chunked off and a
    prior video writes `<input>_vanished.mkv` holding what
    run_infill_on_frames gives for the same frames; the sam2_masker CLI
    writes `<input>_sam2_mask.mkv` holding what run_sam2_on_frames gives.
    The VV_LOG=json lines are the JAX package's: {"event": "stage",
    "name", "seconds", ...fields}, with DiffuEraser's stage names; under
    VV_PROFILE_DIR a call leaves one torch.profiler trace with its stages
    named. With --model vace the file holds what the "vace" route gives
    (its stages logged, each sampler step's record with its counters);
    --chunked on and a prior video are refused there."""
    monkeypatch.setenv("VV_PLATFORM", "cpu")
    params, noise, frames, masks, prior = _scene(**ONE_LEVEL)
    masks3 = np.repeat(masks[..., None], 3, -1)
    H, W = frames.shape[1:3]
    paths = {}
    for name, x in (("color", frames), ("mask", masks3), ("prior", prior)):
        paths[name] = str(tmp_path / f"{name}.mkv")
        pio.write_video_frames_to_path(paths[name], list(x), 24.0, H, W)

    dcfg = DiffuEraserConfig(**{**GEOMETRY, **ONE_LEVEL})
    pinfill.set_config(VVConfig(diffueraser=dcfg,
                                propainter=ProPainterConfig(**PCFG)))
    try:
        pinfill.video_inpainting_sd = DiffuEraser(
            config=dcfg, params=params, device="cpu",
            noise=lambda idx, shape: torch.from_numpy(noise[list(idx)]))
        pinfill.last_ckpt = "2-Step"
        pdiffuerase.main(["--color_video", paths["color"], "--mask_video",
                          paths["mask"], "--prior_video", paths["prior"],
                          "--chunked", "off", "--max_img_size", str(H)])
        monkeypatch.setenv("VV_PROFILE_DIR", str(tmp_path / "profile"))
        want = pinfill.run_infill_on_frames(
            list(frames), list(masks3), propainer_frames=list(prior),
            max_img_size=H, device="cpu")
        monkeypatch.delenv("VV_PROFILE_DIR")
    finally:
        pinfill.set_config(VVConfig())
    traces = list((tmp_path / "profile").glob("trace_*.json"))
    assert len(traces) == 1
    assert "diffueraser_denoise" in traces[0].read_text()
    got, fps = pio.load_video_frames_from_path(paths["color"]
                                               + "_vanished.mkv")
    assert fps == 24.0
    np.testing.assert_array_equal(np.stack(got), np.stack(want))

    lines = [json.loads(line) for line in stage_lines]
    assert {r["event"] for r in lines} == {"stage", "profile_start",
                                           "profile_stop"}
    records = [r for r in lines if r["event"] == "stage"]
    assert records and all(r["seconds"] >= 0 for r in records)
    assert DENOISE_STAGES <= {r["name"] for r in records}
    assert {k for r in records if r["name"] == "dn.windows" for k in r} == \
        {"event", "name", "seconds", "windows", "synced"}

    ann = {"keyframes": [{"frame_idx": 1,
                          "pos_clicks": [{"x": 0.5, "y": 0.4, "obj": 1}],
                          "rects": [{"x": 2, "y": 3, "w": 20, "h": 30,
                                     "obj": 2}]}]}
    with open(tmp_path / "ann.json", "w") as f:
        json.dump(ann, f)
    pinfill.set_config(tiny_config())
    try:
        psam2_masker.main(["--color_video", paths["color"], "--annotations",
                           str(tmp_path / "ann.json"), "--max_frames", "4"])
        want = pmasker.run_sam2_on_frames(list(frames[:4]), ann, device="cpu")
    finally:
        pmasker.reset_predictor()
        pinfill.set_config(VVConfig())
    got, _ = pio.load_video_frames_from_path(paths["color"]
                                             + "_sam2_mask.mkv")
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert {"sam2.wire_prep", "sam2.encode_dispatch", "sam2.step_dispatch",
            "sam2.fetch"} <= {json.loads(line).get("name")
                              for line in stage_lines}

    stage_lines.clear()
    out = str(tmp_path / "vace.mkv")
    wcfg = tiny_wan_config()
    pinfill.set_config(VVConfig(wan=wcfg))
    try:
        pdiffuerase.main(["--color_video", paths["color"], "--mask_video",
                          paths["mask"], "--model", "vace", "--out", out,
                          "--max_img_size", str(H)])
        want = pinfill.run_infill_on_frames(list(frames), list(masks3),
                                            max_img_size=H, device="cpu")
        with pytest.raises(SystemExit, match="one pass"):
            pdiffuerase.main(["--color_video", paths["color"],
                              "--mask_video", paths["mask"], "--model",
                              "vace", "--chunked", "on"])
        with pytest.raises(ValueError, match="no prior"):
            pdiffuerase.main(["--color_video", paths["color"],
                              "--mask_video", paths["mask"], "--model",
                              "vace", "--prior_video", paths["prior"]])
    finally:
        pinfill.set_config(VVConfig())
    assert pinfill._get_config().infill == InfillConfig()
    got, _ = pio.load_video_frames_from_path(out)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    records = [json.loads(line) for line in stage_lines]
    assert {"mask_dilate", "wan_denoise", "wan.vae_encode", "wan.step",
            "wan.vae_decode", "rescale_composite"} <= \
        {r["name"] for r in records}
    steps = [r for r in records if r["name"] == "wan.step"]
    assert len(steps) == 2 * wcfg.sample_steps
    assert {(r["ctx_len"], r["branches"], r["vace_blocks"])
            for r in steps} == {(wcfg.text_len, 2, len(wcfg.vace_layers))}
