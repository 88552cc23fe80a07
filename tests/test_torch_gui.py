"""The port's interactive app (videovanish_tpu_torch/gui, cli/videovanish.py)
and utils/profiling against the JAX package's, on the CPU without PySide6:
the annotation model under one seeded edit sequence, the players' sync
policy on a grid, the CLI's fallback without Qt (and VV_DEBUG_NANS), the
four jobs at tiny_config against the pipelines they call, the profiling
arithmetic on the same rows, and `rows_from_profiler` on a CPU run."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.cli import videovanish as jvideovanish
from videovanish_tpu.gui import annotations as jann
from videovanish_tpu.gui import sync_logic as jsync
from videovanish_tpu.utils import profiling as jprof
from videovanish_tpu_torch import cli as pcli
from videovanish_tpu_torch.cli import videovanish as pvideovanish
from videovanish_tpu_torch.config import VVConfig, tiny_config
from videovanish_tpu_torch.gui import annotations as pann
from videovanish_tpu_torch.gui import jobs
from videovanish_tpu_torch.gui import sync_logic as psync
from videovanish_tpu_torch.pipeline import infill as pinfill
from videovanish_tpu_torch.pipeline import masker as pmasker
from videovanish_tpu_torch.utils import profiling as pprof
from videovanish_tpu_torch.utils.observability import (
    STAGE_RANGE, stage_timer,
)
from videovanish_tpu_torch.video import io as pio

ROOT = Path(__file__).resolve().parents[1]
HAS_PYSIDE = importlib.util.find_spec("PySide6") is not None


def _edit(stores, rng, step):
    """One seeded edit (a click, a rectangle, a deletion or a prune) on
    every store of `stores` alike; returns what each store's call gave."""
    frame = int(rng.integers(0, 6))
    kind = int(rng.integers(0, 5))
    x, y, w, h = (float(v) for v in rng.random(4).round(3))
    obj = int(rng.integers(1, 5))
    out = []
    for s in stores:
        if kind == 0:
            s.get_or_create(frame).pos_clicks.append((x, y, obj))
        elif kind == 1:
            s.get_or_create(frame).neg_clicks.append((x, y, obj))
        elif kind == 2:
            s.get_or_create(frame).rects.append((x, y, w, h, obj))
        elif kind == 3:
            kf = s.keyframes.get(frame)
            for lst in (() if kf is None else
                        (kf.pos_clicks, kf.neg_clicks, kf.rects)):
                if lst:
                    lst.pop(0)
                    break
        else:
            s.get_or_create(frame)
        out.append(s.prune_if_empty(frame) if step % 3 == 0 or kind == 4
                   else None)
    return out


def test_annotation_store_matches_jax():
    """Both packages' AnnotationStore through the same 200 seeded edits:
    equal prune_if_empty, max_obj_id, to_json_obj and annotations_dict at
    every frame (with and without the remap to frame 0) after each edit,
    and a JSON file of either loads into the other unchanged."""
    rng = np.random.default_rng(0)
    port, ref = pann.AnnotationStore(), jann.AnnotationStore()
    for step in range(200):
        got, want = _edit((port, ref), rng, step)
        assert got == want
        assert port.max_obj_id() == ref.max_obj_id()
        assert port.to_json_obj("v.mkv", 24.0) == ref.to_json_obj("v.mkv",
                                                                   24.0)
        for f in (None, *range(6)):
            for remap in (False, True):
                assert port.annotations_dict(f, remap) == \
                    ref.annotations_dict(f, remap)
    assert len(port.keyframes) > 1
    for a, b in ((port, jann.AnnotationStore()),
                 (ref, pann.AnnotationStore())):
        b.load_from_json_obj(json.loads(json.dumps(a.to_json_obj("v", 30.0))))
        assert b.to_json_obj("v", 30.0) == a.to_json_obj("v", 30.0)
        kf = a.keyframes[min(a.keyframes)]
        assert type(b).__module__ != type(a).__module__
        assert b.keyframes[kf.frame_idx].to_json_obj() == kf.to_json_obj()


def test_sync_logic_matches_jax():
    """Every function and constant of the port's sync_logic equals the JAX
    one on a grid."""
    public = sorted(n for n in vars(jsync) if not n.startswith("_")
                    and n != "annotations")
    assert public == sorted(n for n in vars(psync) if not n.startswith("_")
                            and n != "annotations")
    for name in ("RESYNC_INTERVAL_MS", "RESYNC_DRIFT_MS",
                 "VOLUME_SLIDER_DEFAULT"):
        assert getattr(psync, name) == getattr(jsync, name)
    for fps in (23.976, 24.0, 25.0, 29.97, 60.0):
        for v in np.linspace(-50.0, 5000.0, 97):
            assert psync.ms_to_frame(v, fps) == jsync.ms_to_frame(v, fps)
            assert psync.frame_count(v, fps) == jsync.frame_count(v, fps)
            f = int(v) // 7
            assert psync.frame_to_ms(f, fps) == jsync.frame_to_ms(f, fps)
    for ts in (None, -1, 0, 1, 41_708, 1_000_000):
        for pos in (0.0, 12.5, 999.0):
            assert psync.master_frame_ms(ts, pos) == \
                jsync.master_frame_ms(ts, pos)
    for master in (0.0, 1000.0):
        for d0 in (-36, -35, 0, 35, 36, 500):
            for d1 in (-100, 34, 35.5):
                for loaded in ((True, True), (True, False), (False, True)):
                    fol = [master + d0, master + d1]
                    for drift in (35, 10):
                        assert psync.followers_to_resync(
                            master, fol, loaded, drift) == \
                            jsync.followers_to_resync(master, fol, loaded,
                                                      drift)
    for start in (0, 10):
        for cur in range(-2, 40):
            assert psync.preview_frame_index(start, 22, cur) == \
                jsync.preview_frame_index(start, 22, cur)
    existing = [30, 10, 20, 5]
    for f in range(0, 45, 3):
        assert psync.chip_insert_pos(existing, f) == \
            jsync.chip_insert_pos(existing, f)
    for v in range(-10, 120, 5):
        assert psync.volume_from_slider(v) == jsync.volume_from_slider(v)


def test_videovanish_cli_without_pyside_and_debug_nans(monkeypatch):
    """The CLI has the JAX one's flags; without PySide6 it exits 2 with
    the "GUI unavailable" message naming the port's CLIs. VV_DEBUG_NANS=1
    (read by device_from_env, as every CLI calls it) stops a forward at
    the first module whose output is not finite, naming it."""
    a, b = pvideovanish.build_parser(), jvideovanish.build_parser()
    assert [(x.dest, x.default, x.option_strings) for x in a._actions] == \
        [(x.dest, x.default, x.option_strings) for x in b._actions]
    assert a.description == b.description
    if HAS_PYSIDE:
        pytest.skip("PySide6 present; the fallback does not apply")
    env = dict(os.environ, PYTHONPATH=str(ROOT), VV_PLATFORM="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "videovanish_tpu_torch.cli.videovanish",
         "--color_video", "x.mkv"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 2, r.stderr
    assert "GUI unavailable" in r.stderr
    assert "videovanish_tpu_torch.cli.diffuerase" in r.stderr
    assert "videovanish_tpu_torch.cli.sam2_masker" in r.stderr

    monkeypatch.setenv("VV_PLATFORM", "cpu")
    monkeypatch.setenv("VV_DEBUG_NANS", "1")
    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Sequential(
        torch.nn.Linear(4, 4), torch.nn.ReLU()))
    assert pcli._DEBUG_NANS_HOOKS is None
    try:
        assert pcli.device_from_env() == "cpu"
        assert pcli._DEBUG_NANS_HOOKS is not None
        assert torch.isfinite(net(torch.ones(2, 4))).all()
        with torch.no_grad():
            net[1][0].bias[2] = float("nan")
        with pytest.raises(FloatingPointError, match=r"Sequential\.1\.0 "
                                                     r"\(Linear\)"):
            net(torch.ones(2, 4))
    finally:
        for h in pcli._DEBUG_NANS_HOOKS or ():
            h.remove()
        pcli._DEBUG_NANS_HOOKS = None


def _on_thread(job, cancel_at=None):
    """Run job(report, is_canceled) on a thread, as the window's worker
    does; with cancel_at, the job is cancelled once a report reaches that
    percentage (at 0, before it starts)."""
    out, cancel = {}, threading.Event()
    if cancel_at == 0:
        cancel.set()

    def report(pct, status="", **_):
        if cancel_at is not None and pct >= cancel_at:
            cancel.set()

    def run():
        try:
            out["result"] = job(report, cancel.is_set)
        except BaseException as e:  # handed to the caller
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=600)
    assert not t.is_alive(), "the job did not finish"
    if "error" in out:
        raise out["error"]
    return out["result"]


def test_jobs_match_pipeline_calls(tmp_path):
    """The four jobs at tiny_config on "cpu", each on a thread, on a
    written color and mask file pair: Generate Mask's and Make Vanish's
    files, the mask preview and the infill preview (preview_img_size
    lowered to 48, so the cap shrinks the working size) equal the
    pipelines' direct calls; a cancelled job returns None and writes no
    file; a job asked for the card raises without one."""
    T, H, W = 10, 64, 64
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (T, H // 8, W // 8, 3), np.uint8)
    frames = np.repeat(np.repeat(base, 8, 1), 8, 2)
    masks = np.zeros((T, H, W, 3), np.uint8)
    for t in range(T):
        masks[t, 16:36, 8 + 3 * t:28 + 3 * t] = 255
    color, mask = str(tmp_path / "color.mkv"), str(tmp_path / "mask.mkv")
    pio.write_video_frames_to_path(color, list(frames), 24.0, H, W)
    pio.write_video_frames_to_path(mask, list(masks), 24.0, H, W)
    store = pann.AnnotationStore()
    store.get_or_create(0).pos_clicks.append((0.4, 0.4, 1))
    store.get_or_create(3).rects.append((0.1, 0.2, 0.5, 0.4, 2))
    store.get_or_create(3).neg_clicks.append((0.8, 0.8, 2))
    ann = store.annotations_dict()
    settings = dict(max_img_size=64, mask_dilation_iter=4,
                    keep_unmasked_original=True)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, diffueraser=dataclasses.replace(
        cfg.diffueraser, preview_img_size=48))
    pinfill.set_config(cfg)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jobs.preview_mask_job(color, 0, ann)(print, lambda: False)

        # cancelled: after SAM2 ran, and before the infill
        out_mask = color + "_sam2_mask.mkv"
        out_vanish = color + "_vanished.mkv"
        assert _on_thread(jobs.generate_mask_job(color, ann, device="cpu"),
                          cancel_at=45) is None
        assert _on_thread(jobs.make_vanish_job(color, mask, **settings,
                                               device="cpu"),
                          cancel_at=0) is None
        assert not os.path.exists(out_mask)
        assert not os.path.exists(out_vanish)

        got = _on_thread(jobs.generate_mask_job(color, ann, device="cpu"))
        assert got == out_mask
        want = pmasker.run_sam2_on_frames(list(frames), ann, device="cpu")
        np.testing.assert_array_equal(
            np.stack(pio.load_video_frames_from_path(got)[0]),
            np.stack(want))
        assert np.stack(want).any()

        one = store.annotations_dict(only_frame=3, remap_to_zero=True)
        got = _on_thread(jobs.preview_mask_job(color, 3, one, device="cpu"))
        want = pmasker.run_sam2_on_frames([frames[3]], one, device="cpu")
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], want[0])

        got = _on_thread(jobs.make_vanish_job(color, mask, **settings,
                                              device="cpu"))
        assert got == out_vanish
        want = pinfill.run_infill_on_frames(list(frames), list(masks),
                                            **settings, device="cpu")
        np.testing.assert_array_equal(
            np.stack(pio.load_video_frames_from_path(got)[0]),
            np.stack(want))

        got = _on_thread(jobs.preview_infill_job(color, mask, 2, **settings,
                                                 device="cpu"))
        assert len(got) == T - 2  # 22 asked for, 8 left in the file
        want = pinfill.run_infill_on_frames(
            list(frames[2:]), list(masks[2:]), **settings, preview=True,
            device="cpu")
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        full = pinfill.run_infill_on_frames(
            list(frames[2:]), list(masks[2:]), **settings, device="cpu")
        assert not np.array_equal(np.stack(got), np.stack(full))
    finally:
        pmasker.reset_predictor()
        pinfill.set_config(VVConfig())


# the rows of tests/test_observability.py and a few of each kind more
OBS_ROWS = [
    {"operation": "jit(stage1)/while/body/gather",
     "total_self_time": 1000.0, "measured_flop_rate": 100.0},
    {"operation": "jit(stage1)/RAFT/dot", "total_self_time": 1000.0,
     "measured_flop_rate": 1000.0},
    {"operation": "IDLE", "total_self_time": 500.0,
     "measured_flop_rate": 0.0},
]
ROWS = OBS_ROWS + [
    {"operation": f"jit({prog})/{mod}.{i}/op", "type": typ,
     "total_self_time": us, "measured_flop_rate": rate,
     "occurrences": occ, "host_or_device": where}
    for i, (prog, mod, typ, us, rate, occ, where) in enumerate([
        ("denoise_window", "UNetCondition", "pallas_call", 812.5, 3.1e5, 4,
         "Device"),
        ("denoise_window", "UNetCondition", "fusion", 95.0, 0.0, 40,
         "device"),
        ("denoise_window", "BrushNetModel", "dot_general", 250.0, 5e5, 8,
         "device"),
        ("decode", "VAE", "conv_general_dilated", 77.7, 2e5, 3, "device"),
        ("window", "InpaintGenerator", "transpose", 42.0, 0.0, "2",
         "device"),
        ("stage1", "RAFT", "all_gather", 13.0, 0.0, None, "host"),
    ])]
PROGRAMS = {
    "denoise_window": {"ms": 800.0, "serial_ms": 0.0},
    "decode": {"ms": 80.0, "serial_ms": 0.0},
    "stage1": {"ms": 100.0, "serial_ms": 40.0},
    "window": {"ms": 90.0, "serial_ms": 0.0},
    "IDLE": {"ms": 50.0, "serial_ms": 0.0},
}


def test_profiling_matches_jax():
    """device_rows, program_of, aggregate_programs, breakdown_program,
    window_batch_speedup and project_multichip give the JAX module's
    results on the same rows (tests/test_observability.py's among them);
    the port's stage names map onto the same sharding model."""
    for rows in (OBS_ROWS, ROWS, ROWS[3:]):
        assert pprof.device_rows(rows) == jprof.device_rows(rows)
        for r in rows:
            assert pprof.program_of(r["operation"]) == \
                jprof.program_of(r["operation"])
        for peak in (0.001, 197.0, 989.0):
            assert pprof.aggregate_programs(rows, peak) == \
                jprof.aggregate_programs(rows, peak)
            for prog in ("stage1", "denoise_window", "window", "IDLE"):
                for by_module in (True, False):
                    assert pprof.breakdown_program(
                        rows, prog, peak, by_module) == \
                        jprof.breakdown_program(rows, prog, peak, by_module)
    for n in range(0, 20):
        for chips in (1, 2, 4, 8):
            for groups in (1, 2, 3):
                assert pprof.window_batch_speedup(n, chips, groups) == \
                    jprof.window_batch_speedup(n, chips, groups)
    programs = dict(PROGRAMS, **jprof.aggregate_programs(ROWS, 1.0))
    for chips in (1, 4, 8):
        for kw in ({}, {"frames": 22, "n_windows": 9},
                   {"overlap_transfers": False, "n_windows": 3}):
            assert pprof.project_multichip(programs, chips, **kw) == \
                jprof.project_multichip(programs, chips, **kw)
    stages = {"dn.window": {"ms": 400.0}, "pp.propagation": {"ms": 40.0},
              "pp.generator": {"ms": 90.0}, "IDLE": {"ms": 10.0}}
    pp = pprof.project_multichip(stages, 4, n_windows=9)["per_program"]
    assert pp == {"dn.window": 100.0, "pp.propagation": 40.0,
                  # 9 windows in 2 groups: 8 in 2 rounds of 4, then 1
                  "pp.generator": 30.0, "IDLE": 0.0}
    assert pprof.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    with pytest.raises(ValueError):
        pprof.peak_tflops("NVIDIA A100-SXM4-80GB")


def _event(name, start, end, device=False, id=0, annotation=False):
    """A profiler event as rows_from_profiler reads it."""
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, id=id, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation, cpu_parent=None, kernels=[],
        flops=0, self_cpu_time_total=end - start)


def test_rows_from_profiler_names_the_stages():
    """A CPU torch.profiler run of a matmul and a convolution under two
    stage_timers: every row lies in its stage or IDLE, the flop counts of
    the two ops reach their stages, and the shares sum to 1. Then CUDA
    activity as the card's profiler reports it (made up here): a kernel
    lies in the stage of the ranges around the CUDA call that launched it
    (same correlation id), not in the attention call's range, and takes
    the operations that range's name counts (4 B H Sq Sk D), a kernel
    whose call is missing lies in "unstaged", the device's copies of the
    ranges count for nothing, and IDLE is the span the kernels leave; the
    kernel table sums each kernel over its stages."""
    x = torch.randn(96, 96)
    img, w = torch.randn(1, 3, 32, 32), torch.randn(8, 3, 3, 3)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, with_flops=True) as prof:
        with stage_timer("gui.test_matmul"):
            (x @ x).sum()
        with stage_timer("gui.test_conv"):
            torch.nn.functional.conv2d(img, w).relu()
    rows = pprof.rows_from_profiler(prof)
    assert {r["host_or_device"] for r in rows} == {"host"}
    split = pprof.aggregate_programs(rows, peak_tf=1.0)
    assert set(split) == {"gui.test_matmul", "gui.test_conv", "IDLE"}
    assert abs(sum(d["share"] for d in split.values()) - 1.0) < 1e-3
    assert "gui.test_matmul/aten::mm" in {r["operation"] for r in rows}
    flops = {}
    for r in rows:
        stage = pprof.program_of(r["operation"])
        flops[stage] = flops.get(stage, 0.0) + \
            r["measured_flop_rate"] * r["total_self_time"] * 1e3
    assert flops["gui.test_matmul"] == pytest.approx(2 * 96 ** 3)
    assert flops["gui.test_conv"] == pytest.approx(2 * 8 * 27 * 30 * 30)
    assert flops["IDLE"] == 0.0

    events = [
        _event(STAGE_RANGE + "gui.test_cuda", 0.0, 100.0, annotation=True),
        _event(STAGE_RANGE + "attention:flash:1x1x10x10x10", 10.0, 20.0,
               annotation=True),
        _event("cudaLaunchKernel", 12.0, 14.0, id=7),
        _event("cudaLaunchKernel", 60.0, 61.0, id=8),
        _event(STAGE_RANGE + "gui.test_cuda", 30.0, 70.0, device=True,
               annotation=True),
        _event("flash_fwd_kernel<40>", 30.0, 50.0, device=True, id=7),
        _event("elementwise_kernel", 55.0, 65.0, device=True, id=8),
        _event("elementwise_kernel", 80.0, 90.0, device=True, id=9),
    ]
    rows = pprof.rows_from_profiler(SimpleNamespace(events=lambda: events))
    got = {r["operation"]: (r["type"], r["total_self_time"],
                            r["measured_flop_rate"]) for r in rows}
    assert got == {
        "gui.test_cuda/flash_fwd_kernel<40>": ("flash_attn_fwd", 20.0,
                                               4000 / 20.0 * 1e-3),
        "gui.test_cuda/elementwise_kernel": ("other", 10.0, 0.0),
        "unstaged/elementwise_kernel": ("other", 10.0, 0.0),
        "IDLE": ("IDLE", 60.0, 0.0)}
    assert {r["host_or_device"] for r in rows} == {"device"}
    # the profile scripts' kernel table: summed over stages, no ranges
    assert pprof.kernel_table(rows) == [
        (0.01 + 0.01, 2, "other", "elementwise_kernel"),
        (0.02, 1, "flash_attn_fwd", "flash_fwd_kernel<40>")]
