"""The port's tracing (utils/observability.py): the ranges SAM2's stages,
DiffuEraser's modules and every attention call open in a profiler's trace,
and the stage records' device clock, on the CPU with a stand-in event."""
import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu_torch.config import VVConfig, tiny_config
from videovanish_tpu_torch.models.diffueraser.model import DiffuEraser
from videovanish_tpu_torch.models.sam2.predictor import ENCODE_CHUNK
from videovanish_tpu_torch.ops import attention as A
from videovanish_tpu_torch.pipeline import infill as pinfill
from videovanish_tpu_torch.pipeline import masker as pmasker
from videovanish_tpu_torch.utils import observability as obs

R = obs.STAGE_RANGE
SAM2_COMPUTE = ("sam2.encode", "sam2.memory_attention", "sam2.decode",
                "sam2.memory_encode")


def _cpu_profile(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.events())


def _stages_above(evt) -> list:
    """The names of the stage ranges at and above `evt`, innermost first."""
    out = []
    while evt is not None:
        if evt.name.startswith(R):
            out.append(evt.name[len(R):])
        evt = evt.cpu_parent
    return out


def _scene():
    rng = np.random.default_rng(5)
    frames = [(rng.random((48, 64, 3)) * 255).astype(np.uint8)
              for _ in range(ENCODE_CHUNK + 2)]
    ann = {"keyframes": [
        {"frame_idx": 0, "pos_clicks": [{"x": 0.5, "y": 0.4, "obj": 1}],
         "rects": [{"x": 2, "y": 3, "w": 20, "h": 30, "obj": 2}]},
        {"frame_idx": 2, "neg_clicks": [{"x": 0.2, "y": 0.2, "obj": 1}]}]}
    return frames, ann


def test_sam2_request_opens_its_stage_ranges(tmp_path, monkeypatch):
    """A tiny masking request under a CPU profiler: every SAM2 range is
    there; uploads lie inside the stage that makes them; a propagation
    step's every aten op lies under exactly one of the four compute
    stages; fetches lie outside them; the host's colouring is
    masker.render. Under VV_PROFILE_DIR a call leaves a trace of its
    own. Each sam2.step_dispatch record counts the memory keys its steps
    attended and the whole bank's keys on those steps."""
    frames, ann = _scene()
    pinfill.set_config(tiny_config())
    records = []
    try:
        with obs.collect_stages(records):
            events = _cpu_profile(lambda: pmasker.run_sam2_on_frames(
                frames, ann, device="cpu"))
        monkeypatch.setenv("VV_PROFILE_DIR", str(tmp_path))
        pmasker.run_sam2_on_frames(frames[:3], ann, device="cpu")
    finally:
        pmasker.reset_predictor()
        pinfill.set_config(VVConfig())
    names = {e.name[len(R):] for e in events if e.name.startswith(R)}
    assert {*SAM2_COMPUTE, "sam2.upload", "sam2.fetch", "sam2.wire_prep",
            "sam2.encode_dispatch", "sam2.step_dispatch",
            "masker.render"} <= names

    by_name: dict = {}
    for e in events:
        if e.name.startswith(R):
            by_name.setdefault(e.name[len(R):], []).append(e)
    for e in by_name["sam2.upload"]:
        assert _stages_above(e)[1] in ("sam2.encode",
                                       "sam2.memory_attention",
                                       "sam2.decode")
    for e in by_name["sam2.fetch"]:
        assert not set(_stages_above(e)) & set(SAM2_COMPUTE)
    # the chunks' encodes (the prompt frames' have none around them)
    assert sum("sam2.encode_dispatch" in _stages_above(e)
               for e in by_name["sam2.encode"]) == 2
    steps = 0
    for e in events:
        above = _stages_above(e)
        if e.name.startswith("aten::") and "sam2.step_dispatch" in above:
            steps += 1
            assert sum(s in SAM2_COMPUTE for s in above) == 1, (e.name, above)
    assert steps > 0
    assert len(by_name["sam2.step_dispatch"]) == len(frames)
    # the first chunk's bank fills (its first frame has none); the second
    # chunk's is full
    first, second = [f for n, _, f in records if n == "sam2.step_dispatch"]
    assert 0 < first["mem_keys"] < first["mem_keys_bank"]
    assert 0 < second["mem_keys"] == second["mem_keys_bank"]
    trace = [p.read_text() for p in tmp_path.glob("trace_*.json")]
    assert len(trace) == 1 and R + "sam2.memory_encode" in trace[0]


def test_diffueraser_opens_module_ranges():
    """A tiny DiffuEraser call shows dn.vae (inside the encode and the
    decode stages), dn.brushnet and dn.unet (inside a window)."""
    cfg = tiny_config().diffueraser
    model = DiffuEraser(config=cfg, device="cpu")
    rng = np.random.default_rng(1)
    frames = (rng.random((4, 64, 64, 3)) * 255).astype(np.uint8)
    masks = np.zeros((4, 64, 64), np.uint8)
    masks[:, 16:40, 20:48] = 1
    with torch.inference_mode():
        events = _cpu_profile(lambda: model.forward(
            frames, masks, frames, max_img_size=64))
    inner = {}
    for e in events:
        if e.name.startswith(R):
            above = _stages_above(e)
            inner.setdefault(above[0], set()).add(tuple(above[1:]))
    assert {"dn.vae", "dn.brushnet", "dn.unet"} <= set(inner)
    assert {a[0] for a in inner["dn.vae"]} == {"dn.upload_encode",
                                                "dn.decode"}
    for module in ("dn.brushnet", "dn.unet"):
        assert all("dn.window" in a for a in inner[module])


def test_attention_range_names_every_route(monkeypatch):
    """Each entry opens one range named attention:<route>:<B>x<H>x<Sq>x<Sk>x
    <D> (attention_bwd: for the backward entries), whatever the route, and
    only while a profiler runs. On the CPU every route is plain; the
    kernel routes are named with the card's dispatch and stand-in
    kernels."""
    def x(*shape):
        return torch.randn(*shape)

    def calls():
        q = x(1, 2, 256, 8)
        A.attention(q, q, q)
        p = x(512, 2, 20, 8)
        A.attention(p, p, p)
        A.attention(q, q, q, key_mask=torch.ones(1, 256, dtype=torch.bool))
        t = x(48, 20, 16)
        A.attention_tokenmajor(t, t, t, heads=2)
        t = x(4, 100, 16)
        A.attention_tokenmajor(t, t, t, heads=2)
        A.flash_attention_backward(q, q, q, q, q, None, 0.5)
        A.small_seq_attention_backward(p, p, p, p, p, 0.5)
        t = x(48, 20, 16)
        A.small_seq_attention_backward(t, t, t, t, t, 0.5, heads=2)

    def names(events):
        return [e.name[len(R):] for e in events
                if e.name.startswith(R + "attention")]

    cpu = names(_cpu_profile(calls))
    assert cpu == [
        "attention:plain:1x2x256x256x8", "attention:plain:512x2x20x20x8",
        "attention:plain:1x2x256x256x8", "attention:plain:48x2x20x20x8",
        "attention:plain:4x2x100x100x8", "attention_bwd:plain:1x2x256x256x8",
        "attention_bwd:plain:512x2x20x20x8",
        "attention_bwd:plain:48x2x20x20x8"]

    def stand_in(*a, **k):
        return a[0]
    monkeypatch.setattr(A, "_on_card", lambda *ts: True)
    for fn in ("flash_attention", "small_seq_attention",
               "small_seq_attention_tokenmajor", "_flash_backward",
               "_small_seq_backward"):
        monkeypatch.setattr(A, fn, stand_in)
    card = names(_cpu_profile(calls))
    assert card == [
        "attention:flash:1x2x256x256x8", "attention:packed:512x2x20x20x8",
        "attention:plain:1x2x256x256x8", "attention:tokenmajor:48x2x20x20x8",
        "attention:plain:4x2x100x100x8", "attention_bwd:flash:1x2x256x256x8",
        "attention_bwd:packed:512x2x20x20x8",
        "attention_bwd:tokenmajor:48x2x20x20x8"]

    opened = []
    monkeypatch.setattr(A, "trace_annotation", opened.append)
    calls()
    assert opened == []


class _Event:
    """A stand-in CUDA event: `device` holds the time the device has
    reached; an event is done once it is past the event's time."""
    device = {"t": 0.0}
    made: list = []

    def __init__(self, t):
        self.t = t
        _Event.made.append(self)

    def query(self):
        return self.device["t"] >= self.t

    def synchronize(self):
        self.device["t"] = max(self.device["t"], self.t)

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def stand_in_events(monkeypatch):
    """obs._device_event gives stand-in events 10 ms apart."""
    _Event.device["t"], _Event.made[:] = 0.0, []
    monkeypatch.setattr(obs, "_device_event",
                        lambda: _Event(10.0 * (len(_Event.made) + 1)))
    return _Event


def test_stage_records_take_the_device_clock(monkeypatch, stand_in_events):
    """With a collector (or VV_LOG) open, each timed span records an event
    pair and its record gains device_ms; a record the device has not
    reached is held, with every record after it, and all are emitted in
    order at the outermost stage's exit once the device is there, or
    when the collector closes (waiting for it). With VV_LOG unset and no
    collector no event is made."""
    got = []
    with obs.collect_stages(got):
        with obs.stage_timer("outer", frames=2):
            with obs.stage_timer("inner"):
                pass
            total = obs.StageSum("sum")
            for _ in range(2):
                with total.span():
                    pass
            total.record(frames=2)
            obs.record_stage("host", 0.5, n=1)
            assert got == []
            stand_in_events.device["t"] = 1e9
        assert [(n, f) for n, _, f in got] == [
            ("inner", {"device_ms": 10.0}),
            ("sum", {"frames": 2, "device_ms": 20.0}),
            ("host", {"n": 1}), ("outer", {"frames": 2, "device_ms": 70.0})]
        assert got[2][1] == 0.5
        got.clear()
        stand_in_events.device["t"] = 0.0
        with obs.stage_timer("late"):
            pass
        assert got == []
    assert [(n, f) for n, _, f in got] == [("late", {"device_ms": 10.0})]

    monkeypatch.setenv("VV_LOG", "json")
    obs._LOGGER = None
    lines = []
    lg = obs.get_logger()
    capture = logging.Handler()
    capture.emit = lambda r: lines.append(json.loads(r.getMessage()))
    lg.addHandler(capture)
    try:
        stand_in_events.device["t"] = 1e9
        with obs.stage_timer("logged", frames=3):
            pass
    finally:
        for h in list(lg.handlers):
            lg.removeHandler(h)
        obs._LOGGER = None
    assert lines == [{"event": "stage", "name": "logged",
                      "seconds": lines[0]["seconds"], "frames": 3,
                      "device_ms": 10.0}]

    monkeypatch.delenv("VV_LOG")
    stand_in_events.made.clear()
    with obs.stage_timer("quiet"):
        with obs.StageSum("quiet_sum").span():
            pass
    assert stand_in_events.made == []
