"""The trace arithmetic and the per-layer readers on a made-up trace, and
the closed loop's rate on a made-up entry."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, trace

BENCH = Path(__file__).resolve().parents[1]
DEN = "vv.stage=diffueraser_denoise"
PRI = "vv.stage=propainter_prior"


def read(metric, t):
    return harness.load_file(BENCH / "metrics" / f"{metric}.py", "m").read(t)


def made_up():
    ks = [trace.Kernel("flash_fwd_kernel<40>", "attention", 0, 100, (DEN,)),
          trace.Kernel("elementwise", "glue", 50, 150, (PRI,)),
          trace.Kernel("sm90_gemm", "matmul", 300, 400, (DEN, "x"))]
    return trace.Trace(kernels=ks, gaps=[(150.0, "aten::copy_")],
                       window_us=1000.0, wall_s=0.001, frames=10, chips=1,
                       peak_flops=989e12, peak_bytes=3.35e12,
                       counts={"flops": 1e9, "attention": {
                           "diffueraser": [(1, 1, 1024, 1024, 64)]}})


def test_readers_on_a_made_up_trace():
    t = made_up()
    assert t.busy_us() == 250.0
    assert read("idle_share.infill", t) == pytest.approx(75.0)
    assert read("prior_ms.infill", t) == pytest.approx(0.1)
    assert read("diffueraser_ms.infill", t) == pytest.approx(0.2)
    assert read("glue_ms.infill", t) == pytest.approx(0.1)
    assert read("sam2_ms_per_frame.mask", t) == pytest.approx(0.03)
    assert read("attn_roofline.infill", t) == pytest.approx(
        100 * 4 * 1024 * 1024 * 64 / 989e12 / 1e-4)
    assert read("mfu.infill", t) == pytest.approx(
        100 * 1e9 / (0.001 * 989e12))


def test_readers_return_nothing_without_their_records():
    t = made_up()
    t.kernels, t.counts = [], {}
    for m in ("idle_share.mask", "prior_ms.infill", "attn_roofline.infill",
              "mfu.mask", "glue_ms.infill"):
        assert read(m, t) is None


def test_union_gaps_and_open_ranges():
    ks = [trace.Kernel("a", "glue", 10, 20, ()),
          trace.Kernel("b", "glue", 15, 30, ()),
          trace.Kernel("c", "glue", 50, 60, ())]
    assert trace.union_us((k.start, k.end) for k in ks) == 30
    assert trace.gaps_between(ks, 0, 70) == [(0, 10), (30, 50), (60, 70)]
    ivs = [(0, 100, "outer"), (10, 20, "inner"), (40, 90, "mid")]
    assert trace._open_at(ivs, [15, 30, 50, 95, 200]) == [
        ("outer", "inner"), ("outer",), ("outer", "mid"), ("outer",), ()]


def test_kernels_placed_by_their_launch():
    from torch.autograd import DeviceType

    def ev(name, dev, start, end, id_=0):
        return SimpleNamespace(name=name, device_type=dev, id=id_,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [ev(DEN, cpu, 0, 100), ev("aten::mm", cpu, 10, 20),
              ev("cudaLaunchKernel", cpu, 12, 13, 7),
              ev("cuLaunchKernel", cpu, 150, 151, 8),
              ev("sm90_gemm", gpu, 30, 60, 7),
              ev("flash_fwd_kernel", gpu, 160, 170, 8),
              ev(DEN, gpu, 0, 100)]
    ks, gaps = trace.from_events(events, trace.kernel_classes(), (0, 200))
    assert [(k.name, k.cls, k.ranges) for k in ks] == [
        ("sm90_gemm", "matmul", (DEN,)), ("flash_fwd_kernel", "attention", ())]
    assert gaps[0] == (30, DEN) and gaps[-1] == (30, "no host range")
    b = trace.breakdown(trace.Trace(ks, gaps, 200, 0.0002, 1, 1, 1, 1))
    assert b["device_ops"][0] == ["matmul:sm90_gemm", 30e-6]
    assert len(b["idle_gaps"]) <= 10


class _Fake:
    frames_per_request = 10
    timings: dict = {}

    def __init__(self, *a):
        self.n = 0

    def setup(self):
        pass

    def request(self, i, capture):
        import time
        time.sleep(0.05)
        self.n += 1

    def release(self):
        pass

    def check(self, count=False):
        return {"gap": 0.5}, {}


def test_closed_loop_rate(monkeypatch):
    import time
    monkeypatch.setattr(harness, "entry_class", lambda name: _Fake)
    wl = {"name": "c", "config": "x", "chips": 1, "entry": "fake",
          "rate_metric": "things_fps", "limits": {"gap": 1.0}}
    spec = {"end_to_end": [{"name": "things_fps", "unit": "frames/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}
    r = harness.run_cell("c", 1, 0.5, False, time.perf_counter(),
                         device="cpu", wl=wl, spec=spec, cfg={})
    assert r["correct"] and r["failed"] == 0
    n = r["attempted"]
    assert n >= 10
    assert r["metrics"]["things_fps"]["value"] == pytest.approx(
        10 * n / (0.05 * n), rel=0.3)
    assert list(r)[-1] == "checks"
    assert r["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}


def test_collectives_read_apart_from_compute():
    t = made_up()
    t.kernels.append(trace.Kernel("ncclDevKernel_AllGather_RING_LL", "nccl",
                                  500, 900, ()))
    assert t.of_class("nccl")[0].us == pytest.approx(400.0)
    # the NCCL kernel waits on the device: not busy for the idle share
    assert read("idle_share.infill", t) == pytest.approx(75.0)
    assert t.busy_us() == 650.0
