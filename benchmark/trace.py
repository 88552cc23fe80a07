"""The traced run's records: the device's kernels of one profiled request,
each placed among the host's ranges, and the arithmetic every per-layer
reader and the `breakdown` share.

A kernel is placed by the host time of the CUDA call that launched it
(the CPU event with its correlation id), as the port's
`utils/profiling.rows_from_profiler` places it: the ranges open at that
moment are the kernel's. This holds for kernels launched outside any torch
op too (the port's attention kernels go through ctypes). The device-side
copies of the host's annotation ranges are not kernels.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

STAGE_RANGE = "vv.stage="
KERNEL_CLASSES_DIR = Path(__file__).with_name("kernel_classes")
OTHER = "glue"


def kernel_classes(directory: Path = KERNEL_CLASSES_DIR) -> list:
    """[(class, patterns)] from every `<class>.json` ({"order": n,
    "patterns": [substring, ...]}), lowest order first."""
    rows = []
    for path in sorted(directory.glob("*.json")):
        spec = json.loads(path.read_text())
        rows.append((spec["order"], path.stem, tuple(spec["patterns"])))
    return [(cls, pats) for _, cls, pats in sorted(rows)]


def classify(name: str, classes: list) -> str:
    for cls, pats in classes:
        if any(p in name for p in pats):
            return cls
    return OTHER


@dataclass
class Kernel:
    name: str
    cls: str
    start: float  # microseconds
    end: float
    ranges: tuple  # host ranges open at its launch, outermost first

    @property
    def us(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """What a per-layer reader reads: the profiled request's kernels (of
    rank 0), the host's gaps, and the request's facts."""
    kernels: list
    gaps: list  # (microseconds, label)
    window_us: float  # the profiled request's span on the host clock
    wall_s: float  # median wall of the unprofiled requests
    frames: int  # frames of one request
    chips: int
    peak_flops: float  # dense bf16 FLOP/s of one chip
    peak_bytes: float  # memory bytes/s of one chip
    counts: dict = field(default_factory=dict)  # the reference's counts

    def busy_us(self, kernels=None) -> float:
        return union_us((k.start, k.end) for k in
                        (self.kernels if kernels is None else kernels))

    def in_stage(self, stage: str) -> list:
        name = STAGE_RANGE + stage
        return [k for k in self.kernels if name in k.ranges]

    def of_class(self, cls: str, kernels=None) -> list:
        return [k for k in (self.kernels if kernels is None else kernels)
                if k.cls == cls]


def union_us(intervals) -> float:
    covered, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                covered += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        covered += cur[1] - cur[0]
    return covered


def _open_at(intervals, times) -> list:
    """For each of `times`, the payloads of the (start, end, payload)
    `intervals` that hold it, outermost first."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out = [()] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ivs) and ivs[j][0] <= t:
            stack = [s for s in stack if s[1] >= ivs[j][0]]
            stack.append(ivs[j])
            j += 1
        stack = [s for s in stack if s[1] >= t]
        out[i] = tuple(s[2] for s in stack)
    return out


def gaps_between(kernels, start: float, end: float) -> list:
    """(start, end) of the stretches of [start, end] with no kernel."""
    out, cur = [], start
    for a, b in sorted((k.start, k.end) for k in kernels):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if end > cur:
        out.append((cur, end))
    return out


def from_events(events, classes: list, span: tuple) -> tuple:
    """(kernels, labelled gaps) of a finished profile's events; `span`: the
    (start, end) microseconds of the profiled request on the host. A gap is
    labelled by the innermost host range (a torch op or an annotation)
    open when it starts."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(STAGE_RANGE)
              and not e.name.startswith("vv.flops=")]
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith("cu")}
    times = [launch.get(d.id, float("-inf")) for d in device]
    stages = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
              if e.name.startswith(STAGE_RANGE)]
    opened = _open_at(stages, times)
    kernels = [Kernel(d.name, classify(d.name, classes),
                      float(d.time_range.start), float(d.time_range.end), r)
               for d, r in zip(device, opened)]
    gaps = gaps_between(kernels, *span)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
            if not e.name.startswith("cu")]
    labels = _open_at(host, [a for a, _ in gaps])
    return kernels, [(b - a, lab[-1] if lab else "no host range")
                     for (a, b), lab in zip(gaps, labels)]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (as `class:kernel`), and
    the idle time by what the host was doing, seconds, at most `top`
    each."""
    ops: dict = {}
    for k in trace.kernels:
        key = f"{k.cls}:{k.name[:160]}"
        ops[key] = ops.get(key, 0.0) + k.us / 1e6
    idle: dict = {}
    for us, label in trace.gaps:
        idle[label[:160]] = idle.get(label[:160], 0.0) + us / 1e6
    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": first(ops), "idle_gaps": first(idle)}
