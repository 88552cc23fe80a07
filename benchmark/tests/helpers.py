"""A tiny cell for the CPU tests: the port's `tiny_config` widths and a
small clip, run through the harness on the CPU."""
from __future__ import annotations

import dataclasses

from benchmark import harness
from benchmark.reference.vvref.config import tiny_config


def tiny_spec() -> dict:
    cfg = tiny_config()

    def section(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
                if "checkpoint" not in f.name}
    return {s: section(getattr(cfg, s))
            for s in ("diffueraser", "propainter", "infill", "sam2")}


def tiny_workload(cell: str, frames: int) -> dict:
    wl = harness.workload(cell)
    wl["traffic"] = dict(wl["traffic"], frames=frames, height=64, width=96)
    if "negative_frame" in wl["traffic"]:
        wl["traffic"]["negative_frame"] = 2
    wl["warmup"] = 1
    return wl


def run_tiny(cell: str, frames: int, seed: int = 3, trace: bool = False):
    import time
    return harness.run_cell(cell, seed, 0.5, trace, time.perf_counter(),
                            device="cpu", wl=tiny_workload(cell, frames),
                            cfg=tiny_spec())
