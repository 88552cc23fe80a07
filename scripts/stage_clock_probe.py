#!/usr/bin/env python3
"""What the port's tracing costs, and whether its stage records' device
clock agrees with a profiler's trace.

    python3 scripts/stage_clock_probe.py [--cells mask.720p.48f.2obj,...]
        [--seed N] [--requests N] [--out DIR]

For each benchmark cell (one card; `benchmark/workloads/<cell>.json`, its
configuration and seeded weights, as the benchmark sets it up):

- the ranges' cost with no profiler running: host microseconds of one
  `trace_annotation` range, one `StageSum` span and one attention call's
  `_span` check, each timed over 20000 entries, times the number of each
  that one request opens (counted in the profiled request below), over
  the median request wall;
- request walls with VV_LOG unset and with VV_LOG=json, in turns;
- one request with VV_LOG=json under torch.profiler (CPU and CUDA): for
  each stage with records, the records' summed `device_ms` against the
  summed device span (first kernel's start to last kernel's end, kernels
  placed by their launch's host time) of the stage's ranges in the same
  trace. SAM2's prompt-frame fetches (before the first `sam2.wire_prep`)
  open a range but make no record, and are left out.

Prints the card's line and one JSON line per cell, and writes them to
DIR/stage_clock_<cell>.json (default build/profiles/, git-ignored). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def per_entry_us(make, n: int = 20000) -> float:
    """Host microseconds of one `with make():` entry and exit."""
    for _ in range(100):
        with make():
            pass
    t0 = time.perf_counter()
    for _ in range(n):
        with make():
            pass
    return (time.perf_counter() - t0) / n * 1e6


def timed(ent, i: int) -> float:
    import torch
    t0 = time.perf_counter()
    ent.request(i, capture=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def set_log(on: bool) -> None:
    from videovanish_tpu_torch.utils import observability as obs
    if on:
        os.environ["VV_LOG"] = "json"
    else:
        os.environ.pop("VV_LOG", None)
    lg = obs.get_logger()
    for h in list(lg.handlers):
        lg.removeHandler(h)
    obs._LOGGER = None
    obs.get_logger()


def range_spans(events) -> dict:
    """{stage: [(host start, device span us, kernels)]} of each stage range
    instance in a finished profile's events (attention ranges apart)."""
    from torch.autograd import DeviceType
    from videovanish_tpu_torch.utils.observability import STAGE_RANGE
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(STAGE_RANGE)]
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith("cu")}
    placed = sorted((launch[d.id], d.time_range.start, d.time_range.end)
                    for d in device if d.id in launch)
    times = [p[0] for p in placed]
    out: dict = {}
    for e in cpu:
        if not e.name.startswith(STAGE_RANGE):
            continue
        stage = e.name[len(STAGE_RANGE):]
        if stage.startswith("attention"):
            stage = "attention"
        a = bisect.bisect_left(times, e.time_range.start)
        b = bisect.bisect_right(times, e.time_range.end)
        ks = placed[a:b]
        span = (max(k[2] for k in ks) - min(k[1] for k in ks)) if ks else 0.0
        out.setdefault(stage, []).append((e.time_range.start, span, len(ks)))
    return out


def probe(cell: str, seed: int, requests: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import configs, harness
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.utils import observability as obs

    wl = harness.workload(cell)
    ent = harness.entry_class(wl["entry"])(configs.load(wl["config"]), wl,
                                           seed, "cuda")
    ent.setup()
    torch.cuda.synchronize()

    cost = {
        "trace_annotation_us": per_entry_us(
            lambda: obs.trace_annotation("probe")),
        "stage_sum_span_us": per_entry_us(obs.StageSum("probe").span),
        "attention_span_us": per_entry_us(
            lambda: A._span("attention", "flash", (1, 1, 1, 1, 1))),
    }

    walls = {"off": [], "json": []}
    for i in range(requests):
        for mode in (("off", "json") if i % 2 == 0 else ("json", "off")):
            set_log(mode == "json")
            walls[mode].append(timed(ent, i))
    set_log(True)
    records: list = []
    with obs.collect_stages(records):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            timed(ent, requests)
    set_log(False)
    spans = range_spans(prof.events())
    del prof

    first_prep = min((s[0] for s in spans.get("sam2.wire_prep", [])),
                     default=None)
    clock = {}
    for stage in dict.fromkeys(name for name, _, _ in records):
        inst = spans.get(stage, [])
        if stage == "sam2.fetch" and first_prep is not None:
            inst = [s for s in inst if s[0] >= first_prep]
        dev = sum(f.get("device_ms", 0.0) for n, _, f in records
                  if n == stage)
        span_ms = sum(s[1] for s in inst) / 1e3
        clock[stage] = {
            "records": sum(n == stage for n, _, _ in records),
            "ranges": len(inst), "kernels": sum(s[2] for s in inst),
            "device_ms": dev, "trace_span_ms": span_ms,
            "rel": (dev - span_ms) / span_ms if span_ms else None,
            "host_s": sum(s for n, s, _ in records if n == stage)}

    n_attention = len(spans.get("attention", []))
    n_ranges = sum(len(v) for k, v in spans.items() if k != "attention")
    n_sums = sum(len(spans.get(k, [])) for k in (
        "sam2.step_dispatch", "sam2.fetch", "dn.windows", "dn.decode_fetch"))
    wall = statistics.median(walls["off"])
    off_us = (n_ranges * cost["trace_annotation_us"]
              + n_sums * cost["stage_sum_span_us"]
              + n_attention * cost["attention_span_us"])
    result = {
        "cell": cell, "seed": seed, "card": card_line(), "cost": cost,
        "ranges_per_request": n_ranges, "stage_sum_spans": n_sums,
        "attention_calls": n_attention,
        "tracing_off_us_per_request": off_us,
        "tracing_off_share_pct": 100 * off_us / 1e6 / wall,
        "walls_s": walls, "wall_median_off_s": wall,
        "wall_median_json_s": statistics.median(walls["json"]),
        "stage_clock": clock}
    ent.release()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="mask.720p.48f.2obj,infill.720p.24f")
    ap.add_argument("--seed", type=int, default=2718281900)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    for cell in args.cells.split(","):
        r = probe(cell, args.seed, args.requests)
        with open(os.path.join(args.out, f"stage_clock_{cell}.json"),
                  "w") as f:
            json.dump(r, f, indent=1)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
