"""One run of one cell: set-up, a closed-loop window (or, with --trace 1,
three timed requests and one profiled), then the check against the plain
reference, and the result's line.

Everything a cell needs is found by name: `workloads/<cell>.json` (its
configuration, chips, entry, traffic, warm-up and limits),
`configs/<config>.json`, `entries/<entry>.py`, the end-to-end and
per-layer metrics that `BENCHMARK.json` lists for the cell, and a reader
`metrics/<metric>.py` for each per-layer one.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "videovanish_tpu")
# the sampled request whose outputs the reference checks is one of the
# first SAMPLE_FROM of the window (every window completes at least these)
SAMPLE_FROM = 3
TRACE_WALLS = 3


class ForbiddenModule(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Top-level names in sys.modules, compared whole, that a run may not
    load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def check_modules(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModule(f"{where}: loaded {found}")


def load_file(path: Path, name: str):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, directory: Path | None = None) -> dict:
    d = directory or BENCH_DIR / "workloads"
    return json.loads((d / f"{name}.json").read_text())


def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_for(spec: dict, kind: str, cell: str) -> list:
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def entry_class(name: str):
    return load_file(BENCH_DIR / "entries" / f"{name}.py",
                     f"bench_entry_{name}").Entry


def peaks(device_name: str) -> dict:
    table = json.loads((BENCH_DIR / "peaks.json").read_text())
    for key, row in table.items():
        if key != "why" and key in device_name:
            return row
    raise ValueError(f"no peak known for {device_name!r}")


def _peaks(kind: str, device: str) -> dict:
    if device != "cuda":
        return {"peak_flops": float("nan"), "peak_bytes": float("nan")}
    row = peaks(kind)
    return {"peak_flops": row["bf16_flops"],
            "peak_bytes": row["hbm_bytes_per_s"]}


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _profile_request(ent, i: int, device: str):
    """One request under torch.profiler (CPU and CUDA activity, no
    with_flops): (profiler, host start, host end) in microseconds of the
    profiler's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.request"):
            ent.request(i, capture=False)
            _sync(device)
    req = [e for e in prof.events() if e.name == "bench.request"][0]
    return prof, (req.time_range.start, req.time_range.end)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", wl: dict | None = None,
             spec: dict | None = None, cfg: dict | None = None,
             log=sys.stderr) -> dict | None:
    """The result's dict of one run; None on every rank but 0 of a cell of
    several chips (`ranks.py` starts them; each runs this). `wl`, `spec`
    and `cfg` replace the files' workload, BENCHMARK.json and
    configuration (the CPU tests run a tiny cell through here)."""
    import torch
    from benchmark import configs, ranks, trace as tr

    wl = workload(cell) if wl is None else wl
    spec = benchmark_spec() if spec is None else spec
    cfg = configs.load(wl["config"]) if cfg is None else cfg
    chips = int(wl["chips"])
    ent = entry_class(wl["entry"])(cfg, wl, seed, device)
    ent.setup()
    root = ranks.rank() == 0
    _sync(device)
    check_modules("after set-up")
    setup_s = time.perf_counter() - t_start
    if root:
        print(f"[bench] {cell}: set-up {setup_s:.3f} s ("
              + ", ".join(f"{k} {v:.3f}" for k, v in ent.timings.items())
              + ")", file=log, flush=True)
    k = int(np.random.default_rng(seed).integers(0, SAMPLE_FROM))
    attempted = failed = 0
    metrics: dict = {}
    dev_info: dict = {"platform": "gpu" if device == "cuda" else device,
                      "kind": torch.cuda.get_device_name(0)
                      if device == "cuda" else device,
                      "count": chips}
    trace_rec = None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        if not trace:
            t0 = time.perf_counter()
            frames = 0
            walls = []
            while True:
                t1 = time.perf_counter()
                ent.request(attempted, capture=attempted == k)
                walls.append(time.perf_counter() - t1)
                attempted += 1
                frames += ent.frames_per_request
                # every rank runs the same requests: rank 0's clock decides
                if ranks.from_root(time.perf_counter() - t0 >= seconds
                                   and attempted >= SAMPLE_FROM, device):
                    break
            elapsed = time.perf_counter() - t0
            rates = {wl["rate_metric"]: frames / elapsed}
            if root:
                print(f"[bench] window {elapsed:.3f} s, request walls "
                      + " ".join(f"{w:.3f}" for w in walls), file=log,
                      flush=True)
        else:
            walls = []
            for i in range(TRACE_WALLS):
                t0 = time.perf_counter()
                ent.request(i, capture=i == k)
                _sync(device)
                walls.append(time.perf_counter() - t0)
            attempted = TRACE_WALLS + 1
            prof, span = _profile_request(ent, TRACE_WALLS, device)
            kernels, gaps = tr.from_events(prof.events(),
                                           tr.kernel_classes(), span)
            del prof
            trace_rec = tr.Trace(
                kernels=kernels, gaps=gaps, window_us=span[1] - span[0],
                wall_s=statistics.median(walls),
                frames=ent.frames_per_request, chips=chips,
                **_peaks(dev_info["kind"], device))
            # the device's busy time averaged over the chips
            dev_info["busy_s"] = ranks.mean(trace_rec.busy_us() / 1e6,
                                            device)
            dev_info["window_s"] = trace_rec.window_us / 1e6
            if root:
                print(f"[bench] walls {walls}, profiled "
                      f"{dev_info['window_s']:.3f} s, busy "
                      f"{dev_info['busy_s']:.3f} s", file=log, flush=True)
    except Exception:
        failed += 1
        traceback.print_exc(file=log)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    peak = ranks.max_(peak, device)
    dev_info["memory_peak_bytes"] = int(peak)
    check_modules("after the window")
    ent.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if not root:
        ranks.barrier()
        return None

    checks: dict = {}
    if failed == 0:
        t_check = time.perf_counter()
        numbers, counts = ent.check(count=trace)
        print(f"[bench] check {time.perf_counter() - t_check:.3f} s "
              f"{json.dumps(getattr(ent, 'detail', {}))}",
              file=log, flush=True)
        for name, value in numbers.items():
            checks[name] = {"value": value, "limit": wl["limits"][name]}
        if trace_rec is not None:
            trace_rec.counts = counts
    ranks.barrier()
    correct = failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())

    if not trace and failed == 0:
        values = dict(rates, peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        for m in metrics_for(spec, "end_to_end", cell):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    elif trace_rec is not None:
        for m in metrics_for(spec, "per_layer", cell):
            path = BENCH_DIR / "metrics" / f"{m['name']}.py"
            value = load_file(path, "bench_metric").read(trace_rec)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print_checks(checks, log)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_rec is not None:
        result["breakdown"] = tr.breakdown(trace_rec)
    result["checks"] = checks
    return result


def print_checks(checks: dict, log=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=log, flush=True)
