#!/usr/bin/env python3
"""Probe of chip_smoke's two ways of timing a kernel, on the card.

    python3 scripts/timing_probe.py [--rows flash_d80,small_s64,...]
        [--passes 2]

chip_smoke times every kernel row twice: `ms` loops calls from Python (host
work included) and `device_ms` replays calls from a CUDA graph. This
probe times a few rows (large flash rows, whose kernels outlast their host
work, and small small_seq rows, whose host work outlasts the kernel) by:

  call        chip_smoke.time_ms: up to 50 calls, about 200 ms of kernel
  graph       chip_smoke.device_ms: as many calls as `call`, replayed once
              from a CUDA graph, on one copy of the inputs
  graph_l2    the same, cycling through copies of the inputs that hold
              twice the L2 cache (what chip_smoke's device_ms does)
  graph_long  the first graph timer: min(50, 50 ms / one call) calls in the
              graph, replayed up to 20 times (about 200 ms)
  call_long   the call loop for as many calls as graph_long

in `--passes` passes, every other one in reverse order, with an
`nvidia-smi` sampler (SM clock, power, temperature every 20 ms) running
alongside: each line gives a method's ms and the mean SM clock and power
over its run. The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import datetime
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROWS = {  # name: chip_smoke.kernel_cases() key
    "flash_d80": "flash_attn_fwd[D=80,Sq=2040,Sk=2040]",
    "flash_d512": "flash_attn_fwd[D=512,Sq=8160,Sk=8160]",
    "flash_d40": "flash_attn_fwd[D=40,Sq=4096,Sk=4096]",
    "small_n510": "small_seq_attn[tokenmajor,N=510,D=160,S=22]",
    "small_n135": "small_seq_attn[tokenmajor,N=135,D=160,S=22]",
    "small_s64": "small_seq_attn[tokenmajor,N=22,D=160,S=64]",
}
STAMP = "%Y/%m/%d %H:%M:%S.%f"


def graph_long_ms(fn) -> tuple[float, int]:
    """(mean ms of one call, calls) by the first graph timer: min(50,
    50 ms / one call) calls captured, replayed until about 200 ms."""
    import torch
    from chip_smoke import time_ms
    once = max(time_ms(fn, min_total_ms=0, max_reps=1), 1e-3)
    calls = int(max(1, min(50, 50 // once)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    replays = int(max(2, min(20, 200 // (calls * once))))
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays), calls * replays


def call_n_ms(fn, n: int) -> float:
    """Mean ms of one call over n calls issued from Python, after a
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def read_samples(path: Path) -> list[tuple[datetime.datetime, float, float]]:
    """(time, SM MHz, watts) of every sampler line that parses."""
    out = []
    for line in path.read_text().splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            out.append((datetime.datetime.strptime(parts[0], STAMP),
                        float(parts[1]), float(parts[2])))
        except (ValueError, IndexError):
            continue
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("timing_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (card_line, copies_past_l2, device_ms,
                            kernel_case, kernel_cases, time_ms)
    from videovanish_tpu_torch.ops import kernels
    print(f"[card] {card_line()}", flush=True)
    kernels.build()
    cases = {key: (route, shape) for key, _, route, shape in kernel_cases()}
    log = ROOT / "build" / "timing_probe_smi.csv"
    log.parent.mkdir(exist_ok=True)
    with open(log, "w") as f:
        sampler = subprocess.Popen(
            ["nvidia-smi", "--id=0", "--query-gpu=timestamp,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader,nounits",
             "-lms", "20"], stdout=f, stderr=subprocess.DEVNULL)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    windows = []  # (row, method, ms, calls, start, end)
    try:
        for row in args.rows.split(","):
            (B, H, Sq, Sk, D), make, kern, _, _, _, _ = kernel_case(
                *cases[ROWS[row]], randn)
            sets = [make() for _ in range(copies_past_l2(
                2 * B * H * (2 * Sq + 2 * Sk) * D))]
            q, k, v = sets[0]

            def one():
                return kern(q, k, v)
            rotated = [lambda s=s: kern(*s) for s in sets]
            long_calls = graph_long_ms(one)[1]
            methods = {
                "call": lambda: (time_ms(one), 0),
                "graph": lambda: (device_ms(one), 0),
                "graph_l2": lambda: (device_ms(rotated), 0),
                "graph_long": lambda: graph_long_ms(one),
                "call_long": lambda: (call_n_ms(one, long_calls),
                                      long_calls),
            }
            names = list(methods)
            for p in range(args.passes):
                for name in (names if p % 2 == 0 else names[::-1]):
                    t0 = datetime.datetime.now()
                    ms, calls = methods[name]()
                    windows.append((row, name, ms, calls, t0,
                                    datetime.datetime.now()))
            del q, k, v, sets, rotated
            torch.cuda.empty_cache()
    finally:
        sampler.terminate()
        sampler.wait()
    samples = read_samples(log)
    for row, name, ms, calls, t0, t1 in windows:
        inside = [(mhz, w) for t, mhz, w in samples if t0 <= t <= t1]
        clock = (f"SM {sum(m for m, _ in inside) / len(inside):.0f} MHz, "
                 f"{sum(w for _, w in inside) / len(inside):.0f} W over "
                 f"{len(inside)} samples") if inside else "no sample"
        print(f"[timing] {row} {name}: {ms:.4f} ms"
              f"{f' ({calls} calls)' if calls else ''}, "
              f"{(t1 - t0).total_seconds() * 1e3:.0f} ms wall; {clock}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
