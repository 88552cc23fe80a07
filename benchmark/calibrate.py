"""The readings that a cell's limits are set from, on the chip, at the
cell's own size:

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out FILE]

For each of --seeds: the program built from the seed's weights runs the
request that a run of that seed checks, and its numbers against the
reference are printed (the lower readings). For each of --control-seeds:
the control, the reference with its linear and convolution layers in
fp8 (`reference/fp8.py`), put in the program's place and held to the f32
reference the same way (the upper readings). One JSON line each, to
standard output and, with --out, to FILE. The benchmark's runs never
run the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(cell: str, seeds, control_seeds, device: str = "cuda",
             wl=None, cfg=None, emit=print):
    import numpy as np
    import torch
    from benchmark import configs, harness
    wl = dict(wl or harness.workload(cell))
    cfg = cfg or configs.load(wl["config"])
    Entry = harness.entry_class(wl["entry"])
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ent = Entry(cfg, dict(wl, warmup=wl["warmup"] if i == 0 else 0),
                     seed, device)
        ent.setup()
        k = int(np.random.default_rng(seed).integers(0, harness.SAMPLE_FROM))
        ent.request(k, capture=True)
        ent.release()
        numbers, _ = ent.check()
        rec = {"cell": cell, "seed": seed, "side": "program",
               "numbers": numbers, "detail": getattr(ent, "detail", {}),
               "seconds": time.perf_counter() - t0}
        emit(json.dumps(rec))
        out.append(rec)
        del ent
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    for seed in control_seeds:
        t0 = time.perf_counter()
        ent = Entry(cfg, wl, seed, device, program=False)
        rng = np.random.default_rng(seed)
        ent.pool_from(rng)
        k = int(np.random.default_rng(seed).integers(0, harness.SAMPLE_FROM))
        clip = k % wl["pool"]
        ref = ent.reference(clip)
        ctl = ent.reference(clip, control=True)
        numbers = ent.compare_references(ctl, ref)
        rec = {"cell": cell, "seed": seed, "side": "control",
               "numbers": numbers, "detail": getattr(ent, "detail", {}),
               "seconds": time.perf_counter() - t0}
        emit(json.dumps(rec))
        out.append(rec)
        del ent, ref, ctl
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    try:
        readings(args.workload, args.seeds, args.control_seeds, emit=emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
