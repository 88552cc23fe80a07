"""Run one cell of the port's benchmark once and print the result's line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`. The last line of standard
output is the result (`correct`, `attempted`, `failed`, `metrics`,
`device`, with --trace 1 `breakdown`, and last `checks`: each number the
check compared, beside its limit); the last lines of standard error are
the same checks. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 2. A cell of several chips starts
one process per card itself (`benchmark/ranks.py`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the kernels' build cache of the port is inside the checkout already
# (build/vv_kernels); keep torch's and triton's there too
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness
    wl = harness.workload(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        if int(wl["chips"]) > 1:
            from benchmark import ranks
            result = ranks.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START, int(wl["chips"]))
            if result is not None:
                harness.print_checks(result["checks"])
        else:
            result = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), T_START)
    except harness.ForbiddenModule as e:
        print(f"forbidden module: {e}", file=sys.stderr)
        return 3
    if result is None:
        return 4
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden module: loaded {found} at the end", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
