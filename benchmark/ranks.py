"""A cell of several chips: one process per card, each running the whole
of `harness.run_cell` on the same requests, as torchrun would start the
port (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; the port
joins the group itself). Rank 0's result is the run's. The collectives
here keep the ranks in step: rank 0's clock ends the window for all, the
peak is the fullest card's, the busy time the ranks' mean.

    python benchmark/ranks.py --rank R --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> --t-start <perf_counter at start>

(started by `run`, never by hand). Without a process group every
function here returns its own value.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# a rank's set-up, window and check; past it the ranks are ended
RANK_TIMEOUT_S = 340


def _group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def rank() -> int:
    dist = _group()
    return dist.get_rank() if dist else 0


def _reduce(value: float, device, op: str) -> float:
    dist = _group()
    if dist is None:
        return value
    import torch
    dev = "cuda" if str(device).startswith("cuda") else "cpu"
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
    return float(t.item())


def max_(value: float, device) -> float:
    return _reduce(value, device, "MAX")


def mean(value: float, device) -> float:
    dist = _group()
    return _reduce(value, device, "SUM") / (dist.get_world_size()
                                            if dist else 1)


def from_root(flag: bool, device) -> bool:
    """Rank 0's flag on every rank."""
    dist = _group()
    if dist is None:
        return flag
    import torch
    dev = "cuda" if str(device).startswith("cuda") else "cpu"
    t = torch.tensor([1.0 if flag else 0.0], device=dev)
    dist.broadcast(t, src=0)
    return bool(t.item())


def barrier() -> None:
    dist = _group()
    if dist is not None:
        dist.barrier()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        world: int, extra_args=(), python=(sys.executable,)) -> dict | None:
    """Start `world` ranks, wait for all, and return rank 0's result (None
    if a rank failed or ran past RANK_TIMEOUT_S; every rank is ended
    before this returns)."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port),
                   # torchrun's default for several processes a host
                   OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        cmd = [*python, str(ROOT / "benchmark" / "ranks.py"),
               "--rank", str(r), "--workload", cell, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", str(int(trace)),
               "--t-start", repr(t_start), *extra_args]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=ROOT,
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL))
    try:
        out, _ = procs[0].communicate(timeout=RANK_TIMEOUT_S)
        rcs = [procs[0].returncode] + [p.wait(timeout=60) for p in procs[1:]]
    except subprocess.TimeoutExpired:
        print(f"a rank ran past {RANK_TIMEOUT_S} s", file=sys.stderr)
        rcs, out = [None], b""
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(rc != 0 for rc in rcs):
        print(f"ranks exited {rcs}", file=sys.stderr)
        return None
    return json.loads(out.decode().strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    p.add_argument("--t-start", type=float, required=True)
    # the CPU tests: a workload and configuration from files, on "cpu"
    p.add_argument("--device", default="cuda")
    p.add_argument("--wl-file")
    p.add_argument("--cfg-file")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    wl = json.loads(Path(args.wl_file).read_text()) if args.wl_file else None
    cfg = json.loads(Path(args.cfg_file).read_text()) \
        if args.cfg_file else None
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), args.t_start,
                                  device=args.device, wl=wl, cfg=cfg)
    except harness.ForbiddenModule as e:
        print(f"forbidden module on rank {args.rank}: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden module on rank {args.rank}: {found}",
              file=sys.stderr)
        return 3
    dist = _group()
    if dist is not None:
        dist.destroy_process_group()
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
