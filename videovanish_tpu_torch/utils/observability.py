"""Stage timers, structured logs and profiling (port of
videovanish_tpu/utils/observability.py).

- `stage_timer` / `record_stage`: per-stage durations as JSON lines on
  stderr under VV_LOG=json (`{"event": "stage", "name", "seconds", ...}`,
  the JAX package's fields), human-readable under any other VV_LOG value,
  silent without it; `collect_stages` captures them in-process.
- `maybe_profile`: with VV_PROFILE_DIR set, a torch.profiler trace (CPU
  and, where there is a card, CUDA activity) of the region, written there
  as a Chrome trace.
- `trace_annotation`: a range in that trace named STAGE_RANGE + the
  stage, which `utils/profiling.rows_from_profiler` reads as a stage.
- `trace_shardings` / `record_sharding`: with a sink installed, what each
  program (vae_encode, vae_decode, denoise_window, propainter_stage1,
  propainter_window) receives on this rank: per tensor ("data",) where it
  is this rank's block of a frame axis split over the mesh's "data" axis
  (a block `core/mesh.run_sharded` hands its function), () where it is the
  whole axis. The port's tensors are plain local ones, so the spec says
  which of the two the rank was given, as the JAX package's records the
  sharding of the global array its program was compiled for.

The timers read the host clock: the card runs behind it, so work left in
the queue bills to the stage that next waits on the device.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger("videovanish_tpu_torch")
        mode = os.environ.get("VV_LOG", "")
        if mode and not lg.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(message)s" if mode == "json"
                else "[vv %(asctime)s] %(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.INFO)
        _LOGGER = lg
    return _LOGGER


def _emit(event: str, **fields):
    lg = get_logger()
    if not lg.handlers:
        return
    if os.environ.get("VV_LOG") == "json":
        lg.info(json.dumps({"event": event, **fields}))
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        lg.info(f"{event} {kv}")


_STAGE_COLLECTORS: list[list] = []


@contextlib.contextmanager
def collect_stages(into: list):
    """Append (stage, seconds, fields) of every stage recorded meanwhile,
    in any thread, to `into`."""
    _STAGE_COLLECTORS.append(into)
    try:
        yield into
    finally:
        # by identity: nested collectors hold equal lists
        for i in range(len(_STAGE_COLLECTORS) - 1, -1, -1):
            if _STAGE_COLLECTORS[i] is into:
                del _STAGE_COLLECTORS[i]
                break


def record_stage(stage: str, seconds: float, **fields) -> None:
    """Report a stage measured elsewhere, as stage_timer's exit does."""
    for sink in _STAGE_COLLECTORS:
        sink.append((stage, seconds, fields))
    _emit("stage", name=stage, seconds=round(seconds, 4), **fields)


_SHARDING_TRACE: list | None = None


def trace_shardings(into: list | None) -> None:
    """Install (or clear, with None) a sink that `record_sharding` appends
    (program, {name: spec}) to."""
    global _SHARDING_TRACE
    _SHARDING_TRACE = into


def record_sharding(program: str, **tensors) -> None:
    """Record {name: ("data",) or ()} of the tensors entering `program`
    (see above). A no-op beyond a None check unless a sink is installed."""
    if _SHARDING_TRACE is None:
        return
    from videovanish_tpu_torch.core.mesh import is_data_block
    _SHARDING_TRACE.append((program, {
        name: ("data",) if is_data_block(t) else ()
        for name, t in tensors.items()}))


@contextlib.contextmanager
def stage_timer(stage: str, **fields):
    """Time a stage on the host clock; record it and name it in a trace."""
    t0 = time.perf_counter()
    with trace_annotation(stage):
        yield
    record_stage(stage, time.perf_counter() - t0, **fields)


STAGE_RANGE = "vv.stage="


@contextlib.contextmanager
def trace_annotation(name: str):
    import torch
    with torch.profiler.record_function(STAGE_RANGE + name):
        yield


_PROFILER = None


def start_profile(log_dir: str | None = None) -> bool:
    """Start a torch.profiler trace for VV_PROFILE_DIR (or log_dir); True
    if one was started."""
    global _PROFILER
    log_dir = log_dir or os.environ.get("VV_PROFILE_DIR")
    if not log_dir or _PROFILER is not None:
        return False
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _PROFILER = (profile(activities=acts), log_dir)
    _PROFILER[0].start()
    _emit("profile_start", dir=log_dir)
    return True


def stop_profile() -> None:
    global _PROFILER
    if _PROFILER is not None:
        prof, log_dir = _PROFILER
        _PROFILER = None
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_"
                                     f"{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _emit("profile_stop", path=path)


@contextlib.contextmanager
def maybe_profile(log_dir: str | None = None):
    started = start_profile(log_dir)
    try:
        yield
    finally:
        if started:
            stop_profile()
