"""Stage timers, structured logs and profiling (port of
videovanish_tpu/utils/observability.py).

- `stage_timer` / `StageSum` / `record_stage`: per-stage durations as
  JSON lines on stderr under VV_LOG=json (`{"event": "stage", "name",
  "seconds", ...}`, the JAX package's fields), human-readable under any
  other VV_LOG value, silent without it; `collect_stages` captures them
  in-process. `StageSum` reports several spans of one stage as one record.
- `maybe_profile`: with VV_PROFILE_DIR set, a torch.profiler trace (CPU
  and, where there is a card, CUDA activity) of the region, written there
  as a Chrome trace.
- `trace_annotation`: while a torch profiler runs, a range in its trace
  named STAGE_RANGE + the stage, which `utils/profiling.rows_from_profiler`
  reads as a stage; every stage record's timer opens one.
- `trace_shardings` / `record_sharding`: with a sink installed, what each
  program (vae_encode, vae_decode, denoise_window, propainter_stage1,
  propainter_window) receives on this rank: per tensor ("data",) where it
  is this rank's block of a frame axis split over the mesh's "data" axis
  (a block `core/mesh.run_sharded` hands its function), () where it is the
  whole axis. The port's tensors are plain local ones, so the spec says
  which of the two the rank was given, as the JAX package's records the
  sharding of the global array its program was compiled for.

The timers read the host clock: the card runs behind it, so work left in
the queue bills to the stage that next waits on the device. Where a
record is read (VV_LOG set or a collector open) and the process holds a
CUDA context, each timed span also records a pair of CUDA events on the
current stream, and its record gains `device_ms`: the device's time from
the span's start to its end. Nothing synchronises for them: a record
whose events the device has not reached yet is held, with every record
after it on its thread, and emitted in order once they are done, at the
latest when a collector closes or the process exits.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import sys
import threading
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


class _Held(threading.local):
    """This thread's records not emitted yet: (stage, seconds, fields,
    collectors, event pairs), in the order they were made."""

    def __init__(self):
        self.records: list = []


_HELD = _Held()


@contextlib.contextmanager
def collect_stages(into: list):
    """Append (stage, seconds, fields) of every stage recorded meanwhile,
    in any thread, to `into`; this thread's held records reach it before
    the block ends."""
    _STAGE_COLLECTORS.append(into)
    try:
        yield into
    finally:
        _flush(wait=True)
        # by identity: nested collectors hold equal lists
        for i in range(len(_STAGE_COLLECTORS) - 1, -1, -1):
            if _STAGE_COLLECTORS[i] is into:
                del _STAGE_COLLECTORS[i]
                break


def _read() -> bool:
    """Whether a stage record is read: VV_LOG's handler or a collector."""
    return bool(_STAGE_COLLECTORS) or bool(get_logger().handlers)


def _device_event():
    """A timing event recorded on the current CUDA stream, or None where
    the process holds no CUDA context (nothing ran on a card)."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _record(stage: str, seconds: float, fields: dict, pairs=()) -> None:
    _HELD.records.append((stage, seconds, fields, list(_STAGE_COLLECTORS),
                          list(pairs)))
    _flush(wait=False)


def _flush(wait: bool) -> None:
    """Emit this thread's held records in order, while the device has
    reached their events; with `wait`, wait for it."""
    held = _HELD.records
    while held:
        stage, seconds, fields, sinks, pairs = held[0]
        for _, end in pairs:
            if not end.query():
                if not wait:
                    return
                end.synchronize()
        del held[0]
        if pairs:
            fields = {**fields, "device_ms": sum(
                start.elapsed_time(end) for start, end in pairs)}
        for sink in sinks:
            sink.append((stage, seconds, fields))
        if "device_ms" in fields:
            fields = {**fields, "device_ms": round(fields["device_ms"], 3)}
        _emit("stage", name=stage, seconds=round(seconds, 4), **fields)


# the main thread's records still held when the interpreter exits
atexit.register(_flush, True)


def record_stage(stage: str, seconds: float, **fields) -> None:
    """Report a stage measured elsewhere, on the host clock alone."""
    _record(stage, seconds, fields)


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
    """Time a stage (see the module's doc for the device clock); record it
    and name it in a trace. Yields its fields, which the block may add
    to."""
    start = _device_event() if _read() else None
    t0 = time.perf_counter()
    with trace_annotation(stage):
        yield fields
    seconds = time.perf_counter() - t0
    _record(stage, seconds, fields,
            () if start is None else [(start, _device_event())])


class StageSum:
    """One record for several spans of a stage: each `with s.span():`
    opens the stage's range and adds its host seconds (and its device
    time, as `stage_timer` takes it); `record(**fields)` reports the sums
    and starts again."""

    def __init__(self, stage: str):
        self.stage = stage
        self.seconds, self.pairs = 0.0, []

    @contextlib.contextmanager
    def span(self):
        start = _device_event() if _read() else None
        t0 = time.perf_counter()
        with trace_annotation(self.stage):
            yield
        self.seconds += time.perf_counter() - t0
        if start is not None:
            self.pairs.append((start, _device_event()))

    def record(self, **fields) -> None:
        _record(self.stage, self.seconds, fields, self.pairs)
        self.seconds, self.pairs = 0.0, []


STAGE_RANGE = "vv.stage="


def profiler_running() -> bool:
    """True while a torch profiler records (torch's own Python flag)."""
    import torch
    return torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def trace_annotation(name: str):
    """While a torch profiler runs, a range named STAGE_RANGE + `name`;
    nothing otherwise. Names stay fixed: readers match them whole."""
    if not profiler_running():
        yield
        return
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
