"""Per-stage device time, MFU, and the multi-card projection (port of
videovanish_tpu/utils/profiling.py).

The JAX package reads xprof's framework_op_stats; here `rows_from_profiler`
turns a torch.profiler run into rows of the same schema:

  operation           "<stage>/<kernel name>": the stage is the innermost
                      `stage_timer` / `trace_annotation` range
                      (utils/observability.py, a range named
                      STAGE_RANGE + the stage) around the launch, the
                      attention calls' ranges left out, "unstaged"
                      outside every range; "IDLE" for the device's gaps
  type                the kernel's class (`classify`, one table for every
                      profile script)
  total_self_time     microseconds, from the CUDA activity
  occurrences         launches
  measured_flop_rate  GFLOP/s: torch's with_flops counts of the aten
                      matmuls and convolutions, and for the hand-written
                      attention kernels their own count, from the shapes
                      in the name of the call's range (`ops/attention.py`:
                      4 B H Sq Sk D a forward, 10x a backward; a plain
                      route's matmuls keep torch's count)
  host_or_device      "device"; "host" (CPU self time) when the run has no
                      CUDA activity

The rest is the JAX module's arithmetic on those rows: `aggregate_programs`
(ms, share and MFU per stage), `breakdown_program` (the same by category),
`window_batch_speedup` and `project_multichip`, whose sharding model is
the JAX package's mapped onto the port's stage names (the mesh's frame
sharding: the VAE, the denoise windows, RAFT and the flow completion's
encoder and decoder shard their frames over "data"; the flow recurrence,
the image propagation, the dilation and the composite run whole on every
rank; the InpaintGenerator's windows shard by groups).
"""
from __future__ import annotations

import math
import re
from collections import defaultdict

from videovanish_tpu_torch.utils.observability import STAGE_RANGE

# (class, substrings of a kernel's or a CPU op's name), first match wins
KERNEL_CLASSES = (
    ("flash_attn_fwd", ("flash_fwd_kernel",)),
    ("flash_attn_bwd", ("flash_bwd_",)),
    ("small_seq_attn", ("small_seq_attn_kernel",)),
    ("small_seq_attn_bwd", ("small_seq_bwd_kernel",)),
    ("adamw", ("adam", "Adam", "multi_tensor_apply")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "winograd")),
    ("matmul", ("gemm", "cutlass", "nvjet", "cublas", "xmma", "aten::mm",
                "aten::addmm", "aten::bmm", "aten::baddbmm")),
    ("norm", ("group_norm", "GroupNorm", "layer_norm", "LayerNorm",
              "welford", "Welford")),
    ("softmax", ("softmax", "Softmax", "SoftMax")),
    ("gather", ("gather", "index_select", "indexSelect", "index_elementwise",
                "scatter")),
)


def classify(name: str) -> str:
    """The class of a kernel (or CPU op) name; "other" for elementwise
    work, casts and layout copies."""
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


# dense bf16 tensor-core TFLOP/s per card, by the name torch reports
# (NVIDIA's data sheet: H100 SXM5)
_PEAK_TFLOPS = (
    ("H100 80GB HBM3", 989.0),
)


def peak_tflops(device_name: str | None = None) -> float:
    """The card's dense bf16 peak in TFLOP/s; raises for a card this table
    does not know."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0)
    for sub, peak in _PEAK_TFLOPS:
        if sub in device_name:
            return peak
    raise ValueError(f"no bf16 peak known for {device_name!r}")


# CPU ops whose with_flops count is the matmul or convolution they launch
_FLOP_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
             "aten::conv2d", "aten::conv1d", "aten::conv3d")
UNSTAGED = "unstaged"
# operations per B H Sq Sk D of an attention call's range, by its kind
_ATTENTION_FLOPS = {"attention": 4, "attention_bwd": 10}
_KERNEL_ROUTES = ("flash", "packed", "tokenmajor")


def _attention_call(name: str):
    """(kind, route, (B, H, Sq, Sk, D)) of an attention call's range
    (`STAGE_RANGE` + "<kind>:<route>:<B>x<H>x<Sq>x<Sk>x<D>"), else None."""
    if not name.startswith(STAGE_RANGE):
        return None
    kind, _, rest = name[len(STAGE_RANGE):].partition(":")
    route, _, dims = rest.partition(":")
    if kind not in _ATTENTION_FLOPS or not dims:
        return None
    return kind, route, tuple(int(x) for x in dims.split("x"))


def _is_stage(evt) -> bool:
    return evt.name.startswith(STAGE_RANGE) and \
        _attention_call(evt.name) is None


def _kernel_flops(evt) -> float:
    """The operations of a hand-written attention kernel's call, from its
    range's name; 0 for any other event."""
    call = _attention_call(evt.name)
    if call is None or call[1] not in _KERNEL_ROUTES:
        return 0.0
    return float(_ATTENTION_FLOPS[call[0]] * math.prod(call[2]))


def _stage_of(evt) -> str:
    while evt is not None and not _is_stage(evt):
        evt = evt.cpu_parent
    return UNSTAGED if evt is None else evt.name[len(STAGE_RANGE):]


def _flops_of(evt) -> tuple:
    """(owner, flops) of the nearest event at or above `evt` that counts
    the operations its kernels do, or (None, 0)."""
    while evt is not None:
        if _kernel_flops(evt):
            return evt, _kernel_flops(evt)
        if evt.name in _FLOP_OPS and getattr(evt, "flops", 0):
            return evt, float(evt.flops)
        evt = evt.cpu_parent
    return None, 0.0


def _union_us(intervals) -> tuple:
    """(covered microseconds, first start, last end) of (start, end)
    intervals."""
    covered, start, end, cur = 0.0, None, None, None
    for a, b in sorted(intervals):
        start = a if start is None else start
        end = b if end is None else max(end, b)
        if cur is None or a > cur[1]:
            if cur is not None:
                covered += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        covered += cur[1] - cur[0]
    return covered, start, end


def _innermost(intervals, times) -> list:
    """For each of `times`, the payload of the innermost (last started)
    of the nested (start, end, payload) `intervals` that holds it, or
    None."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] < ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def _device_records(cpu, device) -> list:
    """(stage, kernel name, microseconds, flops owner) of each device
    event. A kernel is placed by the host time of the CUDA call that
    launched it (the CPU event with its correlation id): the innermost
    stage range, and the innermost kernel's attention range or counted
    aten op, around that call. This holds for kernels launched outside
    any torch op too (the attention kernels, through ctypes)."""
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith("cu")}
    times = [launch.get(d.id, float("nan")) for d in device]
    found = [t == t for t in times]
    times = [t if ok else float("-inf") for t, ok in zip(times, found)]
    ranges = [(e.time_range.start, e.time_range.end,
               e.name[len(STAGE_RANGE):]) for e in cpu if _is_stage(e)]
    owners = [(e.time_range.start, e.time_range.end, (id(e), _flops_of(e)[1]))
              for e in cpu if _kernel_flops(e)
              or (e.name in _FLOP_OPS and getattr(e, "flops", 0))]
    stage = _innermost(ranges, times)
    owner = _innermost(owners, times)
    return [(s if ok and s else UNSTAGED, d.name,
             float(d.time_range.end - d.time_range.start),
             o if ok else None)
            for d, s, o, ok in zip(device, stage, owner, found)]


def rows_from_profiler(prof) -> list[dict]:
    """Rows (the schema above) of a finished torch.profiler.profile: one per
    (stage, kernel name), plus IDLE, the part of the run's span (first
    event to last, host and device) in which the card ran nothing. Without
    CUDA activity: one per (stage, CPU op) of CPU self time, and IDLE the
    span less their sum."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    _, t0, t1 = _union_us(spans)
    span = (t1 - t0) if spans else 0.0
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # the device's work: kernels, copies and fills, not the device-side
    # copies of the annotation ranges
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(STAGE_RANGE)]
    # (stage, name, microseconds) records by the event that counts their
    # operations; each gets that count in proportion to its time
    owned: dict = defaultdict(list)
    if device:
        where = "device"
        for stage, name, us, owner in _device_records(cpu, device):
            key, flops = owner if owner is not None else (None, 0.0)
            owned[key].append((flops, stage, name, us))
        busy, _, _ = _union_us((e.time_range.start, e.time_range.end)
                               for e in device)
    else:
        where = "host"
        for e in cpu:
            owner, flops = _flops_of(e)
            owned[id(owner) if owner is not None else None].append(
                (flops, _stage_of(e), e.name,
                 float(e.self_cpu_time_total)))
    agg: dict = defaultdict(lambda: {"us": 0.0, "n": 0, "flops": 0.0})
    for key, recs in owned.items():
        total = sum(r[3] for r in recs) or 1.0
        for flops, stage, name, us in recs:
            d = agg[(stage, name)]
            d["us"] += us
            d["n"] += 1
            d["flops"] += flops * us / total if key is not None else 0.0
    if device:
        idle = max(0.0, span - busy)
    else:
        idle = max(0.0, span - sum(d["us"] for d in agg.values()))
    rows = [{"operation": f"{stage}/{name}", "type": classify(name),
             "total_self_time": d["us"], "occurrences": d["n"],
             "measured_flop_rate": d["flops"] / d["us"] * 1e-3
             if d["us"] else 0.0,
             "host_or_device": where}
            for (stage, name), d in agg.items()]
    rows.append({"operation": "IDLE", "type": "IDLE",
                 "total_self_time": idle, "occurrences": 1,
                 "measured_flop_rate": 0.0, "host_or_device": where})
    return rows


def kernel_table(rows: list[dict]) -> list[tuple]:
    """(ms, launches, class, name) of each kernel (or CPU op) of
    `rows_from_profiler`'s rows, summed over its stages, longest first;
    IDLE left out. Its ms sum to the device's busy time (kernel time
    summed, overlaps counted twice); the annotation ranges' device-side
    copies are not kernels and never in it."""
    agg: dict = {}
    for r in rows:
        if r["operation"] == "IDLE":
            continue
        name = r["operation"].split("/", 1)[1]
        d = agg.setdefault(name, [0.0, 0, r["type"]])
        d[0] += r["total_self_time"] / 1e3
        d[1] += r["occurrences"]
    return sorted(((ms, n, cls, name) for name, (ms, n, cls) in agg.items()),
                  reverse=True)


def device_rows(rows: list[dict]) -> tuple[list[dict], str]:
    dev = [r for r in rows
           if str(r.get("host_or_device", "")).lower() == "device"]
    if dev:
        return dev, "device"
    return rows, "host"


_PROG_RE = re.compile(r"^jit\(([^)]+)\)")


def program_of(op_name: str) -> str:
    """'jit(denoise_window)/UNet/...' -> 'denoise_window' (the JAX
    package's rows); 'dn.window/flash_fwd_kernel...' -> 'dn.window' (the
    port's); 'IDLE' -> 'IDLE'."""
    m = _PROG_RE.match(str(op_name))
    return m.group(1) if m else str(op_name).split("/", 1)[0]


def aggregate_programs(rows: list[dict],
                       peak_tf: float | None = None) -> dict[str, dict]:
    """Per-program (per-stage, for the port's rows) device split:
    self-time (ms), share, and MFU.

    MFU = sum_i(flop_rate_i * self_time_i) / (self_time_total * peak): the
    time-weighted mean of the rows' flop rates (GFLOP/s) over a program
    is its sustained flop rate; over the card's bf16 peak it is its
    tensor-core utilization. Rows with no flop rate (copies, elementwise
    work, IDLE) contribute time but zero flops. `serial_ms` counts the
    JAX package's while-loop ops (its sequential propagation scans).
    """
    peak = (peak_tf if peak_tf is not None else peak_tflops()) * 1e12
    agg: dict[str, dict] = {}
    for r in rows:
        prog = program_of(r.get("operation", "?"))
        us = float(r.get("total_self_time", 0) or 0)
        rate = float(r.get("measured_flop_rate", 0) or 0)  # GFLOP/s
        d = agg.setdefault(prog, {"us": 0.0, "flops": 0.0, "serial_us": 0.0})
        d["us"] += us
        d["flops"] += rate * 1e9 * us * 1e-6
        if "/while/" in str(r.get("operation", "")):
            d["serial_us"] += us
    total_us = sum(d["us"] for d in agg.values()) or 1.0
    out = {}
    for prog, d in sorted(agg.items(), key=lambda kv: -kv[1]["us"]):
        out[prog] = {
            "ms": round(d["us"] / 1e3, 1),
            "share": round(d["us"] / total_us, 4),
            "mfu": round(d["flops"] / (d["us"] * 1e-6 * peak), 4)
            if d["us"] else 0.0,
            "serial_ms": round(d["serial_us"] / 1e3, 1),
        }
    return out


_CATEGORY_BY_TYPE = {
    # the JAX package's HLO op types
    "pallas_call": "attention-kernel",
    "conv_general_dilated": "conv",
    "dot_general": "matmul",
    "gather": "gather",
    "scatter": "gather",
    "dynamic_slice": "gather",
    "dynamic_update_slice": "gather",
    "reshape": "layout",
    "transpose": "layout",
    "copy": "layout",
    "bitcast": "layout",
    "slice": "layout",
    "concatenate": "layout",
    "pad": "layout",
    "reduce": "reduction",
    "reduce_window": "reduction",
    "all_reduce": "collective",
    "all_gather": "collective",
    "collective_permute": "collective",
    "fusion": "fusion",
    # the port's kernel classes (KERNEL_CLASSES)
    "flash_attn_fwd": "attention-kernel",
    "flash_attn_bwd": "attention-kernel",
    "small_seq_attn": "attention-kernel",
    "small_seq_attn_bwd": "attention-kernel",
    "convolution": "conv",
    "matmul": "matmul",
    "norm": "reduction",
    "softmax": "reduction",
    "adamw": "optimizer",
    "IDLE": "idle",
}


def breakdown_program(rows: list[dict], program: str,
                      peak_tf: float | None = None,
                      by_module: bool = True) -> list[dict]:
    """Ops inside one program grouped by (module, op category) with
    self-time and MFU per group, sorted by time. `module` is the first
    scope segment after the program (JAX rows: e.g. UNetCondition); the
    port's rows carry the kernel's name there, so they are split with
    by_module=False, by category alone."""
    peak = (peak_tf if peak_tf is not None else peak_tflops()) * 1e12
    agg: dict[tuple, dict] = {}
    for r in rows:
        name = str(r.get("operation", "?"))
        if program_of(name) != program:
            continue
        parts = name.split("/")
        module = parts[1].split(".")[0] if by_module and len(parts) > 1 \
            else ""
        cat = _CATEGORY_BY_TYPE.get(str(r.get("type", "")), "elementwise")
        us = float(r.get("total_self_time", 0) or 0)
        rate = float(r.get("measured_flop_rate", 0) or 0)
        d = agg.setdefault((module, cat),
                           {"us": 0.0, "flops": 0.0, "occ": 0})
        d["us"] += us
        d["flops"] += rate * 1e9 * us * 1e-6
        d["occ"] += int(float(r.get("occurrences", 1) or 1))
    total_us = sum(d["us"] for d in agg.values()) or 1.0
    out = []
    for (module, cat), d in sorted(agg.items(), key=lambda kv: -kv[1]["us"]):
        out.append({
            "module": module, "category": cat,
            "ms": round(d["us"] / 1e3, 1),
            "share": round(d["us"] / total_us, 4),
            "mfu": round(d["flops"] / (d["us"] * 1e-6 * peak), 4)
            if d["us"] else 0.0,
            "occ": d["occ"],
        })
    return out


def window_batch_speedup(n_windows: int, n_chips: int,
                         n_groups: int = 2) -> float:
    """Window-parallel speedup of the InpaintGenerator leg: windows batch
    per ref-count group (<= n_groups distinct counts per chunk), each group
    padded to a multiple of the data axis. Sequential cost n_windows ->
    sharded cost = number of per-group rounds."""
    if n_chips <= 1 or n_windows <= 0:
        return 1.0
    # worst split: (n_windows - n_groups + 1) + 1 * (n_groups - 1)
    big = n_windows - (n_groups - 1)
    rounds = -(-big // n_chips) + (n_groups - 1) * 1
    return n_windows / max(1, rounds)


# the port's stages that run whole on every rank of a mesh, and the
# InpaintGenerator's windows (utils/observability.py's ranges)
REPLICATED_STAGES = ("mask_dilate", "pp.flow_recurrence", "pp.propagation",
                     "rescale_composite")
WINDOW_STAGES = ("window", "window_batch", "pp.generator")


def project_multichip(programs: dict[str, dict], n_chips: int = 8,
                      frames: int | None = None,
                      n_windows: int = 9,
                      overlap_transfers: bool = True) -> dict:
    """Project the measured per-program (per-stage) device split onto an
    n-card mesh under the pipeline's sharding design:

      - the JAX package's programs: denoise_window, VAE encode/decode and
        the prior resize shard their frames -> /n; stage1's conv part /n,
        its while-loop scans (`serial_ms`) replicate; window
        (InpaintGenerator) shards windows per ref-count group ->
        window_batch_speedup;
      - the port's stages: REPLICATED_STAGES run whole on every rank ->
        unchanged; pp.generator -> window_batch_speedup; every other
        stage (dn.*, pp.raft, pp.flow_completion, propainter_prior's and
        diffueraser_denoise's own work) shards its frames -> /n;
      - IDLE: gaps the card waits on the host. With overlap_transfers
        (the default) they are dropped, as if the host fed the card while
        it computed; overlap_transfers=False keeps them (conservative).

    Returns {projected_ms, measured_ms, reduction_x, per_program}.
    """
    proj = {}
    total = 0.0
    for prog, d in programs.items():
        ms, serial = d["ms"], d.get("serial_ms", 0.0)
        if prog == "IDLE":
            new = 0.0 if overlap_transfers else ms
        elif prog in WINDOW_STAGES:
            new = ms / window_batch_speedup(n_windows, n_chips)
        elif prog in REPLICATED_STAGES:
            new = ms
        else:
            # conv/matmul part shards over frames; scans replicate
            new = (ms - serial) / n_chips + serial
        proj[prog] = round(new, 1)
        total += new
    measured = sum(d["ms"] for d in programs.values())
    out = {
        "n_chips": n_chips,
        "measured_ms": round(measured, 1),
        "projected_ms": round(total, 1),
        "reduction_x": round(measured / total, 2) if total > 0 else 0.0,
        "per_program": proj,
        "assumes_transfer_overlap": overlap_transfers,
    }
    if frames and total > 0:
        out["projected_fps"] = round(frames / (total / 1e3), 2)
    return out
