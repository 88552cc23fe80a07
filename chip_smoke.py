#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (videovanish_tpu_torch) on the GPUs
of one machine (one is enough).

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. builds the CUDA kernels from `videovanish_tpu_torch/ops/csrc` (nvcc, one
   process per source, all at once) and prints the build seconds;
3. kernel phase: runs every kernel at the shapes the main path gives it, in
   bf16, against its plain PyTorch version in f32 on the same inputs
   (tolerance max|kernel - plain| <= 1e-2 * max|plain|), and times
   the kernel, the plain version and F.scaled_dot_product_attention (a
   yardstick only; the port never calls it). `ms` and `library_ms` time
   calls issued one after another from Python, host work included (the
   method of every earlier run); `device_ms` and `library_device_ms` time
   the same number of calls replayed from a CUDA graph, cycling through
   copies of the inputs that do not fit in L2 together; each is the mean
   of two runs in mirrored order (see `timed`). The backward rows
   (flash_attn_bwd, small_seq_attn_bwd, at each instance the training
   phase launches) hold dq, dk and dv to the same tolerance against
   attention_backward_ref in f32, O and the log-sum-exp coming from the
   forward kernel, require a second launch to be bitwise equal, and take
   the backward of F.scaled_dot_product_attention (autograd over a kept
   graph, its forward untimed) as the yardstick; their bound counts 10
   B H Sq Sk D flops, one exponential a score, and the bytes of q, k, v,
   o, dO, dq, dk, dv and the log-sum-exp. SAM2's memory cross-attention
   attends the bank's valid keys, so each occupancy the requests pass
   through while the bank fills is an instance of its own: once the
   requests have run, each such launched instance gets a row, checked
   and timed the same way;
3a. training: the DiffuEraser training step (`videovanish_tpu_torch.train`)
   at full width, the default config's UNet with motion modules and
   BrushNet (2.2 B parameters, seeded), remat, on one 22-frame clip of
   40x40 latents (TRAIN_CLIP; at 64x64 the step runs out of the card's
   memory: scripts/train_memory_probe.py); a warm-up step and 4 timed
   steps on the same batch, t and noise. Before the warm-up step the
   same loss is differentiated apart from the trainer, in f32 with every
   attention call on its plain path and no kernel launched; the warm-up
   step's gradient of every parameter is held to it (TRAIN_GRAD_TOL of
   its 2-norm). Checks finite losses, the last below the first, a finite
   gradient for every parameter, and that every kernel instance it
   launched has a kernel-phase row; prints the seconds per step, peak
   memory, the state's bytes and launches per step;
4. main path: `run_infill_on_frames` at the full SD1.5 / DiffuEraser width
   with seeded random weights, for two requests of 22 frames with the prior
   passed in: 1280x720 frames (544x960 inference, one temporal window) and
   512x512 frames (where the token-major temporal layout does not apply and
   the (B, H, S, D) fallback runs). Checks finite latents, the output shape,
   pixels outside the feathered mask equal to the input, and that every
   kernel instance of the path launched;
5. the prior computed: a third request of 22 frames at 1280x720 with
   `propainer_frames=None`, so the port's Propainter (RAFT, flow
   completion, image propagation, InpaintGenerator, at the published
   widths) computes the prior at 240x432 before DiffuEraser. Times
   `compute_prior` alone, then splits a second run of it by stage (a stage
   hook that synchronizes the card), and times the request. Checks finite
   flows and prior, the prior equal to the resized input outside the
   resized mask (uint8), the request's output as above, and that every
   kernel instance request 0 launched is launched again. Records the bf16
   prior's drift from the same weights run in f32 (PSNR and max |diff|
   inside the mask; a record, not a gate);
5a. the mesh: the port's multi-GPU path (`core/mesh.py`, ring attention
   in `parallel/`) at world size torch.cuda.device_count(): at 1 in this
   process over a one-rank NCCL process group on a local store (destroyed
   after the phase), above 1 one spawned rank a card. The request:
   `run_infill_on_frames` on 24 frames at 1280x720 with the prior
   computed, at the default config, first on one device (cold, then warm)
   and then through a ("data", "model") mesh over every rank, passed in
   explicitly since at one rank the pipeline's own policy builds none
   (cold, then warm: its kernel launches are the `launches_mesh_phase` of
   the kernel rows). Checks the output as above, that a window shards
   exactly where the data axis divides it, and the mesh run against the
   one-device run: equal outside the feathered mask, inside it a mean
   |diff| within 2.0 and a max within 64 (the JAX dry run's bounds; at one
   rank every sharding is a no-op and it reports whether the two are
   bitwise equal). Then `ring_attention` on the card over the mesh's data
   group at the request's temporal shapes, (B*S, H, T, D) = (8160, 8, 24,
   40) in f32, each rank holding its block of T, against the plain
   attention over the whole T in f32 (max |err| within 2e-5), both timed
   (the plain version over all of T on one card). Prints the world size, the mesh, the windows run
   sharded and whole, the warm wall times and peaks of both runs, and the
   NCCL version. Then the trainer on the mesh (`make_train_step(mesh=...)`,
   data and tensor parallelism), the training phase's step (its models,
   TRAIN_CLIP, remat, a warm-up and TRAIN_STEPS): first with mesh=None on
   every card at once, the baseline; at one card then on a 1x1 mesh,
   which must equal the baseline bitwise in every loss and every
   parameter after the last step; on N cards at (data N, model 1) on N
   clips (its first loss and every parameter's first gradient held to one
   card's on the same clips, MESH_LOSS_TOL and MESH_GRAD_TOL), at (data 1,
   model N) on one clip (every loss held to the baseline's,
   MESH_LOSS_TOL), and at (data 1, model N) on one clip of 64x64 latents
   (which do not fit one card: it reports whether they fit on N; its
   first loss held to a one-card forward). Prints each case's warm step
   time, its peak per rank and its losses;
6. SAM2 masking: a fourth request, `run_sam2_on_frames` on 24 frames at
   1280x720 with the default Sam2Config (Hiera-L at 1024x1024, 7 memory
   slots, 16 object pointers) and seeded random weights, two objects (a
   click and a box on frame 0, a negative click on frame 8). Run cold and
   warm; checks 24 (720, 1280, 3) uint8 outputs whose colors are black or
   the two objects', a bitwise equal second run, and that every SAM2
   kernel instance launched; then a third run split by stage (a stage hook
   that synchronizes the card, and checks the stages' outputs, logits
   included, finite). Prints the build seconds, cold and warm wall time,
   frames per second of propagation, the stage split, peak memory, and the
   bf16 logits' drift from the same weights in f32 (run on the CPU) on the
   prompt frame (a record, not a gate);
7. files and CLIs, at the default config: writes an 88-frame 1280x720
   color video (the synthetic scene) and its mask video with the port's
   writer (FFV1 through OpenCV's FFmpeg; prints the codec found) and
   reads both back (bitwise, fps and probe_video equal); runs the
   sam2_masker CLI on the first 24 frames (its file equal to
   run_sam2_on_frames bitwise); the diffuerase CLI with --chunked on (two
   chunks, (0, 48) and (40, 88)) and with --chunked off (pixels outside
   the feathered mask equal to the input in both; the chunked run
   launches every kernel instance of request 0), and the compare CLI
   between the two (the single pass has other windows and one prior for
   all 88 frames, so inside the feathered mask the two are held to a PSNR
   of 45 dB and a max |diff| of 32, not to 1 u8); a chunked job cancelled
   after chunk 0 and resumed through the CLI (it computes chunk 1 only,
   and its file equals the uninterrupted chunked file bitwise). Prints
   each run's wall time, peak memory and VV_LOG stage split, seconds per
   chunk and the prior's seconds inside each chunk; deletes the files;
7a. the GUI's four jobs (`videovanish_tpu_torch/gui/jobs.py`, what the
   window's buttons run), each on a threading.Thread as the window's
   QThread runs it, at the default config on a 30-frame 1280x720 color
   and mask file pair written by the port, the annotations held in the
   window's AnnotationStore (sam2_annotations' keyframes and a click at
   the cursor, frame 5): Generate Mask cancelled after SAM2 ran and Make
   Vanish cancelled before the infill (each returns None and writes no
   file); the 1-frame mask preview at the cursor, equal bitwise to
   run_sam2_on_frames on that frame with its keyframe remapped to 0; the
   22-frame infill preview from the cursor (preview_img_size 640: 360x640
   inference, 45x80 latents) cold and GUI_WARM_RUNS times warm, equal
   bitwise to run_infill_on_frames(..., preview=True) on the same frames,
   pixels outside the feathered mask equal to the input, then the same at
   frame 25 (5 frames); the warm preview twice more under torch.profiler
   started on the job's thread, without and with with_flops, split by
   stage with utils/profiling (from the with_flops run: ms, share and MFU
   against the card's bf16 peak, the IDLE share, the projection onto 4
   cards; from the other, whose host cost is lower, the IDLE share and
   the device ms over each unprofiled warm wall); Generate Mask and Make
   Vanish, their files equal bitwise to the sam2_masker and diffuerase
   CLIs' on the same inputs. Checks that
   every instance of GUI_INSTANCES was launched; prints each job's wall
   time and peak memory; deletes the files;
8. weights: writes a synthetic file set in the published layouts to
   build/weights_smoke (the keys and shapes of
   tests/fixtures/manifests/*.json, seeded values: the DiffuEraser UNet in
   f16, BrushNet in bf16, the legacy-named VAE, CLIP's text tower and a
   rank-64 PCM LoRA as .safetensors; RAFT, flow completion and the
   InpaintGenerator as .pth; SAM2's fb .pt), converts DiffuEraser's with
   the port's CLI (the LoRA merged into the UNet, then `--assemble
   diffueraser`, whose null embedding the 768-wide CLIP computes on the
   card), points a config at the outputs and the published files, and runs
   a 22-frame 512x512 `run_infill_on_frames` request with the prior
   computed and an 8-frame `run_sam2_on_frames` request with two objects.
   Checks every loaded tensor against its file bitwise (after the renames
   and the cast to the module's dtype), each merged weight against the
   plain formula in f64 (half a unit in the last place of the weight's
   dtype plus the f32 rounding of the rank products), the card's null
   embedding against the same CLIP in f32 on the CPU (1e-4 of its max),
   the requests as above, and the kernels they launch. Prints per-file
   seconds (write, read, to the card; the CLI's read, merge and write),
   the CLIP encode ms, the requests' wall and peak memory; deletes the
   files;
8a. Wan2.1-VACE: `run_infill_on_frames` with `infill.model = "vace"` at
   the published widths (seeded weights) on 81 frames at 1280x720
   (832x464 inference: 21 x 29 x 52 = 31668 tokens), 4 sampler steps as
   the benchmark's cell runs it, cold and then warm. Checks finite final
   latents, the output shape and pixels outside the feathered mask equal
   to the input; prints each run's wall, the warm run's stages (VAE
   encode, each step, VAE decode) and peak memory. `--only wan` runs the
   build, the Wan rows of the kernel phase and this phase alone;
9. prints one {"kernels": [...]} line, the card line, and last
   {"ok": true, "device": {...}}. A kernel row's `launches` counts the two
   requests with the prior passed in, the SAM2 request, the training
   phase, the GUI's jobs and the Wan request (each instance is launched
   by one of them;
   `launches_train_phase`, `launches_gui_phase`, `launches_prior_request`,
   `launches_sam2_request`, `launches_files_phase` (the chunked CLI run),
   `launches_weights_phase` and `launches_mesh_phase` give the other runs
   apart).

After the build it prints each kernel's `ptxas` lines (registers, spills,
warnings) and, where the toolkit has `cuobjdump`, the count of HGMMA (wgmma)
instructions and the highest register in each flash instantiation's SASS,
and the count of TMA loads (UTMALDG), cp.async copies (LDGSTS), ldmatrix
and mma.sync instructions in each small_seq_attn instantiation's, and the
wgmma, TMA load, mma.sync and ldmatrix counts and highest register of
each backward kernel; a flash instantiation without HGMMA, a
small_seq_attn one with neither TMA loads nor cp.async copies, a
flash_attn_bwd product kernel without HGMMA, or a backward kernel that
reads tiles without UTMALDG (small_seq_attn_bwd's also without HMMA),
fails the run.

Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3. The
# special-function units' ex2 rate (16 per SM per clock on sm_90) is read
# off the card: SM count times its maximum SM clock, see exp2_rate().
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
EX2_PER_SM_CLOCK = 16
TOL = 1e-2
# the null embedding: the same port code in f32 on the card and the CPU
NULL_TOL = 1e-4

SRC_FLASH = "videovanish_tpu_torch/ops/csrc/flash_attn.cu"
SRC_SMALL = "videovanish_tpu_torch/ops/csrc/small_seq_attn.cu"
SRC_FLASH_BWD = "videovanish_tpu_torch/ops/csrc/flash_attn_bwd.cu"
SRC_SMALL_BWD = "videovanish_tpu_torch/ops/csrc/small_seq_attn_bwd.cu"
TPU_SRC = "videovanish_tpu/ops/attention.py"
# the training phase: the default DiffuEraser config (UNet with motion
# modules + BrushNet), one 22-frame clip of 40x40 latents (320x320 frames;
# at 64x64 the step ran out of the card's memory, PERF.md)
TRAIN_CLIP = (1, 22, 40, 40)
TRAIN_LR = 1e-5
TRAIN_STEPS = 4  # after one warm-up step
# the warm-up step's gradients (bf16 autocast, the attention kernels) held
# per parameter against the same loss in f32 on the plain attention path:
# |g - g_ref|_2 <= TRAIN_GRAD_TOL * max(|g_ref|_2, TRAIN_GRAD_FLOOR * the
# largest |g_ref|_2 of any parameter)
TRAIN_GRAD_TOL = 0.05
TRAIN_GRAD_FLOOR = 1e-3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def exp2_rate() -> tuple[float, float]:
    """(ex2 per second, max SM clock in Hz) of card 0: SMs x 16 x the
    maximum SM clock nvidia-smi reports (the H100 SXM's data-sheet boost
    clock, 1980 MHz, where it reports none)."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip()
    mhz = float(out) if out.replace(".", "", 1).isdigit() else 1980.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * EX2_PER_SM_CLOCK * mhz * 1e6, mhz * 1e6


def sass_stats(lib_path, opcodes=("HGMMA",)) -> dict | None:
    """({opcode: instructions}, highest register index) per kernel function
    in the library's SASS (cuobjdump -sass), counting instructions whose
    mnemonic starts with one of `opcodes`; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    stats, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            stats[fn] = [dict.fromkeys(opcodes, 0), 0]
        elif fn is not None:
            op = re.search(r"\*/\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            for name in opcodes:
                stats[fn][0][name] += bool(op and op.group(1).startswith(name))
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            stats[fn][1] = max([stats[fn][1], *regs])
    return {fn: (n, r) for fn, (n, r) in stats.items()}


def check_flash_sass(lib_path) -> None:
    """Print the HGMMA count and highest register of every
    flash_fwd_kernel instantiation and fail if one has no HGMMA."""
    stats = sass_stats(lib_path)
    if stats is None:
        print("[sass] cuobjdump not found: HGMMA count not taken")
        return
    flash = {fn: st for fn, st in stats.items() if "flash_fwd_kernel" in fn}
    if not flash:
        raise RuntimeError("no flash_fwd_kernel in the library's SASS")
    for fn, (n, reg) in sorted(flash.items()):
        args = re.search(r"flash_fwd_kernelI((?:Li\d+E)+)E", fn)
        vals = re.findall(r"Li(\d+)E", args.group(1)) if args else [fn]
        print(f"[sass] flash_fwd_kernel<DK, BN, STAGES, SPLIT, NWG"
              f" = {', '.join(vals)}>: {n['HGMMA']} HGMMA, registers up to "
              f"R{reg}")
    missing = [fn for fn, (n, _) in flash.items() if n["HGMMA"] == 0]
    if missing:
        raise RuntimeError(f"flash instantiations without HGMMA: {missing}")


def check_small_seq_sass(lib_path) -> None:
    """Print the TMA loads (UTMALDG), cp.async copies (LDGSTS), ldmatrix
    (LDSM) and mma.sync (HMMA) instructions and the highest register of
    every small_seq_attn_kernel instantiation; fail if one has neither TMA
    loads nor cp.async copies."""
    ops = ("UTMALDG", "LDGSTS", "LDSM", "HMMA")
    stats = sass_stats(lib_path, ops)
    if stats is None:
        print("[sass] cuobjdump not found: TMA count not taken")
        return
    small = {fn: st for fn, st in stats.items()
             if "small_seq_attn_kernel" in fn}
    if not small:
        raise RuntimeError("no small_seq_attn_kernel in the library's SASS")
    for fn, (n, reg) in sorted(small.items()):
        dp = re.search(r"small_seq_attn_kernelILi(\d+)E", fn)
        counts = ", ".join(f"{n[o]} {o}" for o in ops)
        print(f"[sass] small_seq_attn_kernel<DP = "
              f"{dp.group(1) if dp else fn}>: {counts}, registers up to "
              f"R{reg}")
    missing = [fn for fn, (n, _) in small.items()
               if n["UTMALDG"] + n["LDGSTS"] == 0]
    if missing:
        raise RuntimeError(f"small_seq_attn instantiations without TMA or "
                           f"cp.async copies: {missing}")


def check_bwd_sass(built) -> None:
    """Print the wgmma (HGMMA), TMA load (UTMALDG), mma.sync (HMMA) and
    ldmatrix (LDSM) instructions and the highest register of every
    backward kernel; fail if a flash_attn_bwd product kernel (dK/dV or dQ)
    has no HGMMA, a backward kernel that reads tiles (all but the delta
    kernel) has no UTMALDG, or small_seq_attn_bwd's kernel has no HMMA."""
    ops = ("HGMMA", "UTMALDG", "HMMA", "LDSM")
    for lib in ("flash_attn_bwd", "small_seq_attn_bwd"):
        stats = sass_stats(built[lib], ops)
        if stats is None:
            print("[sass] cuobjdump not found: HGMMA and UTMALDG counts not "
                  "taken")
            return
        kerns = {fn: st for fn, st in stats.items() if "_kernel" in fn}
        if not kerns:
            raise RuntimeError(f"no kernels in {lib}'s SASS")
        for fn, (n, reg) in sorted(kerns.items()):
            m = re.search(r"\d+([a-z_]+_kernel)((?:ILi\d+E(?:Li\d+E)*E)?)",
                          fn)
            name = m.group(1) if m else fn[:60]
            args = re.findall(r"Li(\d+)E", m.group(2)) if m else []
            counts = ", ".join(f"{n[o]} {o}" for o in ops)
            print(f"[sass] {lib} {name}"
                  f"{'<' + ', '.join(args) + '>' if args else ''}: {counts}, "
                  f"registers up to R{reg}")
        tiles = {fn: n for fn, (n, _) in kerns.items() if "delta" not in fn}
        missing = [fn for fn, n in tiles.items() if n["UTMALDG"] == 0]
        if lib == "flash_attn_bwd":
            missing += [fn for fn, n in tiles.items() if n["HGMMA"] == 0]
        else:
            missing += [fn for fn, n in tiles.items() if n["HMMA"] == 0]
        if missing:
            raise RuntimeError(f"{lib} kernels without their TMA loads or "
                               f"products (UTMALDG, and HGMMA for flash, "
                               f"HMMA for small_seq): {missing}")


def time_ms(fn, min_total_ms: float = 200.0, max_reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = int(max(1, min(max_reps, min_total_ms // once)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fns, min_total_ms: float = 200.0, max_reps: int = 50,
              stream=None) -> float:
    """Mean device time of one call in ms: as many calls as time_ms makes
    (the same count, so that both keep the card busy for as long), cycling
    through `fns` (one callable per copy of the inputs, or one callable),
    captured into one CUDA graph and replayed once after a warm-up replay,
    timed by CUDA events. The host's work between calls (the Python
    wrapper, its checks, the launch) is not counted: where a call's host
    work takes longer than its kernel, time_ms measures the host and this
    the card. Copies that do not fit in L2 together make every call read
    its inputs from device memory, as the bound assumes. `stream`: the
    capture stream (the stream a kept autograd graph's forward ran on, so
    that its backward is captured)."""
    import torch
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # lazy set-up stays out of the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    once = max(time_ms(fns[0], min_total_ms=0, max_reps=1), 1e-3)
    calls = int(max(1, min(max_reps, min_total_ms // once)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / calls


def copies_past_l2(bytes_per_call: int, most: int = 16) -> int:
    """Copies of a call's operands that together hold at least twice the
    card's L2 cache."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) \
        or 50 << 20
    return int(min(most, max(1, math.ceil(2 * l2 / bytes_per_call))))


def timed(kern, kerns, lib, libs, lib_stream=None) -> dict:
    """The kernel's and the library call's times, each the mean of two
    runs in mirrored order (call loop, CUDA graph, graph, call loop), so
    neither method always runs first on a cooler or warmer card: `ms` and
    `library_ms` by time_ms on one copy of the inputs (host work included,
    as the rows were timed from the start), `device_ms` and `library_device_ms`
    by device_ms cycling through the copies."""
    order = [("ms", time_ms, kern), ("library_ms", time_ms, lib),
             ("device_ms", device_ms, kerns),
             ("library_device_ms",
              functools.partial(device_ms, stream=lib_stream), libs)]
    runs: dict = {}
    for name, timer, fn in order + order[::-1]:
        runs.setdefault(name, []).append(timer(fn))
    return {name: sum(t) / len(t) for name, t in runs.items()}


def bound(B, H, Sq, Sk, D, ex2_per_s):
    """Least time (ms) the card needs for one attention call, and what
    bounds it: q/k/v/o bytes at HBM rate, or the operations (tensor-core
    flops of q k^T and p v, and one exponential per score)."""
    t_bytes = 2 * B * H * (2 * Sq * D + 2 * Sk * D) / PEAK_BYTES
    t_ops = max(4 * B * H * Sq * Sk * D / PEAK_BF16_FLOPS,
                B * H * Sq * Sk / ex2_per_s)
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


# the kernel instances the SAM2 request launches (8-frame encode chunks and
# the single-frame encodes of the prompted frames)
SAM2_INSTANCES = (
    "flash_attn_fwd[D=72,Sq=256,Sk=256]", "flash_attn_fwd[D=72,Sq=4096,Sk=4096]",
    "flash_attn_fwd[D=72,Sq=64,Sk=256]", "flash_attn_fwd[D=16,Sq=22,Sk=4096]",
    "flash_attn_fwd[D=256,Sq=4096,Sk=4096]",
    "flash_attn_fwd[D=256,Sq=4096,Sk=28736]",
    "small_seq_attn[tokenmajor,N=8192,D=72,S=64]",
    "small_seq_attn[tokenmajor,N=1024,D=72,S=64]",
    "small_seq_attn[tokenmajor,N=128,D=72,S=64]",
    "small_seq_attn[tokenmajor,N=16,D=72,S=64]",
    "small_seq_attn[bhsd,N=8192,D=72,S=16]",
    "small_seq_attn[bhsd,N=1024,D=72,S=16]",
)


def kernel_cases():
    """(counter key, replaced TPU kernel line, route, shape) per kernel
    instance at the shapes the main paths give it. Flash shapes are
    (B, H, Sq, Sk, D) as split views of (B, S, H*D) projections; small-seq
    shapes are token-major (N, S, C, heads), or for the (B, H, S, D) route
    (N, Sq, C, heads[, Sk]) split into heads."""
    fl, it, tm, pk = (f"{TPU_SRC}:50", f"{TPU_SRC}:120", f"{TPU_SRC}:337",
                      f"{TPU_SRC}:269")

    def flash(B, H, Sq, Sk, D):
        return (f"flash_attn_fwd[D={D},Sq={Sq},Sk={Sk}]",
                it if D % 128 == 0 else fl, "flash", (B, H, Sq, Sk, D))
    cases = []
    # 544x960 and 512x512 inference: UNet / BrushNet spatial self- and
    # cross-attention of levels 0-2 (cross-attention at level 2 is too
    # short for flash), and the VAE mid block (one 512-wide head, chunks of
    # 8 frames)
    for tokens in (8160, 4096):
        cases += [flash(22, 8, tokens, tokens, 40),
                  flash(22, 8, tokens, 77, 40),
                  flash(22, 8, tokens // 4, tokens // 4, 80),
                  flash(22, 8, tokens // 4, 77, 80),
                  flash(22, 8, tokens // 16, tokens // 16, 160),
                  flash(8, 1, tokens, tokens, 512)]
    # SAM2 at 1024x1024, Hiera-L in 8-frame encode chunks, 2 objects:
    # stage-3 windows (16x16 tokens), global blocks, the stage-4 entry's
    # pooled queries over 16x16 windows; the mask decoder's token-to-image
    # attention (6 output + 16 prompt tokens, 8 heads of 16); memory
    # self-attention (one 256-wide head) and memory cross-attention over
    # the full bank
    cases += [flash(128, 8, 256, 256, 72), flash(8, 8, 4096, 4096, 72),
              flash(128, 16, 64, 256, 72), flash(2, 8, 22, 4096, 16),
              flash(2, 1, 4096, 4096, 256),
              flash(2, 1, 4096, BANK_FULL_KEYS, 256)]
    # the GUI's 22-frame infill preview at 1280x720 (360x640 inference,
    # 45x80 latents): levels 0-2 (3600, 920 and 240 tokens; text
    # cross-attention at level 2 is too short for flash) and the VAE's mid
    # block
    cases += [flash(22, 8, 3600, 3600, 40), flash(22, 8, 3600, 77, 40),
              flash(22, 8, 920, 920, 80), flash(22, 8, 920, 77, 80),
              flash(22, 8, 240, 240, 160), flash(8, 1, 3600, 3600, 512)]
    cases += [
        # temporal attention over the 22-frame window, 544x960 inference:
        # levels 0, 1 and 2 (68x120, 34x60, 17x30 latents) and level 3 with
        # the mid block (9x15)
        ("small_seq_attn[tokenmajor,N=8160,D=40,S=22]", tm, "tokenmajor",
         (8160, 22, 320, 8)),
        ("small_seq_attn[tokenmajor,N=2040,D=80,S=22]", tm, "tokenmajor",
         (2040, 22, 640, 8)),
        ("small_seq_attn[tokenmajor,N=510,D=160,S=22]", tm, "tokenmajor",
         (510, 22, 1280, 8)),
        ("small_seq_attn[tokenmajor,N=135,D=160,S=22]", tm, "tokenmajor",
         (135, 22, 1280, 8)),
        # 512x512 inference: the mid block's 8x8-token spatial attention,
        # and the temporal attention where J = 5 does not divide N
        ("small_seq_attn[tokenmajor,N=22,D=160,S=64]", tm, "tokenmajor",
         (22, 64, 1280, 8)),
        ("small_seq_attn[bhsd,N=4096,D=40,S=22]", pk, "packed",
         (4096, 22, 320, 8)),
        ("small_seq_attn[bhsd,N=1024,D=80,S=22]", pk, "packed",
         (1024, 22, 640, 8)),
        ("small_seq_attn[bhsd,N=256,D=160,S=22]", pk, "packed",
         (256, 22, 1280, 8)),
        # Hiera-L: stage-1 8x8 windows (C = 144, 2 heads) and stage-4 8x8
        # windows (C = 1152, 16 heads), for an 8-frame chunk and for the
        # single-frame encode of a prompted frame (N / J = 8 at stage 4);
        # the stage-2 entry's pooled 4x4 queries over 8x8 windows
        ("small_seq_attn[tokenmajor,N=8192,D=72,S=64]", tm, "tokenmajor",
         (8192, 64, 144, 2)),
        ("small_seq_attn[tokenmajor,N=1024,D=72,S=64]", tm, "tokenmajor",
         (1024, 64, 144, 2)),
        ("small_seq_attn[tokenmajor,N=128,D=72,S=64]", tm, "tokenmajor",
         (128, 64, 1152, 16)),
        ("small_seq_attn[tokenmajor,N=16,D=72,S=64]", tm, "tokenmajor",
         (16, 64, 1152, 16)),
        ("small_seq_attn[bhsd,N=8192,D=72,S=16]", pk, "packed",
         (8192, 16, 288, 4, 64)),
        ("small_seq_attn[bhsd,N=1024,D=72,S=16]", pk, "packed",
         (1024, 16, 288, 4, 64)),
        # the GUI's infill preview: temporal attention at levels 0-3
        # (45x80, 23x40, 12x20 and 6x10 latents) and the mid block's
        # 6x10-token spatial attention
        ("small_seq_attn[tokenmajor,N=3600,D=40,S=22]", tm, "tokenmajor",
         (3600, 22, 320, 8)),
        ("small_seq_attn[tokenmajor,N=920,D=80,S=22]", tm, "tokenmajor",
         (920, 22, 640, 8)),
        ("small_seq_attn[tokenmajor,N=240,D=160,S=22]", tm, "tokenmajor",
         (240, 22, 1280, 8)),
        ("small_seq_attn[tokenmajor,N=60,D=160,S=22]", tm, "tokenmajor",
         (60, 22, 1280, 8)),
        ("small_seq_attn[tokenmajor,N=22,D=160,S=60]", tm, "tokenmajor",
         (22, 60, 1280, 8)),
        # the GUI's Generate Mask on 30 frames: Hiera-L on the last encode
        # chunk of 6 frames (stage-1 and stage-4 windows, the stage-2 entry)
        ("small_seq_attn[tokenmajor,N=6144,D=72,S=64]", tm, "tokenmajor",
         (6144, 64, 144, 2)),
        ("small_seq_attn[tokenmajor,N=96,D=72,S=64]", tm, "tokenmajor",
         (96, 64, 1152, 16)),
        ("small_seq_attn[bhsd,N=6144,D=72,S=16]", pk, "packed",
         (6144, 16, 288, 4, 64)),
    ]
    cases += wan_kernel_cases()
    # the training phase's forward instances that inference does not launch
    known = {c[0] for c in cases}
    for fwd, _, route, shape in train_cases():
        if fwd in known:
            continue
        if route == "flash":
            cases.append(flash(*shape))
        else:
            cases.append((fwd, tm if route == "tokenmajor" else pk, route,
                          shape))
    return cases


def wan_kernel_cases():
    """Wan2.1-VACE at 832x464 and 81 frames (21 x 29 x 52 = 31668 tokens),
    beyond the JAX package (it replaces no TPU kernel): the DiT's
    self-attention and cross-attention to the 512 text rows, the prompt
    and the negative prompt batched (12 heads of 128), and the Wan-VAE's
    mid-block (one 384-wide head over a latent frame's 58 x 104 pixels)."""
    return [(f"flash_attn_fwd[D={D},Sq={Sq},Sk={Sk}]", "none (Wan)",
             "flash", (B, H, Sq, Sk, D))
            for B, H, Sq, Sk, D in ((2, 12, WAN_TOKENS, WAN_TOKENS, 128),
                                    (2, 12, WAN_TOKENS, 512, 128),
                                    (1, 1, 6032, 6032, 384))]


WAN_TOKENS = 21 * 29 * 52
WAN_CLIP = (81, 720, 1280)
WAN_STEPS = 4


def run_wan_request(seed: int = 0):
    """Phase 8a: (launch counts of the warm request, report)."""
    import numpy as np
    import torch
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.pipeline import infill
    from videovanish_tpu_torch.utils.observability import collect_stages

    base = default_config()
    cfg = dataclasses.replace(
        base, wan=dataclasses.replace(base.wan, sample_steps=WAN_STEPS),
        infill=dataclasses.replace(base.infill, model="vace"))
    infill.set_config(cfg)
    t0 = time.perf_counter()
    model = infill.get_wan("cuda")
    torch.cuda.synchronize()
    print(f"[wan] model built on the card in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    latents = []
    model.latent_hook = latents.append
    frames, masks, _ = synthetic_request(*WAN_CLIP, seed)
    walls = []
    for run in ("cold", "warm"):
        latents.clear()
        A.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        stages = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collect_stages(stages):
            out = infill.run_infill_on_frames(list(frames), list(masks),
                                              device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"[wan] {run}: {walls[-1]:.2f} s", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(A.LAUNCHES)
    z, change = check_request(out, frames, masks, latents, cfg)
    split = {}
    for name, secs, fields in stages:
        split[name] = split.get(name, 0.0) + secs
    report = {"frames": list(WAN_CLIP), "steps": WAN_STEPS,
              "latents": list(z.shape), "walls_s": walls,
              "peak_gib": peak, "stages_s": split,
              "latent_absmax": float(z.abs().max()),
              "inside_mean_abs_change": change}
    print(f"[wan] warm stages {json.dumps(split)}, peak {peak:.2f} GiB, "
          f"launches {json.dumps(counts, sort_keys=True)}", flush=True)
    infill.set_config(default_config())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, report


# memory cross-attention over the bank's valid keys: v spatial slots of
# 4096 grid tokens, then 4 tokens a valid pointer (7 x 4096 + 64 when the
# bank is full, kernel_cases()); while the bank fills, each occupancy the
# requests reach is its own instance, and gets a row of its own
BANK_SHAPE = re.compile(r"flash_attn_fwd\[D=256,Sq=4096,Sk=(\d+)\]")
BANK_FULL_KEYS = 7 * 4096 + 16 * 4


def bank_cases(names) -> list:
    """kernel_cases() rows of the memory cross-attention instances among
    `names` (launched kernel instances): Sk = v * 4096 + 4 * p keys for
    1 <= v <= 7 valid slots and 0 <= p <= 16 valid pointers."""
    cases = []
    for name in sorted(names):
        m = BANK_SHAPE.fullmatch(name)
        if m is None:
            continue
        v, ptr_tokens = divmod(int(m.group(1)), 4096)
        if 1 <= v <= 7 and ptr_tokens % 4 == 0 and ptr_tokens <= 64:
            cases.append((name, f"{TPU_SRC}:120", "flash",
                          (2, 1, 4096, int(m.group(1)), 256)))
    return cases


def kernel_case(route, shape, randn):
    """((B, H, Sq, Sk, D), make, kern, view, plain, lib, source) of one
    kernel_cases() row: make() draws q, k, v with randn as the main path
    lays them out; kern(q, k, v) calls the port's entry point, view(out)
    gives its output as (B, H, Sq, D), plain(q, k, v) is the plain version
    in f32 and lib(q, k, v) F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    from videovanish_tpu_torch.ops import attention as A

    def same(out):
        return out
    if route == "flash":
        B, H, Sq, Sk, D = shape
        scale = D ** -0.5

        def make():
            # split views of token-major projections, as Attention makes them
            return [randn(B, S, H, D).permute(0, 2, 1, 3)
                    for S in (Sq, Sk, Sk)]

        def kern(q, k, v):
            return A.attention(q, k, v, scale)

        def plain(q, k, v):
            return A.flash_attention_ref(q.float(), k.float(), v.float(),
                                         scale)

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
        assert A.attention_route((B, H, Sq), (B, H, Sk), True) == "flash"
        return (B, H, Sq, Sk, D), make, kern, same, plain, lib, SRC_FLASH
    N, S, C, heads = shape[:4]
    Sk = shape[4] if len(shape) > 4 else S
    d = C // heads
    scale = d ** -0.5

    def make():
        return [randn(N, n, C) for n in (S, Sk, Sk)]

    def split(t):
        return t.view(N, t.shape[1], heads, d).permute(0, 2, 1, 3)
    if route == "tokenmajor":
        assert A.tokenmajor_route((N, S, C), heads, True) == "tokenmajor"

        def kern(q, k, v):
            return A.attention_tokenmajor(q, k, v, heads, scale)
        view = split
    else:
        # the fallback when J does not divide N: attention() on the
        # head-split views
        assert A.attention_route((N, heads, S), (N, heads, Sk),
                                 True) == "packed"

        def kern(q, k, v):
            return A.attention(split(q), split(k), split(v), scale)
        view = same

    def plain(q, k, v):
        return A.small_seq_attention_ref(split(q).float(), split(k).float(),
                                         split(v).float(), scale)

    def lib(q, k, v):
        return F.scaled_dot_product_attention(split(q), split(k), split(v),
                                              scale=scale)
    return (N, heads, S, Sk, d), make, kern, view, plain, lib, SRC_SMALL


def run_kernel_phase(ex2_per_s: float, seed: int = 0, cases=None):
    import torch
    from videovanish_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = torch.device("cuda"), torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    rows = []
    for key, replaces, route, shape in (kernel_cases() if cases is None
                                        else cases):
        (B, H, Sq, Sk, D), make, kern, view, plain, lib, src = kernel_case(
            route, shape, randn)
        # q, k, v and o bytes of one call; copies of the inputs that do not
        # fit in L2 together, for device_ms
        b_ms, b_by = bound(B, H, Sq, Sk, D, ex2_per_s)
        sets = [make() for _ in range(copies_past_l2(
            2 * B * H * (2 * Sq + 2 * Sk) * D))]
        q, k, v = sets[0]
        before = A.LAUNCHES[key]
        got = view(kern(q, k, v))
        torch.cuda.synchronize()
        if A.LAUNCHES[key] != before + 1:
            raise RuntimeError(f"{key}: the call did not launch its kernel")
        ref = plain(q, k, v)
        err = (got.float() - ref).abs().max().item()
        limit = TOL * ref.abs().max().item()
        del ref, got
        t = timed(lambda: kern(q, k, v),
                  [functools.partial(kern, *s) for s in sets],
                  lambda: lib(q, k, v),
                  [functools.partial(lib, *s) for s in sets])
        plain_ms = time_ms(lambda: plain(q, k, v), min_total_ms=0, max_reps=2)
        row = {"name": key, "route": "cuda", "source": src,
               "replaces": replaces,
               "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D},
               "launches": 0, "max_abs_err": err, "tolerance": limit,
               "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": t["library_ms"],
               "bound_share": b_ms / t["ms"],
               "library_ratio": t["library_ms"] / t["ms"],
               "device_ms": t["device_ms"],
               "library_device_ms": t["library_device_ms"],
               "device_bound_share": b_ms / t["device_ms"],
               "device_library_ratio": t["library_device_ms"] / t["device_ms"],
               "input_copies": len(sets)}
        print(f"[kernel] {key} err={err:.3e} ms={t['ms']:.4f} "
              f"sdpa_ms={t['library_ms']:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound/ms={row['bound_share']:.3f}"
              f" sdpa/ms={row['library_ratio']:.3f} | device_ms="
              f"{t['device_ms']:.4f} sdpa_device_ms="
              f"{t['library_device_ms']:.4f} bound/device_ms="
              f"{row['device_bound_share']:.3f} sdpa/device_ms="
              f"{row['device_library_ratio']:.3f} ({len(sets)} input copies)",
              flush=True)
        if not math.isfinite(err) or err > limit:
            raise RuntimeError(f"{key}: max|kernel - plain| = {err} exceeds "
                               f"{limit}")
        rows.append(row)
        del q, k, v, sets
        torch.cuda.empty_cache()
    return rows


def bwd_bound(B, H, Sq, Sk, D, ex2_per_s, lse: bool):
    """Least time (ms) the card needs for one attention backward, and what
    bounds it: the five products (10 B H Sq Sk D flops), one exponential a
    score, or the bytes (q, k, v, o, dO read, dq, dk, dv written, bf16,
    and the forward's f32 log-sum-exp where the kernel reads one)."""
    t_bytes = (2 * B * H * (4 * Sq * D + 4 * Sk * D)
               + (4 * B * H * Sq if lse else 0)) / PEAK_BYTES
    t_ops = max(10 * B * H * Sq * Sk * D / PEAK_BF16_FLOPS,
                B * H * Sq * Sk / ex2_per_s)
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def train_cases():
    """(forward counter key, backward counter key, route, shape) of each
    kernel instance the training phase launches, by the port's dispatch at
    each level of the default UNet and BrushNet (8 heads, widths 320 to
    1280, stride-2 downsampling rounding up): the spatial self-attention
    (token-major), the text cross-attention (77 keys) and the temporal
    attention over the clip's frames. Shapes as in kernel_cases()."""
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.ops import attention as A
    cfg = default_config().diffueraser
    heads, ctx = cfg.attention_head_dim, 77
    B, T, h, w = TRAIN_CLIP
    cases = {}

    def add(route, shape):
        if route == "flash":
            _, _, Sq, Sk, D = shape
            fwd = f"flash_attn_fwd[D={D},Sq={Sq},Sk={Sk}]"
        elif route in ("tokenmajor", "packed"):
            N, S, C, H = shape
            layout = "tokenmajor" if route == "tokenmajor" else "bhsd"
            fwd = f"small_seq_attn[{layout},N={N},D={C // H},S={S}]"
        else:
            return  # the plain path: no kernel
        bwd = fwd.replace("flash_attn_fwd[", "flash_attn_bwd[").replace(
            "small_seq_attn[", "small_seq_attn_bwd[")
        cases[fwd] = (fwd, bwd, route, shape)
    for lvl, C in enumerate(cfg.block_out_channels):
        hl, wl = h, w
        for _ in range(lvl):
            hl, wl = -(-hl // 2), -(-wl // 2)
        n, d = hl * wl, C // heads
        route = A.tokenmajor_route((B * T, n, C), heads, True)
        add(route, (B * T, heads, n, n, d) if route == "flash"
            else (B * T, n, C, heads))
        route = A.attention_route((B * T, heads, n), (B * T, heads, ctx),
                                  True)
        add(route, (B * T, heads, n, ctx, d))
        route = A.tokenmajor_route((B * n, T, C), heads, True)
        add(route, (B * T, heads, T, T, d) if route == "flash"
            else (B * n, T, C, heads))
    return list(cases.values())


def backward_cases():
    """(counter key, route, shape) of each backward instance the training
    phase launches."""
    return [(bwd, route, shape) for _, bwd, route, shape in train_cases()]


def run_backward_rows(ex2_per_s: float, seed: int = 0):
    """Kernel-phase rows of the backward kernels: bf16 q, k, v and dO from
    the seed, laid out as the training step lays them out; the forward
    kernel gives O (and flash's log-sum-exp). Each of dq, dk, dv is held to
    TOL * max|plain| of attention_backward_ref in f32 on the same inputs,
    and a second launch must equal the first bitwise. Times as the forward
    rows (`timed`); the library yardstick is the backward of
    F.scaled_dot_product_attention (torch.autograd.grad over a kept graph,
    its forward not timed)."""
    import torch
    import torch.nn.functional as F
    from videovanish_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dev, bf16 = torch.device("cuda"), torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    lib_stream = torch.cuda.Stream()
    rows = []
    for key, route, shape in backward_cases():
        if route == "flash":
            B, H, Sq, Sk, D = shape
            heads = 0

            def make():  # split views of token-major projections
                return [randn(B, S, H, D).permute(0, 2, 1, 3)
                        for S in (Sq, Sk, Sk, Sq)]
            split = bhsd = (lambda t: t)
        else:
            N, S, C, H = shape
            B, Sq, Sk, D = N, S, S, C // H
            heads = H if route == "tokenmajor" else 0

            def make():
                return [randn(N, S, C) for _ in range(4)]

            def split(t):  # (N, S, C) -> its (N, H, S, D) view
                return t.view(N, S, H, D).permute(0, 2, 1, 3)
            # the wrapper's operands and gradients: token-major, or split
            bhsd = split if heads else (lambda t: t)
        scale = D ** -0.5

        def prepare(q, k, v, dout):
            """The operands as the wrapper gets them, with the forward
            kernel's output (and statistics)."""
            if not heads:
                q, k, v, dout = split(q), split(k), split(v), split(dout)
            if route == "flash":
                out, lse = A._flash_forward(q, k, v, scale, with_lse=True)
            else:
                out, lse = A._small_seq_forward(q, k, v, scale, heads), None
            return q, k, v, out, dout, lse

        def kern(q, k, v, out, dout, lse):
            if route == "flash":
                return A.flash_attention_backward(q, k, v, out, dout, lse,
                                                  scale)
            return A.small_seq_attention_backward(q, k, v, out, dout, scale,
                                                  heads)

        def sdpa(q, k, v, out, dout, lse):
            """A kept SDPA graph over q, k, v (B, H, S, D views), its forward
            run on lib_stream (where its backward then runs), and the call
            that takes its gradients."""
            leaves = [bhsd(t).detach().requires_grad_() for t in (q, k, v)]
            lib_stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(lib_stream):
                o = F.scaled_dot_product_attention(*leaves, scale=scale)
            torch.cuda.current_stream().wait_stream(lib_stream)
            g = bhsd(dout)
            return lambda: torch.autograd.grad(o, leaves, g,
                                               retain_graph=True)

        b_ms, b_by = bwd_bound(B, H, Sq, Sk, D, ex2_per_s, route == "flash")
        sets = [prepare(*make()) for _ in range(copies_past_l2(
            2 * B * H * (4 * Sq + 4 * Sk) * D))]
        ops = sets[0]
        before = A.LAUNCHES[key]
        got = kern(*ops)
        again = kern(*ops)
        torch.cuda.synchronize()
        if A.LAUNCHES[key] != before + 2:
            raise RuntimeError(f"{key}: the call did not launch its kernel")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{key}: a second launch differs bitwise")
        ref = A.attention_backward_ref(
            *(bhsd(t).float() for t in ops[:5]), scale)
        errs, limits = [], []
        for g, r in zip(got, ref):
            errs.append((bhsd(g).float() - r).abs().max().item())
            limits.append(TOL * r.abs().max().item())
        del ref, got, again
        libs = [sdpa(*s) for s in sets]
        t = timed(lambda: kern(*ops), [functools.partial(kern, *s)
                                      for s in sets], libs[0], libs,
                  lib_stream)
        plain_ms = time_ms(lambda: A.attention_backward_ref(
            *(bhsd(x).float() for x in ops[:5]), scale), min_total_ms=0,
            max_reps=2)
        err = max(e / lim for e, lim in zip(errs, limits))
        row = {"name": key, "route": "cuda",
               "source": SRC_FLASH_BWD if route == "flash" else SRC_SMALL_BWD,
               "replaces": f"{TPU_SRC}:30" if route == "flash"
               else f"{TPU_SRC}:460",
               "computes": "jax.vjp of " + ("_xla_attention" if route ==
                                            "flash" else
                                            "_packed_small_attention")
               + " (the JAX package has no backward kernel)",
               "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D},
               "launches": 0, "max_abs_err": max(errs),
               "max_abs_err_dq_dk_dv": errs, "tolerance_dq_dk_dv": limits,
               "tolerance": limits[errs.index(max(errs))],
               "err_over_limit": err, "bitwise_rerun": True,
               "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": t["library_ms"],
               "bound_share": b_ms / t["ms"],
               "library_ratio": t["library_ms"] / t["ms"],
               "device_ms": t["device_ms"],
               "library_device_ms": t["library_device_ms"],
               "device_bound_share": b_ms / t["device_ms"],
               "device_library_ratio": t["library_device_ms"] / t["device_ms"],
               "input_copies": len(sets)}
        print(f"[kernel] {key} err/limit dq,dk,dv="
              f"{','.join(f'{e:.2e}/{lim:.2e}' for e, lim in zip(errs, limits))}"
              f" ms={t['ms']:.4f} sdpa_bwd_ms={t['library_ms']:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) "
              f"bound/ms={row['bound_share']:.3f} sdpa/ms="
              f"{row['library_ratio']:.3f} | device_ms={t['device_ms']:.4f} "
              f"sdpa_bwd_device_ms={t['library_device_ms']:.4f} "
              f"bound/device_ms={row['device_bound_share']:.3f} "
              f"sdpa/device_ms={row['device_library_ratio']:.3f} "
              f"({len(sets)} input copies), rerun bitwise", flush=True)
        if not all(math.isfinite(e) and e <= lim
                   for e, lim in zip(errs, limits)):
            raise RuntimeError(f"{key}: max|kernel - plain| of dq, dk, dv "
                               f"{errs} exceeds {limits}")
        rows.append(row)
        del ops, sets, libs
        torch.cuda.empty_cache()
    return rows


def state_bytes(state, params) -> int:
    """Bytes of the trainer's state on the card: parameters, their
    gradients and AdamW's two moments."""
    n = 0
    for name in state.params:
        for k, p in state.params[name].items():
            n += p.numel() * p.element_size()
            n += state.opt_state["mu"][name][k].numel() * 4
            n += state.opt_state["nu"][name][k].numel() * 4
    return n + sum(p.grad.numel() * p.grad.element_size() for p in params
                   if p.grad is not None)


def loss_inputs(batch, t, noise):
    """The training loss's inputs, as train_step builds them: (t over the
    frames, x_t, BrushNet's sample, the text embedding over the frames, the
    drawn noise), (B*T, ...) and NCHW, f32."""
    import torch
    from videovanish_tpu_torch.models.diffueraser.scheduler import (
        NoiseSchedule,
    )
    T = batch["latents"].shape[1]

    def nchw(x):  # (B, T, h, w, C) -> (B*T, C, h, w)
        return x.flatten(0, 1).permute(0, 3, 1, 2).float().contiguous()

    t_full = t.long().repeat_interleave(T)
    eps_true = nchw(noise)
    x_t = NoiseSchedule().add_noise(nchw(batch["latents"]), eps_true, t_full)
    sample = torch.cat([x_t, nchw(batch["masked_lat"]),
                        nchw(batch["mask_lat"])], dim=1)
    txt = batch["text_emb"].float().repeat_interleave(T, dim=0)
    return t_full, x_t, sample, txt, eps_true


def one_card_loss(unet, brushnet, batch, t, noise) -> float:
    """The training loss at the modules' present parameters on one card,
    forward only (no grad), under the trainer's bf16 autocast: clip by
    clip, the mean of the clips' losses (all as large), as a step on one
    card would report it for the whole batch."""
    import torch
    T = batch["latents"].shape[1]
    losses = []
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        for b in range(batch["latents"].shape[0]):
            t_full, x_t, sample, txt, eps_true = loss_inputs(
                {k: v[b:b + 1] for k, v in batch.items()}, t[b:b + 1],
                noise[b:b + 1])
            bd, bm, bu = brushnet(sample, t_full, txt)
            eps = unet(x_t, t_full, txt, T, brushnet_down=bd,
                       brushnet_mid=bm, brushnet_up=bu)
            losses.append(torch.mean(torch.square(eps.float() - eps_true)))
            del bd, bm, bu, eps
    return float(torch.stack(losses).mean())


def reference_grads(unet, brushnet, batch, t, noise, plain: bool = True):
    """The training loss's gradient at the modules' present parameters,
    taken apart from `train_step` with the trainer's two checkpoint cuts,
    clip by clip on this card (each clip's loss over B, the gradients
    summed): `plain`, f32 with no autocast and every attention call on its
    plain path (the port's routes patched to "plain", so no kernel
    launches); else the trainer's bf16 autocast and kernels. Returns
    ({(model, name): gradient on the host}, loss, peak GiB); the modules'
    .grad are cleared."""
    import contextlib
    import torch
    from torch.utils.checkpoint import checkpoint
    from videovanish_tpu_torch.ops import attention as A

    B, T = batch["latents"].shape[:2]
    launched = sum(A.LAUNCHES.values())
    routes = A.attention_route, A.tokenmajor_route
    if plain:
        A.attention_route = A.tokenmajor_route = lambda *a, **kw: "plain"
    amp = contextlib.nullcontext() if plain \
        else torch.autocast("cuda", dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    try:
        for b in range(B):
            t_full, x_t, sample, txt, eps_true = loss_inputs(
                {k: v[b:b + 1] for k, v in batch.items()}, t[b:b + 1],
                noise[b:b + 1])

            def unet_fwd(x, bd, bm, bu):
                return unet(x, t_full, txt, T, brushnet_down=bd,
                            brushnet_mid=bm, brushnet_up=bu)

            with amp:
                bd, bm, bu = checkpoint(brushnet, sample, t_full, txt,
                                        use_reentrant=False)
                eps = checkpoint(unet_fwd, x_t, bd, bm, bu,
                                 use_reentrant=False)
            loss = torch.mean(torch.square(eps.float() - eps_true))
            (loss / B).backward()
            losses.append(loss.detach())
            del bd, bm, bu, eps, loss
    finally:
        A.attention_route, A.tokenmajor_route = routes
    if plain and sum(A.LAUNCHES.values()) != launched:
        raise RuntimeError("the plain-path gradient launched a kernel")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = {}
    for name, m in (("unet", unet), ("brushnet", brushnet)):
        for k, p in m.named_parameters():
            grads[name, k] = p.grad.cpu()
            p.grad = None
    return grads, float(torch.stack(losses).mean()), peak


def grad_agreement(params, ref, limit: float = TRAIN_GRAD_TOL,
                   what: str = "[train] gradients against f32 on the "
                               "plain path") -> dict:
    """Each parameter's gradient (`params[model][name].grad`, the trainer's
    step on the card) against `ref` ({(model, name): tensor}): the 2-norm
    of the difference over max(|ref|_2, TRAIN_GRAD_FLOOR * the largest
    |ref|_2). Prints a line that starts with `what`; raises where that
    exceeds `limit`."""
    import torch
    diff, norm = {}, {}
    for (name, k), g in ref.items():
        p = params[name][k]
        if p.grad is None:
            raise RuntimeError(f"{name}.{k}: no gradient from the step")
        gr = g.to(p.grad.device, torch.float64)
        diff[name, k] = float((p.grad.double() - gr).norm())
        norm[name, k] = float(gr.norm())
    floor = TRAIN_GRAD_FLOOR * max(norm.values())
    rel = {key: diff[key] / max(norm[key], floor) for key in ref}
    worst = sorted(rel, key=rel.get, reverse=True)
    vals = sorted(rel.values())
    out = {"limit": limit, "floor": TRAIN_GRAD_FLOOR,
           "parameters": len(rel), "median": vals[len(vals) // 2],
           "p99": vals[int(0.99 * (len(vals) - 1))], "max": vals[-1],
           "below_floor": sum(n < floor for n in norm.values()),
           # a record, not the gate: each tensor over its own norm
           "max_without_floor": max(diff[key] / norm[key] for key in ref
                                    if norm[key] > 0),
           "worst": [[".".join(key), rel[key], norm[key]]
                     for key in worst[:8]]}
    print(f"{what}: |g - g_ref| / "
          f"|g_ref| median {out['median']:.4g}, p99 {out['p99']:.4g}, max "
          f"{out['max']:.4g} (limit {limit}; {out['below_floor']} "
          f"of {len(rel)} parameters under the floor; without the floor "
          f"max {out['max_without_floor']:.4g}); worst "
          f"{json.dumps(out['worst'])}", flush=True)
    bad = [key for key in worst if rel[key] > limit]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} parameters' gradients "
                           f"differ by more than {limit}: "
                           f"{['.'.join(b) for b in bad[:8]]}")
    return out


def train_setup(seed: int = 0, clip=TRAIN_CLIP):
    """The training phase's models and batch on the card: the default
    config's UNet (motion modules) and BrushNet, seeded with init_random_
    (the same weights whatever the clip), and a batch of `clip` (B, T, h,
    w) latents with its t and noise. Returns (unet, brushnet, batch, t,
    noise)."""
    import torch
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.models.diffueraser.blocks import init_random_
    from videovanish_tpu_torch.models.diffueraser.brushnet import (
        BrushNetModel,
    )
    from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition

    cfg = default_config().diffueraser
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    with torch.device("cuda"):
        unet = UNetCondition(4, 4, cfg.block_out_channels,
                             cfg.layers_per_block, cfg.attention_head_dim,
                             cfg.cross_attention_dim)
        brushnet = BrushNetModel(9, cfg.block_out_channels,
                                 cfg.layers_per_block, cfg.attention_head_dim,
                                 cfg.cross_attention_dim)
    init_random_(unet, gen)
    init_random_(brushnet, gen)
    B, T, h, w = clip
    batch = {
        "latents": torch.randn(B, T, h, w, 4, generator=gen, device="cuda"),
        "masked_lat": torch.randn(B, T, h, w, 4, generator=gen,
                                  device="cuda"),
        "mask_lat": (torch.rand(B, T, h, w, 1, generator=gen, device="cuda")
                     > 0.5).float(),
        "text_emb": torch.randn(B, 77, cfg.cross_attention_dim,
                                generator=gen, device="cuda")}
    t = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
    noise = torch.randn(batch["latents"].shape, generator=gen, device="cuda")
    return unet, brushnet, batch, t, noise


def run_train_phase(seed: int = 0):
    """The DiffuEraser training step at full width on the card: the default
    config's UNet (motion modules) and BrushNet, seeded with init_random_,
    make_train_step with remat, one clip of TRAIN_CLIP latents; one
    warm-up step, then TRAIN_STEPS on the same batch, t and noise. Checks
    the warm-up step's gradients against `reference_grads`, finite losses,
    the last below the first, and a finite gradient for every parameter.
    Returns (launch counts of the timed steps, report)."""
    import torch
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.train import make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    unet, brushnet, batch, t, noise = train_setup(seed)
    n_unet = sum(p.numel() for p in unet.parameters())
    n_brush = sum(p.numel() for p in brushnet.parameters())
    B, T, h, w = TRAIN_CLIP
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"[train] UNet {n_unet / 1e6:.1f} M + BrushNet {n_brush / 1e6:.1f}"
          f" M parameters on the card in {setup_s:.1f} s; clip {TRAIN_CLIP} "
          f"(B, T, h, w), t={t.tolist()}, lr {TRAIN_LR}, remat", flush=True)
    t0 = time.perf_counter()
    ref, ref_loss, ref_peak = reference_grads(unet, brushnet, batch, t, noise)
    print(f"[train] f32 plain-path gradient: loss {ref_loss:.6f}, "
          f"{time.perf_counter() - t0:.1f} s, peak {ref_peak:.2f} GiB",
          flush=True)
    init_fn, step_fn = make_train_step(unet, brushnet, None,
                                       learning_rate=TRAIN_LR, remat=True)
    state = init_fn()
    torch.cuda.reset_peak_memory_stats()

    losses, secs = [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            A.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch, t=t, noise=noise)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
        print(f"[train] step {i} ({'warm-up' if i == 0 else 'timed'}): loss "
              f"{losses[-1]:.6f}, {secs[-1]:.3f} s", flush=True)
        if i == 0:  # the step's gradients at the reference's parameters
            grads = grad_agreement(state.params, ref)
            del ref
    counts = dict(A.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    params = [p for m in (unet, brushnet) for p in m.parameters()]
    nbytes = state_bytes(state, params)
    no_grad = [k for name in state.params
               for k, p in state.params[name].items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    report = {"clip_B_T_h_w": list(TRAIN_CLIP), "frames_hw": [h * 8, w * 8],
              "parameters": {"unet": n_unet, "brushnet": n_brush},
              "learning_rate": TRAIN_LR, "remat": True, "losses": losses,
              "step_seconds": secs,
              "warm_step_seconds": sum(secs[1:]) / TRAIN_STEPS,
              "peak_gib": peak / 2 ** 30, "state_bytes": nbytes,
              "setup_seconds": setup_s,
              "f32_plain_path": {"loss": ref_loss, "peak_gib": ref_peak,
                                 "loss_rel_diff": abs(losses[0] - ref_loss)
                                 / abs(ref_loss),
                                 "grad_rel_err": grads},
              "launches_per_step": {k: n / TRAIN_STEPS
                                    for k, n in sorted(counts.items())}}
    print(f"[train] warm step {report['warm_step_seconds']:.3f} s, peak "
          f"{report['peak_gib']:.2f} GiB, state {nbytes / 1e9:.2f} GB "
          f"(params, grads, 2 moments); launches per step "
          f"{json.dumps(report['launches_per_step'], sort_keys=True)}",
          flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the last loss is not below the first: {losses}")
    if no_grad:
        raise RuntimeError(f"{len(no_grad)} parameters without a finite "
                           f"gradient, e.g. {no_grad[:5]}")
    del state, step_fn, init_fn, unet, brushnet, params, batch, noise
    gc.collect()
    torch.cuda.empty_cache()
    return counts, report


def synthetic_request(T, H, W, seed):
    """T frames of a smooth moving scene, a moving rectangle mask and a
    synthetic prior, as (T, H, W, 3) / (T, H, W) uint8 arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.empty((T, H, W, 3), np.uint8)
    masks = np.zeros((T, H, W), np.uint8)
    phase = rng.uniform(0, 2 * np.pi, 3)
    for t in range(T):
        for c in range(3):
            frames[t, ..., c] = (127 + 100 * np.sin(
                xx / (37 + 11 * c) + yy / 53 + phase[c] + 0.1 * t)).astype(
                    np.uint8)
        y0, x0 = H // 3, W // 6 + (W // 2) * t // max(1, T - 1)
        frames[t, y0:y0 + H // 4, x0:x0 + W // 8] = (240, 30, 30)
        masks[t, y0:y0 + H // 4, x0:x0 + W // 8] = 255
    prior = (0.5 * frames + 0.5 * frames.mean(axis=(1, 2), keepdims=True)
             ).astype(np.uint8)
    return frames, masks, prior


def outside_feathered_mask(masks, cfg):
    """Where the feathered alpha of the (T, H, W) masks, dilated as the
    pipeline dilates them, is 0: (T, H, W) bool."""
    import torch
    from videovanish_tpu_torch.ops.edt import feather_alpha
    from videovanish_tpu_torch.ops.morphology import binarize_and_dilate
    m = binarize_and_dilate(torch.from_numpy(masks[..., None]).cuda(),
                            cfg.infill.mask_dilation_iter)
    return (feather_alpha(m > 0, float(cfg.infill.feather_px)) == 0) \
        .cpu().numpy()


def check_request(out, frames, masks, latents, cfg):
    """The output's shape, finite latents before decode, and pixels where
    the feathered alpha is 0 equal to the input; returns (latents, the mean
    |change| inside)."""
    import numpy as np
    import torch

    out = np.stack(out)
    if out.shape != frames.shape or out.dtype != np.uint8:
        raise RuntimeError(f"output {out.shape} {out.dtype}, expected "
                           f"{frames.shape} uint8")
    if not latents or not all(bool(torch.isfinite(z).all())
                              for z in latents):
        raise RuntimeError("non-finite latents before decode")
    outside = outside_feathered_mask(masks, cfg)
    if not np.array_equal(out[outside], frames[outside]):
        raise RuntimeError("pixels outside the feathered mask changed")
    diff = np.abs(out.astype(np.int16) - frames.astype(np.int16))[~outside]
    return torch.cat(latents), float(diff.mean())


def run_main_path(seed: int = 0):
    """Two requests through run_infill_on_frames on the card; returns
    (launch counts summed over both, launch counts of request 0, report)."""
    import torch
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.pipeline import infill

    cfg = default_config()
    infill.set_config(cfg)
    t0 = time.perf_counter()
    model = infill.get_model("2-Step", device="cuda")
    torch.cuda.synchronize()
    print(f"[main] model built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    latents = []
    model.latent_hook = latents.append
    requests = [(22, 720, 1280), (22, 512, 512)]
    report, per_request = [], []
    for i, (T, H, W) in enumerate(requests):
        frames, masks, prior = synthetic_request(T, H, W, seed + i)
        latents.clear()
        A.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infill.run_infill_on_frames(
            list(frames), list(masks), propainer_frames=list(prior),
            device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_request.append(dict(A.LAUNCHES))
        z, change = check_request(out, frames, masks, latents, cfg)
        h, w = z.shape[-2] * 8, z.shape[-1] * 8
        report.append({"frames": [T, H, W], "inference_hw": [h, w],
                       "seconds": secs, "peak_gib": peak,
                       "latent_absmax": float(z.abs().max()),
                       "inside_mean_abs_change": change})
        print(f"[main] request {i}: {T}x{H}x{W} -> {h}x{w} inference, "
              f"{secs:.2f} s, peak {peak:.2f} GiB", flush=True)
    counts = {k: sum(c.get(k, 0) for c in per_request)
              for k in set().union(*per_request)}
    print(f"[main] launches {json.dumps(counts, sort_keys=True)}", flush=True)
    return counts, per_request[0], report


PRIOR_STAGES = ("raft", "flow_completion", "propagation", "generator")


def prior_stage_split(pp, frames, dilated, pcfg):
    """One more run of the prior with a stage hook that synchronizes the
    card: seconds per stage (RAFT includes the upload and the resize to the
    internal size, the generator the windows' blend), and the names of the
    stages whose outputs (flows, propagated frames, the float prior) are
    not finite."""
    import torch
    secs = dict.fromkeys(PRIOR_STAGES, 0.0)
    bad = []
    mark = [0.0]

    def hook(name, *outputs):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name] += now - mark[0]
        if not all(bool(torch.isfinite(x).all()) for x in outputs):
            bad.append(name)
        mark[0] = time.perf_counter()

    pp.stage_hook = hook
    try:
        torch.cuda.synchronize()
        mark[0] = time.perf_counter()
        pp.forward(frames, dilated, ref_stride=pcfg.ref_stride,
                   neighbor_length=pcfg.neighbor_length,
                   subvideo_length=pcfg.subvideo_length, return_device=True)
    finally:
        pp.stage_hook = None
    return secs, bad


def run_prior_request(launches_0, seed: int = 0):
    """Request 2: 22 frames at 1280x720 with the ProPainter prior computed
    on the card at the published widths; returns (launch counts, report)."""
    import torch
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.models.propainter.model import Propainter
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.ops.resize import (
        host_resize_bilinear_u8, host_resize_nearest_2d, plan_long_side,
    )
    from videovanish_tpu_torch.pipeline import infill

    cfg = default_config()
    pcfg = cfg.propainter
    T, H, W = 22, 720, 1280
    frames, masks, _ = synthetic_request(T, H, W, seed + 2)
    t0 = time.perf_counter()
    pp = infill.get_propainter("cuda")
    torch.cuda.synchronize()
    print(f"[prior] Propainter built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # compute_prior alone, twice: the first call pays cuDNN's plan search
    prior_secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dilated, prior = infill.compute_prior(
            list(frames), list(masks), cfg.infill.mask_dilation_iter,
            device="cuda")
        torch.cuda.synchronize()
        prior_secs.append(time.perf_counter() - t0)
    h, w = plan_long_side(H, W, pcfg.max_img_size, 8)
    if tuple(prior.shape) != (T, h, w, 3) or prior.dtype != torch.uint8:
        raise RuntimeError(f"prior {tuple(prior.shape)} {prior.dtype}, "
                           f"expected ({T}, {h}, {w}, 3) uint8")
    hole = host_resize_nearest_2d(dilated, h, w) > 0
    small = host_resize_bilinear_u8(torch.from_numpy(frames).cuda(), h, w)
    if not torch.equal(prior[~hole], small[~hole]):
        raise RuntimeError("the prior differs from the resized input "
                           "outside the resized mask")
    split, bad = prior_stage_split(pp, frames, dilated, pcfg)
    if bad:
        raise RuntimeError(f"non-finite outputs of the prior's stages {bad}")
    print(f"[prior] compute_prior {T}x{H}x{W} -> {h}x{w}: "
          f"{', '.join(f'{t:.3f}' for t in prior_secs)} s; stages (synced) "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()),
          flush=True)

    model = infill.get_model("2-Step", device="cuda")
    latents = []
    model.latent_hook = latents.append
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = infill.run_infill_on_frames(list(frames), list(masks),
                                      propainer_frames=None, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(A.LAUNCHES)
    model.latent_hook = None
    z, change = check_request(out, frames, masks, latents, cfg)
    missing = sorted(k for k, n in launches_0.items()
                     if n and not counts.get(k))
    if missing:
        raise RuntimeError(f"kernel instances of request 0 not launched "
                           f"with the prior computed: {missing}")
    print(f"[prior] request 2: {T}x{H}x{W}, prior computed, {secs:.2f} s, "
          f"peak {peak:.2f} GiB", flush=True)

    # bf16 drift: the same weights run in f32
    pp32 = Propainter(config=pcfg, device="cuda", compute_dtype=torch.float32,
                      params={n: {k: v.float() for k, v in
                                  getattr(pp, n).state_dict().items()}
                              for n in ("raft", "flow_comp", "generator")})
    prior32 = pp32.forward(frames, dilated, ref_stride=pcfg.ref_stride,
                           neighbor_length=pcfg.neighbor_length,
                           subvideo_length=pcfg.subvideo_length,
                           return_device=True)
    del pp32
    d = (prior.float() - prior32.float())[hole]
    mse = float((d ** 2).mean())
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    drift = {"psnr_db_inside": psnr, "max_abs_inside": float(d.abs().max())}
    print(f"[prior] bf16 prior against f32, inside the mask: "
          f"{psnr:.2f} dB, max |diff| {drift['max_abs_inside']:.0f}",
          flush=True)
    torch.cuda.empty_cache()
    return counts, {"frames": [T, H, W], "prior_hw": [h, w],
                    "inference_hw": [z.shape[-2] * 8, z.shape[-1] * 8],
                    "prior_seconds": prior_secs, "prior_stage_seconds": split,
                    "seconds": secs, "peak_gib": peak,
                    "latent_absmax": float(z.abs().max()),
                    "inside_mean_abs_change": change,
                    "bf16_prior_drift": drift}


# the mesh phase: run_infill_on_frames through the port's ("data", "model")
# mesh over every card, against the single-device run of the same request
MESH_REQUEST = (24, 720, 1280)  # 24 divides every data axis up to 4, 6, 8
# the ring at the temporal shapes of that request, 544x960 inference: level
# 0's (B*S, H, T, D) with T the whole 24-frame clip, f32
RING_SHAPE = (8160, 8, 24, 40)
RING_TOL = 2e-5
RING_REPS = 20
# above one rank: the JAX dry run's bounds inside the feathered mask (the
# ring reorders f32 sums); outside it every pixel is the input's
MESH_MEAN_TOL, MESH_MAX_TOL = 2.0, 64


# the mesh phase's training part: the one-card step (mesh=None) on every
# card at once, the baseline in the same run; at one card the same step on
# a 1x1 mesh, bitwise equal to it; on N cards (data N, model 1) with N
# clips of TRAIN_CLIP, (data 1, model N) with one, and (data 1, model N)
# with one clip of 64x64 latents, which do not fit one card
MESH_TRAIN_64 = (1, 22, 64, 64)
# each loss of (data 1, model N) against the baseline's on the same draws,
# and a first loss against one card's, relative: bf16 products summed in
# another order (four H100s: at most 9.7e-05 over the five losses of
# (1, 4), 8.8e-05 for the 64x64 first loss; PERF.md)
MESH_LOSS_TOL = 5e-4
# (data N, model 1)'s first gradient, averaged over "data", against one
# card's on the same clips (each clip's gradient over N, summed), per
# parameter as grad_agreement holds it: only the order of the sum differs
MESH_GRAD_TOL = 1e-3


def train_steps(step_fn, state, batch, t, noise, sync, first=None) -> tuple:
    """A warm-up step and TRAIN_STEPS more on the same batch, t and noise,
    each timed on the host clock between `sync`s; `first(state)` runs after
    the warm-up step. Returns (state, losses, seconds, launch counts of the
    steps after the warm-up)."""
    from videovanish_tpu_torch.ops import attention as A
    losses, secs = [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            if first is not None:
                first(state)
            A.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch, t=t, noise=noise)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    return state, losses, secs, dict(A.LAUNCHES)


def mesh_train_case(seed: int, clip, model, hold=None,
                    keep: bool = False) -> dict:
    """The training phase's step through make_train_step on a mesh over
    every rank with a "model" axis of `model` (model None: mesh=None, each
    rank on its own card), on a batch of `clip` latents (the whole batch on
    every rank): a warm-up and TRAIN_STEPS steps. `hold` holds the first
    step to one card on the same draws: "forward", its loss to
    one_card_loss's; "gradient", its loss and every parameter's gradient to
    reference_grads' on the kernels (MESH_GRAD_TOL). `keep` returns the
    parameters after the last step on the host, under "params". The 64x64
    clip may run out of memory, which it reports (every rank runs out at
    the same allocation: their memory is the same)."""
    import torch
    import torch.distributed as dist
    from videovanish_tpu_torch.core.mesh import make_mesh
    from videovanish_tpu_torch.train import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    mesh = None if model is None else make_mesh("cuda", model_parallel=model)
    resident = torch.cuda.memory_allocated()
    unet, brushnet, batch, t, noise = train_setup(seed, clip)
    ref_loss = grads = None
    if hold == "forward":
        ref_loss = one_card_loss(unet, brushnet, batch, t, noise)
    elif hold == "gradient":
        grads, ref_loss, _ = reference_grads(unet, brushnet, batch, t, noise,
                                             plain=False)
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn = make_train_step(unet, brushnet, mesh,
                                       learning_rate=TRAIN_LR, remat=True)
    state = init_fn()
    out = {"mesh": None if mesh is None
           else dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "clip_B_T_h_w": list(clip), "fits": True}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    def first(state):
        nonlocal grads
        if grads is not None:
            out["grad_rel_err"] = grad_agreement(
                state.params, grads, MESH_GRAD_TOL,
                f"[mesh] {out['mesh']}: the first step's gradients against "
                f"one card's on the same clips")
            grads = None
    try:
        state, losses, secs, counts = train_steps(step_fn, state, batch, t,
                                                  noise, sync, first)
    except torch.cuda.OutOfMemoryError as e:
        if tuple(clip) != MESH_TRAIN_64:
            raise
        out["fits"] = False
        out["out_of_memory"] = str(e).splitlines()[0]
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (torch.cuda.max_memory_allocated(),
                                   resident))
    out["peak_gib_per_rank"] = [p / 2 ** 30 for p, _ in peaks]
    out["peak_above_resident_gib_per_rank"] = [(p - r) / 2 ** 30
                                               for p, r in peaks]
    if out["fits"]:
        out.update(losses=losses, step_seconds=secs,
                   warm_step_seconds=sum(secs[1:]) / TRAIN_STEPS,
                   launches_per_step={k: n / TRAIN_STEPS
                                      for k, n in sorted(counts.items())})
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"mesh training losses not finite: {losses}")
        if keep:
            out["params"] = {name: {k: p.detach().cpu()
                                    for k, p in tree.items()}
                             for name, tree in state.params.items()}
    if ref_loss is not None:
        out["one_card_first_loss"] = ref_loss
        if out["fits"]:
            rel = abs(losses[0] - ref_loss) / abs(ref_loss)
            out["first_loss_rel_diff"] = rel
            if not rel <= MESH_LOSS_TOL:
                raise RuntimeError(f"mesh {out['mesh']} clip {clip}: first "
                                   f"loss {losses[0]} against one card's "
                                   f"{ref_loss} (limit {MESH_LOSS_TOL})")
    del state, step_fn, init_fn, unet, brushnet, batch, t, noise
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_train_rank(seed: int) -> dict:
    """The mesh phase's training part on this rank: the one-card step
    (mesh=None) on every card at once, the baseline; at world 1 the same
    step on a 1x1 mesh, which must equal it bitwise in every loss and
    every parameter after the last step; at world N the three cases of
    MESH_TRAIN_64's comment, (data 1, model N) held to the baseline in
    every loss (MESH_LOSS_TOL). Returns {case: mesh_train_case's
    report}."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    one = mesh_train_case(seed, TRAIN_CLIP, None, keep=world == 1)
    if world == 1:
        mesh = mesh_train_case(seed, TRAIN_CLIP, 1, keep=True)
        ref, got = one.pop("params"), mesh.pop("params")
        differ = [f"{name}.{k}" for name in ref for k, p in ref[name].items()
                  if not torch.equal(got[name][k], p)]
        mesh["bitwise_losses"] = mesh["losses"] == one["losses"]
        mesh["bitwise_params"] = not differ
        if differ or not mesh["bitwise_losses"]:
            raise RuntimeError(
                f"the 1x1 mesh's training differs from the one-card run: "
                f"losses {mesh['losses']} against {one['losses']}, "
                f"{len(differ)} parameters differ, e.g. {differ[:5]}")
        return {"one_card": one, "mesh_1x1": mesh}
    out = {"one_card": one,
           "data": mesh_train_case(seed, (world,) + TRAIN_CLIP[1:], 1,
                                   hold="gradient"),
           "model": mesh_train_case(seed, TRAIN_CLIP, world),
           "model_64x64": mesh_train_case(seed, MESH_TRAIN_64, world,
                                          hold="forward")}
    split = out["model"]
    split["loss_rel_diff"] = [abs(a - b) / abs(b) for a, b in
                              zip(split["losses"], one["losses"])]
    if not max(split["loss_rel_diff"]) <= MESH_LOSS_TOL:
        raise RuntimeError(f"(data 1, model {world}): losses "
                           f"{split['losses']} against one card's "
                           f"{one['losses']} (limit {MESH_LOSS_TOL})")
    return out


def mesh_rank(seed: int = 0) -> dict:
    """One rank of the mesh phase, in an initialized NCCL world: the
    request on one device, twice, then through a mesh over every rank,
    twice (the second of each pair timed warm, the launch counts read
    around the mesh's second run), held against each other; then the ring
    on the card against the plain f32 attention. Returns the report; its
    "launches" are this rank's."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.core.mesh import DATA_AXIS, make_mesh
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.parallel import ring_attention
    from videovanish_tpu_torch.pipeline import infill

    cfg = default_config()
    T, H, W = MESH_REQUEST
    frames, masks, _ = synthetic_request(T, H, W, seed + 5)
    world = dist.get_world_size()
    latents = []

    def run():
        infill.get_model("2-Step", "cuda").latent_hook = latents.append
        latents.clear()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = infill.run_infill_on_frames(
            list(frames), list(masks), propainer_frames=None, device="cuda")
        torch.cuda.synchronize()
        return np.stack(out), time.perf_counter() - t0

    # one device: a cold run (cuDNN's plan searches), then the warm one
    infill.set_config(cfg)
    infill.set_mesh(None)
    run()
    torch.cuda.reset_peak_memory_stats()
    single, single_s = run()
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the mesh: the same weights (the same seed), cold, then the warm run
    # whose kernel launches are counted
    mesh = make_mesh("cuda")
    infill.set_mesh(mesh)
    run()
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, mesh_s = run()
    counts = dict(A.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = dict(infill.video_inpainting_sd.window_split)
    dp = mesh[DATA_AXIS].size()
    if (dp == 1 and split["sharded"]) or (dp > 1 and split["whole"]):
        raise RuntimeError(f"windows {split} on a data axis of {dp}: a "
                           f"window shards exactly when the axis divides "
                           f"it, and the clip length is rounded up to it")
    check_request(list(out), frames, masks, latents, cfg)
    inside = ~outside_feathered_mask(masks, cfg)
    d = np.abs(out.astype(np.int16) - single.astype(np.int16))
    if d[~inside].max(initial=0) > 0:
        raise RuntimeError("mesh run differs from the single-device run "
                           "outside the feathered mask")
    in_mean, in_max = float(d[inside].mean()), int(d[inside].max())
    if in_mean > MESH_MEAN_TOL or in_max > MESH_MAX_TOL:
        raise RuntimeError(f"mesh run against the single-device run inside "
                           f"the feathered mask: mean {in_mean:.3f} "
                           f"(limit {MESH_MEAN_TOL}), max {in_max} "
                           f"(limit {MESH_MAX_TOL})")

    # the ring on the card over the mesh's data group: every rank draws the
    # same q, k, v and takes its block of the T axis
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    group = mesh.get_group(DATA_AXIS)
    scale = RING_SHAPE[-1] ** -0.5
    i, t = mesh.get_local_rank(DATA_AXIS), RING_SHAPE[2] // dp
    ql, kl, vl = (x[:, :, i * t:(i + 1) * t].contiguous() for x in (q, k, v))
    got = ring_attention(ql, kl, vl, group, scale)
    ref = A.plain_attention(q, k, v, scale)[:, :, i * t:(i + 1) * t]
    ring_err = float((got - ref).abs().max())
    if not ring_err <= RING_TOL:
        raise RuntimeError(f"ring attention on the card: max |err| "
                           f"{ring_err:.3g} (limit {RING_TOL})")
    # a fixed count of ring calls, the same on every rank (each call's
    # sends pair with the next rank's receives)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dist.barrier()
    start.record()
    for _ in range(RING_REPS):
        ring_attention(ql, kl, vl, group, scale)
    end.record()
    torch.cuda.synchronize()
    ring_ms = start.elapsed_time(end) / RING_REPS
    plain_ms = time_ms(lambda: A.plain_attention(q, k, v, scale))
    del q, k, v, ql, kl, vl, got, ref
    nccl = torch.cuda.nccl.version()
    infill.get_model("2-Step", "cuda").latent_hook = None
    infill.set_config(cfg)  # later phases decide their own mesh (none)
    latents.clear()
    training = mesh_train_rank(seed)
    torch.cuda.empty_cache()
    return {"world_size": world, "mesh": dict(zip(mesh.mesh_dim_names,
                                                  mesh.shape)),
            "frames": [T, H, W], "windows": split,
            "single_seconds": single_s, "mesh_seconds": mesh_s,
            "single_peak_gib": single_peak, "peak_gib": peak,
            "bitwise": bool((d == 0).all()),
            "inside_mean_abs_diff": in_mean, "inside_max_abs_diff": in_max,
            "nccl": ".".join(map(str, nccl)) if isinstance(nccl, tuple)
            else str(nccl),
            "ring": {"shape": list(RING_SHAPE), "max_abs_err": ring_err,
                     "ms": ring_ms, "plain_ms": plain_ms},
            "training": training,
            "launches": counts}


def _mesh_rank_entry(rank, world, port, seed, out_path):
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    # a collective that one rank never joins (say, one rank alone out of
    # memory) fails the phase in minutes instead of holding the cards
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(seconds=300))
    try:
        report = mesh_rank(seed)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)


def run_mesh_phase(seed: int = 0):
    """The mesh phase at world size torch.cuda.device_count(): in this
    process over a one-rank NCCL world on a local store at 1, one spawned
    rank a card above. Returns (rank 0's launch counts of the mesh run,
    report)."""
    import socket
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    if world == 1:
        dist.init_process_group("nccl", store=dist.HashStore(),
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            report = mesh_rank(seed)
        finally:
            dist.destroy_process_group()
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out_path = os.path.join("build", "mesh_phase.json")
        os.makedirs("build", exist_ok=True)
        mp.start_processes(_mesh_rank_entry,
                           args=(world, port, seed, out_path),
                           nprocs=world, start_method="spawn")
        with open(out_path) as f:
            report = json.load(f)
    counts = report.pop("launches")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[mesh] world size {report['world_size']}, mesh "
          f"{report['mesh']}, NCCL {report['nccl']}; "
          f"{'x'.join(map(str, report['frames']))} with the prior computed: "
          f"windows sharded {report['windows']['sharded']}, run whole "
          f"{report['windows']['whole']}; warm wall mesh "
          f"{report['mesh_seconds']:.3f} s against one device "
          f"{report['single_seconds']:.3f} s; peak "
          f"{report['peak_gib']:.2f} GiB (one device "
          f"{report['single_peak_gib']:.2f}); "
          f"{'bitwise equal' if report['bitwise'] else 'not bitwise'} to "
          f"one device (inside the feathered mask mean |diff| "
          f"{report['inside_mean_abs_diff']:.4f}, max "
          f"{report['inside_max_abs_diff']}); ring {RING_SHAPE} f32 max "
          f"|err| {report['ring']['max_abs_err']:.3g} (limit {RING_TOL}), "
          f"{report['ring']['ms']:.3f} ms against plain "
          f"{report['ring']['plain_ms']:.3f} ms; phase "
          f"{report['phase_s']:.1f} s", flush=True)
    for case, r in report["training"].items():
        line = (f"[mesh] training {case}: mesh "
                f"{r['mesh'] or 'none (each rank on its own card)'}, clip "
                f"{tuple(r['clip_B_T_h_w'])}, ")
        if r["fits"]:
            line += (f"warm step {r['warm_step_seconds']:.3f} s, losses "
                     f"{r['losses']}, ")
        else:
            line += f"does not fit ({r['out_of_memory']}), "
        line += (f"peak per rank {[round(p, 2) for p in r['peak_gib_per_rank']]}"
                 f" GiB ({[round(p, 2) for p in r['peak_above_resident_gib_per_rank']]}"
                 f" above what was resident)")
        if "bitwise_params" in r:
            line += (f"; bitwise equal to the one-card run in every loss and "
                     f"parameter: {r['bitwise_losses'] and r['bitwise_params']}")
        if "first_loss_rel_diff" in r:
            line += (f"; first loss against one card's "
                     f"{r['one_card_first_loss']:.6f}: relative "
                     f"{r['first_loss_rel_diff']:.3g}")
        if "loss_rel_diff" in r:
            line += (f"; every loss against the one-card step's: relative "
                     f"max {max(r['loss_rel_diff']):.3g}")
        if "grad_rel_err" in r:
            line += (f"; first gradients against one card's: max "
                     f"{r['grad_rel_err']['max']:.3g}")
        print(line, flush=True)
    return counts, report


SAM2_STAGES = ("encode", "decode", "memory_encode")


def sam2_annotations(H: int, W: int):
    """Object 1: a positive click on the moving rectangle of
    synthetic_request's frame 0 (normalized coordinates) and a negative
    click on frame 8; object 2: a box on frame 0 (pixel coordinates)."""
    cx, cy = (W // 6 + W // 16) / W, (H // 3 + H // 8) / H
    return {"keyframes": [
        {"frame_idx": 0, "pos_clicks": [{"x": cx, "y": cy, "obj": 1}],
         "rects": [{"x": int(0.6 * W), "y": int(0.1 * H), "w": W // 5,
                    "h": H // 4, "obj": 2}]},
        {"frame_idx": 8, "neg_clicks": [{"x": 0.9, "y": 0.85, "obj": 1}]},
    ]}


def sam2_stage_split(pred, run):
    """run() once more with a stage hook that synchronizes the card:
    seconds per stage ("encode": the encoder on a chunk of frames, with the
    host's I420 conversion and upload; "decode": memory attention and the
    mask decoder; "memory_encode": the memory encoder; each with the host
    work since the stage before), the whole call's seconds, and the names
    of the stages whose outputs were not finite."""
    import torch
    secs = dict.fromkeys(SAM2_STAGES, 0.0)
    bad = set()
    mark = [0.0]

    def hook(name, *outputs):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name] += now - mark[0]
        if not all(bool(torch.isfinite(x).all()) for x in outputs):
            bad.add(name)
        mark[0] = time.perf_counter()

    pred.stage_hook = hook
    try:
        torch.cuda.synchronize()
        t0 = mark[0] = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        pred.stage_hook = None
    return secs, total, sorted(bad)


def check_masks(out, T, H, W) -> None:
    """T (H, W, 3) uint8 mask frames colored black or as objects 1 and
    2."""
    import numpy as np
    from videovanish_tpu_torch.pipeline.colors import color_for_obj
    palette = {(0, 0, 0), color_for_obj(1), color_for_obj(2)}
    if len(out) != T or any(o.shape != (H, W, 3) or o.dtype != np.uint8
                            for o in out):
        raise RuntimeError(f"run_sam2_on_frames: expected {T} ({H}, {W}, 3) "
                           f"uint8 frames")
    packed = {(c >> 16, (c >> 8) & 255, c & 255) for o in out
              for c in np.unique((o[..., 0].astype(np.int32) << 16)
                                 | (o[..., 1].astype(np.int32) << 8)
                                 | o[..., 2])}
    colors = {tuple(int(v) for v in c) for c in packed}
    if not colors <= palette:
        raise RuntimeError(f"mask colors outside black and the two objects' "
                           f"colors: {sorted(colors - palette)}")


def run_sam2_request(seed: int = 0):
    """Request 3: run_sam2_on_frames on 24 frames at 1280x720 with the
    default Sam2Config (Hiera-L, 1024x1024 input) and seeded random
    weights, two objects (a click and a box on frame 0, a negative click on
    frame 8). Runs it twice (cold, warm) and checks the outputs, then once
    with a stage split, and records the bf16 logits' drift from the same
    weights in f32 (on the CPU) on the prompt frame. Returns (launch counts
    of the cold run, report)."""
    import numpy as np
    import torch
    from videovanish_tpu_torch.models.sam2.predictor import (
        Sam2VideoPredictor,
    )
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.pipeline import masker
    from videovanish_tpu_torch.pipeline.colors import color_for_obj

    T, H, W = 24, 720, 1280
    frames = list(synthetic_request(T, H, W, seed + 3)[0])
    ann = sam2_annotations(H, W)
    t0 = time.perf_counter()
    pred = masker._get_predictor("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[sam2] predictor built on the card in {build_s:.1f} s",
          flush=True)

    # what the earlier phases leave on the card (the infill models): the
    # request's peak counts it
    resident = torch.cuda.memory_allocated() / 2 ** 30
    runs = []
    for _ in range(2):
        marks = {}

        def prog(pct, status="", **_):
            marks[pct] = time.perf_counter()
        A.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = masker.run_sam2_on_frames(frames, ann, device="cuda", prog=prog)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0, "out": out,
                     "launches": dict(A.LAUNCHES),
                     "propagation_s": marks[80] - marks[45],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    out = runs[0]["out"]
    check_masks(out, T, H, W)
    if not all(np.array_equal(a, b) for a, b in zip(out, runs[1]["out"])):
        raise RuntimeError("a second run of the request differs from the "
                           "first")
    if runs[0]["launches"] != runs[1]["launches"]:
        raise RuntimeError("the two runs launched different kernels")
    cover = {obj: float(np.mean([(o == color_for_obj(obj)).all(-1).mean()
                                 for o in out])) for obj in (1, 2)}

    split, split_total, bad = sam2_stage_split(
        pred, lambda: masker.run_sam2_on_frames(frames, ann, device="cuda"))
    if bad:
        raise RuntimeError(f"non-finite outputs of the SAM2 stages {bad}")
    warm = runs[1]
    print(f"[sam2] request 3: {T}x{H}x{W}, 2 objects: cold "
          f"{runs[0]['seconds']:.3f} s, warm {warm['seconds']:.3f} s, "
          f"propagation {T / warm['propagation_s']:.2f} frames/s, peak "
          f"{warm['peak_gib']:.2f} GiB ({resident:.2f} GiB resident before "
          f"it); mask cover obj 1 {cover[1]:.4f}, "
          f"obj 2 {cover[2]:.4f}", flush=True)
    print(f"[sam2] stages (synced, {split_total:.3f} s in all): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()),
          flush=True)

    # bf16 drift: the prompt frame's logits against the same (bf16-rounded)
    # weights in f32 on the CPU
    clicks = ann["keyframes"][0]
    pt = np.array([[clicks["pos_clicks"][0]["x"] * W,
                    clicks["pos_clicks"][0]["y"] * H]], np.float32)
    r = clicks["rects"][0]
    box = np.array([r["x"], r["y"], r["x"] + r["w"], r["y"] + r["h"]],
                   np.float32)

    def prompt_logits(p):
        state = p.init_state(video_path=frames)
        p.add_new_points_or_box(state, 0, 1, points=pt,
                                labels=np.array([1], np.int32))
        return p.add_new_points_or_box(state, 0, 2, box=box)[2]
    got = prompt_logits(pred)
    t0 = time.perf_counter()
    cpu = Sam2VideoPredictor(pred.cfg, device="cpu", params={
        k: v.float().cpu() for k, v in pred.model.state_dict().items()})
    ref = prompt_logits(cpu)
    del cpu
    top = float(np.abs(ref).max())
    sure = np.abs(ref) > 1e-3 * top
    drift = {"max_abs": float(np.abs(got - ref).max()), "max_abs_f32": top,
             "sign_agreement": float(((got > 0) == (ref > 0))[sure].mean()),
             "cpu_f32_seconds": time.perf_counter() - t0}
    print(f"[sam2] bf16 logits against f32 on the prompt frame: max |diff| "
          f"{drift['max_abs']:.4g} of max |f32| {top:.4g}, sign agreement "
          f"{drift['sign_agreement']:.5f} where |f32| > 1e-3 max", flush=True)
    torch.cuda.empty_cache()
    return runs[0]["launches"], {
        "frames": [T, H, W], "objects": 2, "build_seconds": build_s,
        "seconds_cold": runs[0]["seconds"], "seconds": warm["seconds"],
        "propagation_fps": T / warm["propagation_s"],
        "stage_seconds": split, "stage_split_total_seconds": split_total,
        "peak_gib": warm["peak_gib"], "resident_before_gib": resident,
        "mask_cover": cover,
        "bf16_logit_drift": drift}


FPS = 24.0
# the files phase's limits on the chunked file against the single pass,
# inside the feathered mask (tests/test_torch_infill.py's PSNR bound)
PSNR_INSIDE_MIN = 45.0
MAX_ABS_INSIDE = 32


def stage_split(stages) -> dict:
    """{stage: {"count", "seconds"}} of collect_stages records."""
    out = {}
    for name, secs, _ in stages:
        rec = out.setdefault(name, {"count": 0, "seconds": 0.0})
        rec["count"] += 1
        rec["seconds"] += secs
    return out


def run_files_phase(launches_0, seed: int = 0):
    """Files in, files out, through the port's CLIs at the default config:
    an 88-frame 1280x720 color video and its mask video written by the
    port's writer and read back; the sam2_masker CLI on the first 24
    frames; the diffuerase CLI chunked (two chunks, (0, 48) and (40, 88))
    and in one pass; the compare CLI between the two; a chunked job
    cancelled after chunk 0 and resumed through the CLI. Returns (launch
    counts of the chunked run, report). The files are deleted at the
    end."""
    import contextlib
    import importlib.util
    import io as stdio

    import numpy as np
    import torch
    from videovanish_tpu_torch.cli import compare, diffuerase, sam2_masker
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.core.prog import CancelledError
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.pipeline import infill, masker
    from videovanish_tpu_torch.pipeline.chunking import (
        _chunk_plan, vanish_video_chunked,
    )
    from videovanish_tpu_torch.utils.observability import collect_stages
    from videovanish_tpu_torch.video import io as vio

    cfg = default_config()
    if infill._get_config() != cfg or os.environ.get("VV_PLATFORM") == "cpu":
        raise RuntimeError("the files phase runs the default config on the "
                           "card")
    t_phase = time.perf_counter()
    tmp = os.path.join("build", "files_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        T, H, W = 88, 720, 1280
        plan = _chunk_plan(T, cfg.chunking.chunk_frames,
                           cfg.chunking.overlap_frames)
        if plan != [(0, 48), (40, 88)]:
            raise RuntimeError(f"chunk plan {plan}")
        frames, masks, _ = synthetic_request(T, H, W, seed + 7)
        masks3 = np.repeat(masks[..., None], 3, axis=-1)
        color = os.path.join(tmp, "color.mkv")
        mask = os.path.join(tmp, "mask.mkv")
        probe = {"codec": vio.codec_info(),
                 "ffmpeg_binary": shutil.which("ffmpeg"),
                 "pyav": importlib.util.find_spec("av") is not None,
                 "torchvision": importlib.util.find_spec("torchvision")
                 is not None}
        print(f"[files] codec: OpenCV {probe['codec']['cv2']}, "
              + "; ".join(probe["codec"]["video_io"][:4])
              + f"; ffmpeg binary {probe['ffmpeg_binary']}, PyAV "
              f"{probe['pyav']}, torchvision {probe['torchvision']}",
              flush=True)

        # 1. the port's writer, read back
        t0 = time.perf_counter()
        vio.write_video_frames_to_path(color, list(frames), FPS, H, W)
        vio.write_video_frames_to_path(mask, list(masks3), FPS, H, W)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_c, fps_c = vio.load_video_frames_from_path(color)
        got_m, fps_m = vio.load_video_frames_from_path(mask)
        read_s = time.perf_counter() - t0
        if not (np.array_equal(np.stack(got_c), frames)
                and np.array_equal(np.stack(got_m), masks3)):
            raise RuntimeError("the written videos do not read back bitwise")
        if (fps_c, fps_m) != (FPS, FPS) or \
                {vio.probe_video(color), vio.probe_video(mask)} != \
                {(T, FPS, H, W)}:
            raise RuntimeError("fps or probe_video differs from what was "
                               "written")
        del got_c, got_m
        mb = (os.path.getsize(color) + os.path.getsize(mask)) / 2 ** 20
        print(f"[files] wrote 2 x {T}x{H}x{W} FFV1 ({mb:.1f} MiB) in "
              f"{write_s:.2f} s, read back bitwise in {read_s:.2f} s",
              flush=True)

        # 2. sam2_masker on the first 24 frames
        ann = sam2_annotations(H, W)
        ann_path = os.path.join(tmp, "annotations.json")
        with open(ann_path, "w") as f:
            json.dump(ann, f)
        sam_out = os.path.join(tmp, "sam2_mask.mkv")
        t0 = time.perf_counter()
        sam2_masker.main(["--color_video", color, "--annotations", ann_path,
                          "--max_frames", "24", "--out", sam_out])
        sam_s = time.perf_counter() - t0
        want = masker.run_sam2_on_frames(list(frames[:24]), ann,
                                         device="cuda")
        got, _ = vio.load_video_frames_from_path(sam_out)
        check_masks(got, 24, H, W)
        if not np.array_equal(np.stack(got), np.stack(want)):
            raise RuntimeError("the sam2_masker CLI's file differs from "
                               "run_sam2_on_frames")
        print(f"[files] sam2_masker CLI, 24 frames: {sam_s:.2f} s, file "
              f"equal to run_sam2_on_frames", flush=True)

        # 3. diffuerase chunked and in one pass
        runs, stage_lists = {}, {}

        def run_cli(name, chunked):
            out = os.path.join(tmp, name + ".mkv")
            stages = []
            A.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with collect_stages(stages):
                diffuerase.main(["--color_video", color, "--mask_video",
                                 mask, "--out", out, "--chunked", chunked])
            torch.cuda.synchronize()
            runs[name] = {
                "seconds": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "stage_split": stage_split(stages)}
            stage_lists[name] = stages
            got, fps = vio.load_video_frames_from_path(out)
            if fps != FPS:
                raise RuntimeError(f"{name}: fps {fps}")
            return np.stack(got)

        chunked = run_cli("chunked", "on")
        counts = dict(A.LAUNCHES)
        single = run_cli("single", "off")
        missing = sorted(k for k, n in launches_0.items()
                         if n and not counts.get(k))
        if missing:
            raise RuntimeError(f"kernel instances of the 720p request not "
                               f"launched by the chunked CLI run: {missing}")
        outside = outside_feathered_mask(masks, cfg)
        for name, out in (("chunked", chunked), ("single", single)):
            if out.shape != frames.shape or \
                    not np.array_equal(out[outside], frames[outside]):
                raise RuntimeError(f"{name}: pixels outside the feathered "
                                   f"mask differ from the input")
        # inside the feathered mask the chunks' windows and priors differ
        # from the single pass's, so the two are not within 1 u8 there;
        # held to the infill tests' PSNR bound and a max |diff| limit (an
        # H100 run read 49.7 dB and 7)
        diff = np.abs(chunked.astype(np.int16) - single)[~outside]
        mse = float(np.mean(diff.astype(np.float64) ** 2))
        vs_single = {"max_abs_inside": int(diff.max()),
                     "share_within_1": float((diff <= 1).mean()),
                     "psnr_inside": 10 * np.log10(255.0 ** 2 / mse)
                     if mse else float("inf"),
                     "psnr_inside_min": PSNR_INSIDE_MIN,
                     "max_abs_inside_limit": MAX_ABS_INSIDE}
        if vs_single["psnr_inside"] < PSNR_INSIDE_MIN or \
                vs_single["max_abs_inside"] > MAX_ABS_INSIDE:
            raise RuntimeError(f"chunked against single pass inside the "
                               f"feathered mask: {vs_single}")
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = compare.main(["--a", os.path.join(tmp, "chunked.mkv"),
                               "--b", os.path.join(tmp, "single.mkv")])
        metrics = json.loads(buf.getvalue().splitlines()[-1])
        if rc != 0 or metrics["frames"] != T:
            raise RuntimeError(f"compare CLI: rc {rc}, {metrics}")
        print(f"[files] compare chunked vs single pass: psnr "
              f"{metrics['psnr']:.3f} dB (min {metrics['psnr_min']:.3f}), "
              f"ssim {metrics['ssim']:.5f} (min {metrics['ssim_min']:.5f}); "
              f"inside the feathered mask psnr "
              f"{vs_single['psnr_inside']:.3f} dB (limit {PSNR_INSIDE_MIN}), "
              f"max |diff| {vs_single['max_abs_inside']} (limit "
              f"{MAX_ABS_INSIDE}), {vs_single['share_within_1']:.4f} within 1",
              flush=True)

        # 4. cancelled after chunk 0, resumed through the CLI
        cancel = []

        def prog(pct, status="", **_):
            if status == f"[chunk 1/{len(plan)}] done":
                cancel.append(True)

        t0 = time.perf_counter()
        cancelled = False
        try:
            vanish_video_chunked(
                color, mask, os.path.join(tmp, "resumed.mkv"),
                mask_dilation_iter=cfg.infill.mask_dilation_iter,
                max_img_size=cfg.infill.max_img_size, prog=prog,
                is_canceled=lambda: bool(cancel), device="cuda")
        except CancelledError:
            cancelled = True
        if not cancelled:
            raise RuntimeError("the job was not cancelled after chunk 0")
        cancel_s = time.perf_counter() - t0
        resumed = run_cli("resumed", "on")
        done = [f["chunk"] for n, _, f in stage_lists["resumed"]
                if n == "chunk"]
        if done != [1]:
            raise RuntimeError(f"the resumed job computed chunks {done}")
        if not np.array_equal(resumed, chunked):
            raise RuntimeError("the resumed file differs from the "
                               "uninterrupted chunked file")

        # 5. the record
        chunk_stages = stage_lists["chunked"]
        per_chunk = [secs for n, secs, _ in chunk_stages if n == "chunk"]
        prior = [secs for n, secs, _ in chunk_stages
                 if n == "propainter_prior"]
        for name, r in runs.items():
            print(f"[files] diffuerase CLI {name}: {r['seconds']:.2f} s, "
                  f"peak {r['peak_gib']:.2f} GiB; stages "
                  + ", ".join(f"{k} {v['seconds']:.3f} s/{v['count']}"
                              for k, v in r["stage_split"].items()),
                  flush=True)
        print(f"[files] chunked: seconds per chunk "
              + ", ".join(f"{t:.3f}" for t in per_chunk)
              + "; the prior inside them (inline, no overlap) "
              + ", ".join(f"{t:.3f}" for t in prior)
              + f" s; cancelled run "
              f"{cancel_s:.2f} s; resumed file equal to the chunked file "
              f"bitwise", flush=True)
        report = {"frames": [T, H, W], "chunks": plan, "codec_probe": probe,
                  "write_s": write_s, "read_s": read_s,
                  "sam2_cli_s": sam_s, "runs": runs,
                  "seconds_per_chunk": per_chunk,
                  "prior_s": prior,
                  "cancelled_run_s": cancel_s, "resume_bitwise": True,
                  "chunked_vs_single": {**vs_single, **{
                      k: metrics[k] for k in ("psnr", "psnr_min", "ssim",
                                              "ssim_min")}}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[files] phase {report['phase_s']:.1f} s", flush=True)
    return counts, report


# the GUI phase: the app's four jobs (videovanish_tpu_torch/gui/jobs.py) on
# a GUI_FRAMES-frame 1280x720 file pair, the cursor at GUI_CURSOR (22 frames
# ahead of it) and at GUI_TAIL_CURSOR (5 left)
GUI_FRAMES = 30
GUI_CURSOR = 5
GUI_TAIL_CURSOR = 25
GUI_WARM_RUNS = 3  # unprofiled warm previews from GUI_CURSOR
# the kernel instances the 22-frame infill preview launches at 1280x720
# (360x640 inference, 45x80 latents), and the instances of SAM2's last
# 6-frame encode chunk in Generate Mask's 30 frames
GUI_INSTANCES = (
    "flash_attn_fwd[D=40,Sq=3600,Sk=3600]", "flash_attn_fwd[D=40,Sq=3600,Sk=77]",
    "flash_attn_fwd[D=80,Sq=920,Sk=920]", "flash_attn_fwd[D=80,Sq=920,Sk=77]",
    "flash_attn_fwd[D=160,Sq=240,Sk=240]",
    "flash_attn_fwd[D=512,Sq=3600,Sk=3600]",
    "small_seq_attn[tokenmajor,N=3600,D=40,S=22]",
    "small_seq_attn[tokenmajor,N=920,D=80,S=22]",
    "small_seq_attn[tokenmajor,N=240,D=160,S=22]",
    "small_seq_attn[tokenmajor,N=60,D=160,S=22]",
    "small_seq_attn[tokenmajor,N=22,D=160,S=60]",
    "small_seq_attn[tokenmajor,N=6144,D=72,S=64]",
    "small_seq_attn[tokenmajor,N=96,D=72,S=64]",
    "small_seq_attn[bhsd,N=6144,D=72,S=16]",
)


def on_thread(job, cancel_at=None, profile=None) -> dict:
    """job(report, is_canceled) on a threading.Thread, as the window's
    QThread runs it. With cancel_at the job is cancelled once a report
    reaches that percentage (at 0, before it starts); with profile (a dict
    of torch.profiler.profile's options, {} for none) it runs under
    torch.profiler (CPU and CUDA activity) started on its own thread,
    whose op callbacks are per thread. Returns {"result",
    "seconds" (the job until the card is done, without the profiler's
    start and its parse of the trace), "peak_gib", "launches" (the kernel
    launches it made), "prof"}; an exception in the job is raised here."""
    import threading

    import torch
    from videovanish_tpu_torch.ops import attention as A

    out, cancel = {}, threading.Event()
    if cancel_at == 0:
        cancel.set()

    def report(pct, status="", **_):
        if cancel_at is not None and pct >= cancel_at:
            cancel.set()

    def timed_job():
        t0 = time.perf_counter()
        out["result"] = job(report, cancel.is_set)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0

    def run():
        try:
            if profile is not None:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts,
                                            **profile) as prof:
                    timed_job()
                out["prof"] = prof
            else:
                timed_job()
        except BaseException as e:  # raised on the calling thread
            out["error"] = e

    before = dict(A.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = threading.Thread(target=run, name="vv-gui-job", daemon=True)
    t.start()
    t.join(timeout=600)
    if t.is_alive():
        raise RuntimeError("a GUI job did not finish in 600 s")
    if "error" in out:
        raise out["error"]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = {k: n - before.get(k, 0) for k, n in A.LAUNCHES.items()
                       if n - before.get(k, 0)}
    return out


def gui_stage_split(prof, lean, T: int, warm_s) -> dict:
    """The profiled preview's per-stage device split (utils/profiling):
    from `prof` (with_flops), ms, share and MFU of each stage against the
    card's bf16 peak, the IDLE and unstaged shares, the device stages'
    projection onto 4 cards, and the attention kernels' ms by stage (all
    of them must lie in a stage); from `lean` (the same preview profiled
    without with_flops, whose host cost is lower), its IDLE share and
    device ms, and that device ms over each unprofiled warm wall `warm_s`
    (a ratio across runs: the busy share of the unprofiled request)."""
    import statistics

    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.models.propainter.model import window_plan
    from videovanish_tpu_torch.utils import profiling

    peak = profiling.peak_tflops()
    splits = []
    for p in (prof, lean):
        rows = profiling.rows_from_profiler(p)
        if {r["host_or_device"] for r in rows} != {"device"}:
            raise RuntimeError("the profiled preview has no CUDA activity")
        split = profiling.aggregate_programs(rows, peak)
        share = sum(d["share"] for d in split.values())
        if abs(share - 1.0) > 1e-3:
            raise RuntimeError(f"stage shares sum to {share}")
        splits.append((rows, split))
    (rows, stages), (_, lean_stages) = splits
    pcfg = default_config().propainter
    n_windows = len(window_plan(min(T, pcfg.subvideo_length),
                                pcfg.neighbor_length, pcfg.ref_stride)[1])
    kernel_ms = {}
    for r in rows:
        if r["type"] in ("flash_attn_fwd", "small_seq_attn"):
            stage = profiling.program_of(r["operation"])
            kernel_ms[stage] = kernel_ms.get(stage, 0.0) + \
                r["total_self_time"] / 1e3
    if not kernel_ms or profiling.UNSTAGED in kernel_ms:
        raise RuntimeError(f"attention kernels outside the stages: "
                           f"{kernel_ms}")
    lean_ms = sum(d["ms"] for k, d in lean_stages.items() if k != "IDLE")
    busy = [lean_ms / (w * 1e3) for w in warm_s]
    return {"stages": stages, "idle_share": stages.get("IDLE", {}).get(
                "share", 0.0),
            "unstaged_share": stages.get(profiling.UNSTAGED, {}).get(
                "share", 0.0),
            "device_ms": sum(d["ms"] for k, d in stages.items()
                             if k != "IDLE"),
            "lean_idle_share": lean_stages.get("IDLE", {}).get("share", 0.0),
            "lean_device_ms": lean_ms,
            "warm_seconds": list(warm_s),
            "busy_share_of_warm_walls": busy,
            "busy_share_of_median_warm_wall":
                lean_ms / (statistics.median(warm_s) * 1e3),
            "attention_ms_by_stage": kernel_ms,
            # the device's stages (IDLE, inflated by the profiler's host
            # cost, left out) under the mesh's sharding on 4 cards
            "projection_4": profiling.project_multichip(
                {k: d for k, d in stages.items() if k != "IDLE"},
                n_chips=4, frames=T, n_windows=n_windows),
            "peak_tflops": peak}


def run_gui_phase(seed: int = 0):
    """The interactive app's four jobs at the default config, each on a
    worker thread through `videovanish_tpu_torch.gui.jobs`, on a 30-frame
    1280x720 color and mask file pair written by the port: the 1-frame
    mask preview at the cursor (frame 5) against run_sam2_on_frames on that
    frame with its keyframe remapped to 0, bitwise; the 22-frame infill
    preview from the cursor, cold, warm (GUI_WARM_RUNS times) and under
    the profiler (without and with with_flops), against
    run_infill_on_frames(..., preview=True) bitwise, pixels outside the
    feathered mask equal to the input, 45x80 latents; the preview at frame
    25 (5 frames) the same way; Generate Mask and Make Vanish against the
    sam2_masker and diffuerase CLIs' files on the same inputs, bitwise;
    both cancelled (Generate Mask after SAM2 ran, Make Vanish before the
    infill): None and no file. Returns (the jobs' launch counts, report).
    The files are deleted at the end."""
    import numpy as np
    import torch
    from videovanish_tpu_torch.cli import diffuerase, sam2_masker
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.gui import jobs
    from videovanish_tpu_torch.gui.annotations import AnnotationStore
    from videovanish_tpu_torch.pipeline import infill, masker
    from videovanish_tpu_torch.video import io as vio

    cfg = default_config()
    if infill._get_config() != cfg:
        raise RuntimeError("the GUI phase runs the default config")
    t_phase = time.perf_counter()
    tmp = os.path.join("build", "gui_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    counts: dict = {}
    report: dict = {"frames": [GUI_FRAMES, 720, 1280],
                    "cursor": GUI_CURSOR}

    def count(run):
        for k, n in run["launches"].items():
            counts[k] = counts.get(k, 0) + n
        return run

    try:
        T, H, W = GUI_FRAMES, 720, 1280
        frames, masks, _ = synthetic_request(T, H, W, seed + 11)
        masks3 = np.repeat(masks[..., None], 3, axis=-1)
        color = os.path.join(tmp, "color.mkv")
        mask = os.path.join(tmp, "mask.mkv")
        vio.write_video_frames_to_path(color, list(frames), FPS, H, W)
        vio.write_video_frames_to_path(mask, list(masks3), FPS, H, W)
        # the annotations as the window holds them: sam2_annotations' two
        # keyframes and a click on the rectangle at the cursor
        store = AnnotationStore()
        store.load_from_json_obj(sam2_annotations(H, W))
        x0 = W // 6 + (W // 2) * GUI_CURSOR // (T - 1)
        store.get_or_create(GUI_CURSOR).pos_clicks.append(
            ((x0 + W // 16) / W, (H // 3 + H // 8) / H, 1))
        ann = store.annotations_dict()
        settings = {"max_img_size": cfg.infill.max_img_size,
                    "mask_dilation_iter": cfg.infill.mask_dilation_iter,
                    "keep_unmasked_original":
                        cfg.infill.keep_unmasked_original}

        # 1. cancelled jobs write nothing
        out_mask = color + "_sam2_mask.mkv"
        out_vanish = color + "_vanished.mkv"
        c1 = count(on_thread(jobs.generate_mask_job(color, ann),
                             cancel_at=45))
        c2 = count(on_thread(jobs.make_vanish_job(color, mask, **settings),
                             cancel_at=0))
        if c1["result"] is not None or c2["result"] is not None or \
                os.path.exists(out_mask) or os.path.exists(out_vanish):
            raise RuntimeError("a cancelled job returned a result or wrote "
                               "its file")
        report["cancelled"] = {"generate_mask_s": c1["seconds"],
                               "make_vanish_s": c2["seconds"],
                               "results": None, "files": False}
        print(f"[gui] cancelled jobs: Generate Mask after SAM2 "
              f"{c1['seconds']:.2f} s, Make Vanish before the infill "
              f"{c2['seconds']:.2f} s; both None, no file", flush=True)

        # 2. the mask preview at the cursor
        one = store.annotations_dict(only_frame=GUI_CURSOR,
                                     remap_to_zero=True)
        mp = count(on_thread(jobs.preview_mask_job(color, GUI_CURSOR, one)))
        want = masker.run_sam2_on_frames([frames[GUI_CURSOR]], one,
                                         device="cuda")
        check_masks(mp["result"], 1, H, W)
        if not np.array_equal(mp["result"][0], want[0]):
            raise RuntimeError("the mask preview differs from "
                               "run_sam2_on_frames on the cursor frame")
        report["mask_preview"] = {"seconds": mp["seconds"],
                                  "peak_gib": mp["peak_gib"],
                                  "bitwise_direct": True,
                                  "mask_pixels": int(want[0].any(-1).sum())}
        print(f"[gui] mask preview at frame {GUI_CURSOR}: "
              f"{mp['seconds']:.3f} s, peak {mp['peak_gib']:.2f} GiB, equal "
              f"to run_sam2_on_frames on the frame ("
              f"{report['mask_preview']['mask_pixels']} mask pixels)",
              flush=True)

        # 3. the infill preview from the cursor: cold, warm, profiled; and
        # near the end of the file
        model = infill.get_model("2-Step", device="cuda")
        latents = []
        model.latent_hook = latents.append
        previews = {}
        try:
            for cursor in (GUI_CURSOR, GUI_TAIL_CURSOR):
                n = min(jobs.INFILL_PREVIEW_FRAMES, T - cursor)
                sl = slice(cursor, cursor + n)
                job = jobs.preview_infill_job(color, mask, cursor, **settings)
                latents.clear()
                runs = [count(on_thread(job))]
                if cursor == GUI_CURSOR:
                    runs += [count(on_thread(job))
                             for _ in range(GUI_WARM_RUNS)]
                z = torch.cat(latents)
                want = infill.run_infill_on_frames(
                    list(frames[sl]), list(masks3[sl]), **settings,
                    preview=True, device="cuda")
                outside = outside_feathered_mask(masks[sl], cfg)
                for r in runs:
                    got = np.stack(r["result"])
                    if got.shape != frames[sl].shape or \
                            not np.array_equal(got, np.stack(want)):
                        raise RuntimeError(f"the infill preview at frame "
                                           f"{cursor} differs from "
                                           f"run_infill_on_frames(preview="
                                           f"True)")
                    if not np.array_equal(got[outside], frames[sl][outside]):
                        raise RuntimeError("the infill preview changed "
                                           "pixels outside the feathered "
                                           "mask")
                if tuple(z.shape[-2:]) != (45, 80) or \
                        not bool(torch.isfinite(z).all()):
                    raise RuntimeError(f"preview latents {tuple(z.shape)}, "
                                       f"expected finite 45x80")
                diff = np.abs(np.stack(want).astype(np.int16)
                              - frames[sl])[~outside]
                previews[cursor] = {
                    "frames": n, "latent_hw": list(z.shape[-2:]),
                    "seconds": [r["seconds"] for r in runs],
                    "peak_gib": [r["peak_gib"] for r in runs],
                    "bitwise_direct": True,
                    "inside_mean_abs_change": float(diff.mean()),
                    "launches": runs[-1]["launches"]}
                print(f"[gui] infill preview at frame {cursor}: {n} frames, "
                      f"latents {tuple(z.shape[-2:])}, "
                      + ("cold/warm " if len(runs) > 1 else "")
                      + "/".join(f"{r['seconds']:.3f}" for r in runs)
                      + " s, peak "
                      + "/".join(f"{r['peak_gib']:.2f}" for r in runs)
                      + " GiB; equal to run_infill_on_frames(preview=True), "
                      "unmasked pixels equal the input", flush=True)
            # the warm preview's stage split, under the profiler on its
            # thread (kineto is first started here, on the main thread)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1)
            job = jobs.preview_infill_job(color, mask, GUI_CURSOR, **settings)
            lean = count(on_thread(job, profile={}))
            pr = count(on_thread(job, profile={"with_flops": True}))
        finally:
            model.latent_hook = None
        warm_s = previews[GUI_CURSOR]["seconds"][1:]
        split = gui_stage_split(pr["prof"], lean["prof"],
                                jobs.INFILL_PREVIEW_FRAMES, warm_s)
        split["profiled_seconds"] = pr["seconds"]
        split["profiled_peak_gib"] = pr["peak_gib"]
        split["lean_profiled_seconds"] = lean["seconds"]
        busy = split["busy_share_of_warm_walls"]
        preview_instances = set(previews[GUI_CURSOR]["launches"])
        report["infill_preview"] = {str(k): v for k, v in previews.items()}
        report["stage_split"] = split
        print(f"[gui] warm preview's device split (utils/profiling, bf16 "
              f"peak {split['peak_tflops']} TFLOP/s; run with_flops "
              f"{pr['seconds']:.3f} s): "
              + ", ".join(f"{k} {d['ms']} ms share {d['share']} mfu "
                          f"{d['mfu']}" for k, d in split["stages"].items())
              + f"; idle share {split['idle_share']}, unstaged "
              f"{split['unstaged_share']}; device {split['device_ms']:.1f} "
              f"ms; without with_flops: run {lean['seconds']:.3f} s, idle "
              f"share {split['lean_idle_share']}, device "
              f"{split['lean_device_ms']:.1f} ms, over the unprofiled warm "
              f"walls " + "/".join(f"{w:.3f}" for w in warm_s)
              + " s: busy " + "/".join(f"{b:.3f}" for b in busy)
              + f" (median wall "
              f"{split['busy_share_of_median_warm_wall']:.3f}); its stages "
              f"on 4 cards "
              f"{split['projection_4']['projected_ms']} ms against "
              f"{split['projection_4']['measured_ms']} "
              f"({split['projection_4']['reduction_x']}x); attention ms by "
              f"stage {json.dumps(split['attention_ms_by_stage'])}",
              flush=True)

        # 4. Generate Mask and Make Vanish against the CLIs
        ann_path = os.path.join(tmp, "annotations.json")
        with open(ann_path, "w") as f:
            json.dump(store.to_json_obj(video=color, fps=FPS), f)
        gm = count(on_thread(jobs.generate_mask_job(color, ann)))
        cli_mask = os.path.join(tmp, "cli_mask.mkv")
        sam2_masker.main(["--color_video", color, "--annotations", ann_path,
                          "--out", cli_mask])
        mv = count(on_thread(jobs.make_vanish_job(color, mask, **settings)))
        cli_vanish = os.path.join(tmp, "cli_vanished.mkv")
        diffuerase.main(["--color_video", color, "--mask_video", mask,
                         "--out", cli_vanish])
        for name, run, path, want_path in (
                ("Generate Mask", gm, out_mask, cli_mask),
                ("Make Vanish", mv, out_vanish, cli_vanish)):
            if run["result"] != path:
                raise RuntimeError(f"{name} returned {run['result']}")
            got, fps = vio.load_video_frames_from_path(path)
            want, _ = vio.load_video_frames_from_path(want_path)
            if fps != FPS or len(got) != T or \
                    not np.array_equal(np.stack(got), np.stack(want)):
                raise RuntimeError(f"{name}'s file differs from its CLI's")
        check_masks(vio.load_video_frames_from_path(out_mask)[0], T, H, W)
        report["generate_mask"] = {"seconds": gm["seconds"],
                                   "peak_gib": gm["peak_gib"],
                                   "bitwise_cli": True}
        report["make_vanish"] = {"seconds": mv["seconds"],
                                 "peak_gib": mv["peak_gib"],
                                 "bitwise_cli": True}
        print(f"[gui] Generate Mask {gm['seconds']:.2f} s (peak "
              f"{gm['peak_gib']:.2f} GiB), Make Vanish {mv['seconds']:.2f} s "
              f"(peak {mv['peak_gib']:.2f} GiB): files equal to the "
              f"sam2_masker and diffuerase CLIs' bitwise", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    missing = sorted(k for k in GUI_INSTANCES if not counts.get(k))
    if missing:
        raise RuntimeError(f"GUI-phase kernel instances not launched: "
                           f"{missing}")
    report["preview_instances"] = sorted(preview_instances)
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[gui] launches {json.dumps(counts, sort_keys=True)}", flush=True)
    print(f"[gui] phase {report['phase_s']:.1f} s", flush=True)
    return counts, report


# the published weight files the weights phase writes: (manifest in
# tests/fixtures/manifests, file name, dtype); DiffuEraser's and CLIP's as
# .safetensors, ProPainter's and SAM2's as .pth / .pt
WEIGHT_FILES = (
    ("diffueraser_unet_main", "unet_main.safetensors", "float16"),
    ("brushnet", "brushnet.safetensors", "bfloat16"),
    ("sd_vae_ft_mse", "sd-vae-ft-mse.safetensors", "float32"),
    ("clip_vit_l_text", "text_encoder.safetensors", "float32"),
    ("pcm_sd15_2step_lora", "pcm_sd15_2step_lora.safetensors", "float16"),
    ("raft_things", "raft-things.pth", "float32"),
    ("recurrent_flow_completion", "recurrent_flow_completion.pth",
     "float32"),
    ("propainter", "ProPainter.pth", "float32"),
    ("sam2_1_hiera_large_fb", "sam2.1_hiera_large.pt", "float32"),
)
MANIFESTS = "tests/fixtures/manifests"
_ST_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16",
              "int64": "I64"}


def synthetic_state(manifest: dict, dtype, gen) -> dict:
    """Seeded values for a manifest's keys and shapes, at the scale of the
    port's seeded init: weights of two or more dimensions (and their
    biases) uniform in +-1/sqrt(fan_in), LoRA up factors a tenth of that,
    one-dimensional weights (norm scales) near 1, other vectors and tables
    normal at 0.02, batch-norm statistics 0 and 1, counters and position
    ids as integers. Made on the card, returned on the CPU."""
    import torch
    out = {}
    for key, shape in manifest.items():
        shape = tuple(shape)
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros(shape, dtype=torch.int64)
            continue
        if key.endswith("position_ids"):
            out[key] = torch.arange(shape[-1]).reshape(shape)
            continue
        if key.endswith("running_var") or key.endswith("running_mean"):
            t = torch.full(shape, float(key.endswith("running_var")),
                           device="cuda")
        elif key.endswith(".weight") and len(shape) == 1:
            t = 1 + 0.1 * torch.rand(shape, generator=gen, device="cuda")
        else:
            w = manifest.get(key[:-len("bias")] + "weight") \
                if key.endswith(".bias") else shape
            if key.endswith((".weight", ".bias")) and w and len(w) >= 2 \
                    and "embedding" not in key:
                bound = math.prod(w[1:]) ** -0.5 \
                    * (0.1 if ".lora_B." in key else 1.0)
                t = (2 * torch.rand(shape, generator=gen, device="cuda")
                     - 1) * bound
            else:
                t = 0.02 * torch.randn(shape, generator=gen, device="cuda")
        out[key] = t.to(dtype).cpu()
    return out


def write_safetensors(path, state: dict) -> None:
    """A .safetensors file (header padded to 8 bytes, as the safetensors
    package writes it)."""
    import torch
    header, off = {}, 0
    for k, t in state.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_DTYPES[str(t.dtype)[6:]],
                     "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for t in state.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                    .data)


def launches_by_class(counts: dict, classes) -> dict:
    """Launches summed by instance-name prefix; fails if a class has
    none."""
    out = {c: sum(n for k, n in counts.items() if k.startswith(c))
           for c in classes}
    if not all(out.values()):
        raise RuntimeError(f"kernels not launched: {out}")
    return out


def check_loaded(label, module_state: dict, file_state: dict) -> int:
    """Every tensor of the file (after the renames) equals the module's,
    cast to the module's dtype, bitwise; returns the count."""
    import torch
    if sorted(module_state) != sorted(file_state):
        raise RuntimeError(f"{label}: the loaded keys differ from the file's")
    for k, want in file_state.items():
        got = module_state[k]
        if not torch.equal(got, want.to(got.device, got.dtype)):
            raise RuntimeError(f"{label}: {k} differs from the file's")
    return len(file_state)


def check_merge(unet: dict, merged: dict, lora: dict) -> dict:
    """Each merged weight against W + up @ down in f64 (scale 1, alpha =
    rank): within half a unit in the last place of W's dtype plus the f32
    rounding of the sum of rank products, on the card. Every other weight
    is the file's, bitwise. Returns {"entries", "max_abs_err",
    "max_err_ulps"} (ulps of the weight's dtype at the result)."""
    import torch
    from videovanish_tpu_torch.convert import parse_lora_state
    entries = parse_lora_state(lora)
    flat = {k[:-len(".weight")]: k for k in unet if k.endswith(".weight")}
    targets = {flat[n]: ent for n, ent in entries.items()}
    if len(targets) != len(entries):
        raise RuntimeError("LoRA entries without a UNet weight")
    worst, ulps, over = 0.0, 0.0, 0.0
    for k, w in unet.items():
        if k not in targets:
            if not torch.equal(merged[k], w):
                raise RuntimeError(f"unet: {k} changed without a LoRA entry")
            continue
        ent = targets[k]
        w = w.cuda()
        up = ent["up"].cuda().double().flatten(1)
        down = ent["down"].cuda().double().flatten(1)
        r = down.shape[0]
        delta = (up @ down).reshape(w.shape) * (ent.get("alpha", r) / r)
        ref = w.double() + delta
        got = merged[k].cuda()
        mag = torch.maximum(got.abs(), ref.abs().to(got.dtype))
        ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
               - mag).double()
        limit = 0.5 * ulp + (r + 2) * 2.0 ** -24 * (
            w.double().abs() + (up.abs() @ down.abs()).reshape(w.shape))
        err = (got.double() - ref).abs()
        worst = max(worst, float(err.max()))
        ulps = max(ulps, float((err / ulp).max()))
        over = max(over, float((err - limit).max()))
    if over > 0:
        raise RuntimeError(f"merged LoRA weights off the plain formula by "
                           f"{over:.3g} beyond the limit")
    return {"entries": len(targets), "max_abs_err": worst,
            "max_err_ulps": ulps}


def run_weights_phase(seed: int = 0):
    """Synthetic published files at full width, converted by the port's CLI
    and loaded through the config's paths: one infill request with the prior
    computed (22 frames at 512x512: flash, bhsd and token-major small_seq)
    and one SAM2 request (8 frames, 2 objects). Returns (launch counts,
    report). The files are deleted at the end."""
    import numpy as np
    import torch
    from videovanish_tpu_torch import checkpoint
    from videovanish_tpu_torch.cli import convert as cli
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.convert import published_state_dict
    from videovanish_tpu_torch.models.diffueraser.text_encoder import (
        CLIPTextModel, clip_dims, derive_null_text_emb,
    )
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.pipeline import infill, masker

    t_phase = time.perf_counter()
    tmp = os.path.join("build", "weights_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        report = {"files": {}}
        paths, states = {}, {}
        gen = torch.Generator(device="cuda").manual_seed(seed + 6)
        for manifest, name, dtype in WEIGHT_FILES:
            with open(os.path.join(MANIFESTS, manifest + ".json")) as f:
                state = synthetic_state(json.load(f), getattr(torch, dtype),
                                        gen)
            path = paths[manifest] = os.path.join(tmp, name)
            t0 = time.perf_counter()
            if name.endswith(".safetensors"):
                write_safetensors(path, state)
            else:
                torch.save({"model": state} if manifest.startswith("sam2")
                           else state, path)
            write_s = time.perf_counter() - t0
            # read (a mapping, or the unpickling of a .pth), then to the card
            t0 = time.perf_counter()
            back = checkpoint.load_torch_state(path)
            read_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_card = {k: v.to("cuda") for k, v in back.items()}
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            del on_card, back
            states[manifest] = state
            report["files"][name] = {
                "dtype": dtype, "gib": os.path.getsize(path) / 2 ** 30,
                "tensors": len(state), "write_s": write_s, "read_s": read_s,
                "to_card_s": card_s}
            print(f"[weights] {name}: {len(state)} tensors, {dtype}, "
                  f"{os.path.getsize(path) / 2 ** 30:.3f} GiB; write "
                  f"{write_s:.3f} s, read {read_s:.3f} s, to the card "
                  f"{card_s:.3f} s", flush=True)

        # the port's convert CLI: each DiffuEraser piece (the PCM LoRA
        # merged into the UNet), then --assemble with CLIP on the card
        conv = {}
        for model, manifest, extra in (
                ("unet", "diffueraser_unet_main",
                 ["--lora", paths["pcm_sd15_2step_lora"]]),
                ("brushnet", "brushnet", []), ("vae", "sd_vae_ft_mse", []),
                ("clip", "clip_vit_l_text", [])):
            conv[model] = os.path.join(tmp, f"{model}.pt")
            t0 = time.perf_counter()
            res = cli.main(["--input", paths[manifest], "--model", model,
                            "--output", conv[model], *extra])
            report["files"][f"convert {model}"] = dict(
                res["seconds"], total_s=time.perf_counter() - t0)
        assembled = os.path.join(tmp, "diffueraser.pt")
        t0 = time.perf_counter()
        res = cli.main(["--assemble", "diffueraser", "--vae", conv["vae"],
                        "--unet", conv["unet"], "--brushnet",
                        conv["brushnet"], "--clip", conv["clip"], "--output",
                        assembled, "--device", "cuda"])
        report["files"]["assemble"] = dict(res["seconds"],
                                           total_s=time.perf_counter() - t0)

        # the assembled file against the published ones
        tree = checkpoint.load_torch_state(assembled)
        report["merge"] = check_merge(states["diffueraser_unet_main"],
                                      tree["unet"],
                                      states["pcm_sd15_2step_lora"])
        check_loaded("vae file", tree["vae"], published_state_dict(
            states["sd_vae_ft_mse"], "vae"))
        check_loaded("brushnet file", tree["brushnet"], states["brushnet"])
        clip_state = published_state_dict(states["clip_vit_l_text"], "clip")
        check_loaded("clip file", checkpoint.load_torch_state(conv["clip"]),
                     clip_state)
        null_cpu = derive_null_text_emb(clip_state, device="cpu")
        null_err = float((tree["null_text_emb"] - null_cpu).abs().max())
        null_max = float(null_cpu.abs().max())
        if not null_err <= NULL_TOL * null_max:
            raise RuntimeError(f"null_text_emb from the card off the CPU's "
                               f"by {null_err} (max {null_max})")
        with torch.device("meta"):
            clip = CLIPTextModel(**clip_dims(clip_state))
        clip.to_empty(device="cuda").load_state_dict(clip_state)
        ids = torch.tensor([[49406] + [49407] * 76], device="cuda")
        with torch.inference_mode():
            clip_ms = time_ms(lambda: clip(ids), min_total_ms=100)
        del clip
        report["clip"] = {"encode_ms": clip_ms, "null_max_abs_err": null_err,
                          "null_max_abs": null_max}
        print(f"[weights] LoRA: {report['merge']['entries']} entries merged,"
              f" max |merged - plain| {report['merge']['max_abs_err']:.3g} "
              f"({report['merge']['max_err_ulps']:.3f} ulp of float16); "
              f"CLIP encode {clip_ms:.3f} ms (f32, 77 tokens); "
              f"null_text_emb card vs CPU max |diff| {null_err:.3g} of max "
              f"{null_max:.3g}", flush=True)

        # the config's paths at the converted and published files
        cfg = default_config()
        cfg = dataclasses.replace(
            cfg,
            diffueraser=dataclasses.replace(
                cfg.diffueraser, checkpoint=assembled,
                vae_checkpoint=os.path.join(tmp, "absent")),
            propainter=dataclasses.replace(
                cfg.propainter, checkpoint=paths["propainter"],
                raft_checkpoint=paths["raft_things"],
                flowcomp_checkpoint=paths["recurrent_flow_completion"]),
            sam2=dataclasses.replace(
                cfg.sam2, checkpoint=paths["sam2_1_hiera_large_fb"]))
        infill.set_config(cfg)
        masker.reset_predictor()
        torch.cuda.empty_cache()

        T, H, W = 22, 512, 512
        frames, masks, _ = synthetic_request(T, H, W, seed + 5)
        A.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = infill.get_model("2-Step", device="cuda")
        pp = infill.get_propainter("cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        latents = []
        model.latent_hook = latents.append
        t0 = time.perf_counter()
        out = infill.run_infill_on_frames(list(frames), list(masks),
                                          propainer_frames=None,
                                          device="cuda")
        torch.cuda.synchronize()
        infill_s = time.perf_counter() - t0
        counts_infill = dict(A.LAUNCHES)
        infill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        model.latent_hook = None
        z, change = check_request(out, frames, masks, latents, cfg)
        n = sum(check_loaded(f"diffueraser {name}",
                             getattr(model, name).state_dict(), tree[name])
                for name in ("vae", "unet", "brushnet"))
        if not torch.equal(model.null_text_emb.cpu(), tree["null_text_emb"]):
            raise RuntimeError("null_text_emb differs from the file's")
        for name, manifest, model_name in (
                ("raft", "raft_things", "raft"),
                ("flow_comp", "recurrent_flow_completion", "flow_completion"),
                ("generator", "propainter", "propainter")):
            n += check_loaded(name, getattr(pp, name).state_dict(),
                              published_state_dict(states[manifest],
                                                   model_name))
        classes = launches_by_class(counts_infill, (
            "flash_attn_fwd[D=40,", "flash_attn_fwd[D=512,",
            "small_seq_attn[bhsd,", "small_seq_attn[tokenmajor,"))
        print(f"[weights] infill request {T}x{H}x{W}, prior computed, "
              f"published-format weights: models loaded in {load_s:.2f} s, "
              f"request {infill_s:.2f} s, peak {infill_peak:.2f} GiB; "
              f"launches by kernel {json.dumps(classes)}", flush=True)
        del model, pp, latents, z
        infill.set_config(cfg)  # drops the infill models
        torch.cuda.empty_cache()

        # SAM2 on the published-format file: 8 frames, 2 objects
        T, H, W = 8, 720, 1280
        frames = list(synthetic_request(T, H, W, seed + 7)[0])
        ann = sam2_annotations(H, W)
        ann["keyframes"] = ann["keyframes"][:1]
        A.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = masker._get_predictor("cuda")
        torch.cuda.synchronize()
        sam_load_s = time.perf_counter() - t0
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(masker.run_sam2_on_frames(frames, ann, device="cuda"))
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        counts_sam2 = dict(A.LAUNCHES)
        sam2_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_masks(runs[0], T, H, W)
        if not all(np.array_equal(a, b) for a, b in zip(runs[0], runs[2])):
            raise RuntimeError("a second SAM2 run differs from the first")
        n += check_loaded("sam2", pred.model.state_dict(),
                          published_state_dict(
                              states["sam2_1_hiera_large_fb"], "sam2"))
        sam2_classes = launches_by_class(counts_sam2, (
            "flash_attn_fwd[D=72,", "flash_attn_fwd[D=16,",
            "flash_attn_fwd[D=256,", "small_seq_attn[bhsd,",
            "small_seq_attn[tokenmajor,"))
        print(f"[weights] SAM2 request {T}x{H}x{W}, 2 objects: predictor "
              f"loaded in {sam_load_s:.2f} s, cold {runs[1]:.3f} s, warm "
              f"{runs[3]:.3f} s, peak {sam2_peak:.2f} GiB; {n} loaded "
              f"tensors equal their files'", flush=True)
        del pred
        masker.reset_predictor()
        infill.set_config(default_config())
        torch.cuda.empty_cache()
        counts = {k: counts_infill.get(k, 0) + counts_sam2.get(k, 0)
                  for k in set(counts_infill) | set(counts_sam2)}
        report.update({
            "loaded_tensors_checked": n,
            "infill": {"frames": [22, 512, 512], "load_s": load_s,
                       "seconds": infill_s, "peak_gib": infill_peak,
                       "inside_mean_abs_change": change,
                       "launches_by_kernel": classes},
            "sam2": {"frames": [T, H, W], "objects": 2, "load_s": sam_load_s,
                     "seconds_cold": runs[1], "seconds": runs[3],
                     "peak_gib": sam2_peak,
                     "launches_by_kernel": sam2_classes}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[weights] phase {report['phase_s']:.1f} s", flush=True)
    return counts, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["wan"],
                    help="wan: the build, the Wan rows of the kernel phase "
                         "and the Wan request alone")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "videovanish_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from videovanish_tpu_torch.ops import kernels

    # fp32 matmuls and convolutions run in full f32 (the plain versions are
    # the yardstick); the port's own work is bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    ex2_per_s, sm_hz = exp2_rate()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; bounds "
          f"take ex2 at {ex2_per_s:.4g}/s (max SM clock {sm_hz / 1e9:.3f} "
          f"GHz)", flush=True)
    t0 = time.perf_counter()
    built = kernels.build()
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for path in built.values():
        log = path.with_suffix(".log").read_text() \
            if path.with_suffix(".log").exists() else ""
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "warning")):
                print(f"[ptxas] {line.strip()}")
    check_flash_sass(built["flash_attn"])
    check_small_seq_sass(built["small_seq_attn"])
    check_bwd_sass(built)

    if args.only == "wan":
        rows = run_kernel_phase(ex2_per_s, args.seed, wan_kernel_cases())
        counts_w, wan_report = run_wan_request(args.seed)
        for row in rows:
            row["launches"] = counts_w.get(row["name"], 0)
        missing = [r["name"] for r in rows if not r["launches"]]
        if missing:
            raise RuntimeError(f"Wan rows not launched by the request: "
                               f"{missing}")
        print(json.dumps({"kernels": rows, "wan_phase": wan_report}))
        print(card)
        return 0

    rows = run_kernel_phase(ex2_per_s, args.seed)
    bwd_rows = run_backward_rows(ex2_per_s, args.seed)
    counts_t, train_report = run_train_phase(args.seed)
    counts, launches_0, report = run_main_path(args.seed)
    counts_2, prior_report = run_prior_request(launches_0, args.seed)
    report.append(prior_report)
    counts_m, mesh_report = run_mesh_phase(args.seed)
    counts_3, sam2_report = run_sam2_request(args.seed)
    report.append(sam2_report)
    counts_5, files_report = run_files_phase(launches_0, args.seed)
    counts_g, gui_report = run_gui_phase(args.seed)
    counts_4, weights_report = run_weights_phase(args.seed)
    counts_w, wan_report = run_wan_request(args.seed)
    launched = (set(counts) | set(counts_2) | set(counts_3) | set(counts_4)
                | set(counts_5) | set(counts_t) | set(counts_m)
                | set(counts_g) | set(counts_w))
    # SAM2's memory cross-attention at the occupancies the bank passed
    # through while it filled, checked once the requests have shown them
    rows += run_kernel_phase(ex2_per_s, args.seed, bank_cases(
        launched - {r["name"] for r in rows}))
    for row in rows:
        # each instance is driven by the infill requests, by SAM2, by the
        # training step or by the GUI's jobs
        row["launches"] = counts.get(row["name"], 0) + \
            counts_3.get(row["name"], 0) + counts_t.get(row["name"], 0) + \
            counts_g.get(row["name"], 0) + counts_w.get(row["name"], 0)
        row["launches_prior_request"] = counts_2.get(row["name"], 0)
        row["launches_sam2_request"] = counts_3.get(row["name"], 0)
        row["launches_weights_phase"] = counts_4.get(row["name"], 0)
        row["launches_files_phase"] = counts_5.get(row["name"], 0)
        row["launches_mesh_phase"] = counts_m.get(row["name"], 0)
        row["launches_gui_phase"] = counts_g.get(row["name"], 0)
    for row in rows + bwd_rows:
        row["launches_train_phase"] = counts_t.get(row["name"], 0)
    for row in bwd_rows:
        # the training step is the backward kernels' main path
        row["launches"] = row["launches_train_phase"]
        for phase in ("prior_request", "sam2_request", "weights_phase",
                      "files_phase", "mesh_phase", "gui_phase"):
            row[f"launches_{phase}"] = 0
    train_missing = sorted(set(counts_t) - {r["name"] for r in bwd_rows}
                           - {r["name"] for r in rows}
                           | {r["name"] for r in bwd_rows
                              if not counts_t.get(r["name"])})
    if train_missing:
        raise RuntimeError(f"training-phase instances without a kernel-"
                           f"phase row, or backward rows it did not "
                           f"launch: {train_missing}")
    rows += bwd_rows
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    sam2_missing = [r["name"] for r in rows if r["name"] in SAM2_INSTANCES
                    and not counts_3.get(r["name"])]
    if sam2_missing:
        raise RuntimeError(f"SAM2 kernel instances not launched by the SAM2 "
                           f"request: {sam2_missing}")
    unchecked = sorted(launched - {r["name"] for r in rows})
    if unchecked:
        raise RuntimeError(f"main-path kernel instances without a "
                           f"kernel-phase check: {unchecked}")
    mesh_missing = sorted(
        k for k, n in launches_0.items() if n and not counts_m.get(k)
        # a sharded window's temporal attention is the ring, not small_seq
        and not (mesh_report["windows"]["sharded"]
                 and k.startswith("small_seq_attn")))
    if mesh_missing:
        raise RuntimeError(f"kernel instances of request 0 not launched "
                           f"by the mesh run: {mesh_missing}")
    print(json.dumps({"kernels": rows, "main_path": report,
                      "mesh_phase": mesh_report,
                      "train_phase": train_report,
                      "weights_phase": weights_report,
                      "files_phase": files_report,
                      "gui_phase": gui_report,
                      "wan_phase": wan_report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
