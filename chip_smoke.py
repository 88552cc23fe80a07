#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (videovanish_tpu_torch) on one GPU.

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
   of two runs in mirrored order (see `timed`);
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
7. weights: writes a synthetic file set in the published layouts to
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
8. prints one {"kernels": [...]} line, the card line, and last
   {"ok": true, "device": {...}}. A kernel row's `launches` counts the two
   requests with the prior passed in and the SAM2 request (each instance
   is launched by one of them; `launches_prior_request`,
   `launches_sam2_request` and `launches_weights_phase` give the other
   runs apart).

After the build it prints each kernel's `ptxas` lines (registers, spills,
warnings) and, where the toolkit has `cuobjdump`, the count of HGMMA (wgmma)
instructions and the highest register in each flash instantiation's SASS,
and the count of TMA loads (UTMALDG), cp.async copies (LDGSTS), ldmatrix
and mma.sync instructions in each small_seq_attn instantiation's; a flash
instantiation without HGMMA, or a small_seq_attn one with neither TMA
loads nor cp.async copies, fails the run.

Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
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
TPU_SRC = "videovanish_tpu/ops/attention.py"


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


def device_ms(fns, min_total_ms: float = 200.0, max_reps: int = 50) -> float:
    """Mean device time of one call in ms: as many calls as time_ms makes
    (the same count, so that both keep the card busy for as long), cycling
    through `fns` (one callable per copy of the inputs, or one callable),
    captured into one CUDA graph and replayed once after a warm-up replay,
    timed by CUDA events. The host's work between calls (the Python
    wrapper, its checks, the launch) is not counted: where a call's host
    work takes longer than its kernel, time_ms measures the host and this
    the card. Copies that do not fit in L2 together make every call read
    its inputs from device memory, as the bound assumes."""
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
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
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


def timed(kern, kerns, lib, libs) -> dict:
    """The kernel's and the library call's times, each the mean of two
    runs in mirrored order (call loop, CUDA graph, graph, call loop), so
    neither method always runs first on a cooler or warmer card: `ms` and
    `library_ms` by time_ms on one copy of the inputs (host work included,
    as the rows were timed from the start), `device_ms` and `library_device_ms`
    by device_ms cycling through the copies."""
    order = [("ms", time_ms, kern), ("library_ms", time_ms, lib),
             ("device_ms", device_ms, kerns),
             ("library_device_ms", device_ms, libs)]
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
    # self-attention (one 256-wide head)
    cases += [flash(128, 8, 256, 256, 72), flash(8, 8, 4096, 4096, 72),
              flash(128, 16, 64, 256, 72), flash(2, 8, 22, 4096, 16),
              flash(2, 1, 4096, 4096, 256)]
    return cases + [
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
    ]


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


def run_kernel_phase(ex2_per_s: float, seed: int = 0):
    import torch
    from videovanish_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = torch.device("cuda"), torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    rows = []
    for key, replaces, route, shape in kernel_cases():
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


def check_request(out, frames, masks, latents, cfg):
    """The output's shape, finite latents before decode, and pixels where
    the feathered alpha is 0 equal to the input; returns (latents, the mean
    |change| inside)."""
    import numpy as np
    import torch
    from videovanish_tpu_torch.ops.edt import feather_alpha
    from videovanish_tpu_torch.ops.morphology import binarize_and_dilate

    out = np.stack(out)
    if out.shape != frames.shape or out.dtype != np.uint8:
        raise RuntimeError(f"output {out.shape} {out.dtype}, expected "
                           f"{frames.shape} uint8")
    if not latents or not all(bool(torch.isfinite(z).all())
                              for z in latents):
        raise RuntimeError("non-finite latents before decode")
    m = binarize_and_dilate(torch.from_numpy(masks[..., None]).cuda(),
                            cfg.infill.mask_dilation_iter)
    alpha = feather_alpha(m > 0, float(cfg.infill.feather_px)).cpu().numpy()
    outside = alpha == 0
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
          f"{warm['peak_gib']:.2f} GiB; mask cover obj 1 {cover[1]:.4f}, "
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
        "peak_gib": warm["peak_gib"], "mask_cover": cover,
        "bf16_logit_drift": drift}


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

    rows = run_kernel_phase(ex2_per_s, args.seed)
    counts, launches_0, report = run_main_path(args.seed)
    counts_2, prior_report = run_prior_request(launches_0, args.seed)
    report.append(prior_report)
    counts_3, sam2_report = run_sam2_request(args.seed)
    report.append(sam2_report)
    counts_4, weights_report = run_weights_phase(args.seed)
    for row in rows:
        # each instance is driven by the infill requests or by SAM2
        row["launches"] = counts.get(row["name"], 0) + \
            counts_3.get(row["name"], 0)
        row["launches_prior_request"] = counts_2.get(row["name"], 0)
        row["launches_sam2_request"] = counts_3.get(row["name"], 0)
        row["launches_weights_phase"] = counts_4.get(row["name"], 0)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    sam2_missing = [r["name"] for r in rows if r["name"] in SAM2_INSTANCES
                    and not counts_3.get(r["name"])]
    if sam2_missing:
        raise RuntimeError(f"SAM2 kernel instances not launched by the SAM2 "
                           f"request: {sam2_missing}")
    unchecked = sorted((set(counts) | set(counts_2) | set(counts_3)
                        | set(counts_4)) - {r["name"] for r in rows})
    if unchecked:
        raise RuntimeError(f"main-path kernel instances without a "
                           f"kernel-phase check: {unchecked}")
    print(json.dumps({"kernels": rows, "main_path": report,
                      "weights_phase": weights_report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
