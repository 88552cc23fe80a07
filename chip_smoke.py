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
   yardstick only; the port never calls it);
4. main path: `run_infill_on_frames` at the full SD1.5 / DiffuEraser width
   with seeded random weights, for two requests of 22 frames with the prior
   passed in: 1280x720 frames (544x960 inference, one temporal window) and
   512x512 frames (where the token-major temporal layout does not apply and
   the (B, H, S, D) fallback runs). Checks finite latents, the output shape,
   pixels outside the feathered mask equal to the input, and that every
   kernel instance of the path launched;
5. prints one {"kernels": [...]} line, the card line, and last
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import os
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


def bound(B, H, Sq, Sk, D, ex2_per_s):
    """Least time (ms) the card needs for one attention call, and what
    bounds it: q/k/v/o bytes at HBM rate, or the operations (tensor-core
    flops of q k^T and p v, and one exponential per score)."""
    t_bytes = 2 * B * H * (2 * Sq * D + 2 * Sk * D) / PEAK_BYTES
    t_ops = max(4 * B * H * Sq * Sk * D / PEAK_BF16_FLOPS,
                B * H * Sq * Sk / ex2_per_s)
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def kernel_cases():
    """(counter key, replaced TPU kernel line, route, shape) per kernel
    instance at the shapes the main path gives it. Flash shapes are
    (B, H, Sq, Sk, D) as split views of (B, S, H*D) projections; small-seq
    shapes are token-major (N, S, C, heads) or (B, H, S, D)."""
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
    return cases + [
        # temporal attention over the 22-frame window, 544x960 inference
        ("small_seq_attn[tokenmajor,D=40,S=22]", tm, "tokenmajor",
         (8160, 22, 320, 8)),
        ("small_seq_attn[tokenmajor,D=80,S=22]", tm, "tokenmajor",
         (2040, 22, 640, 8)),
        ("small_seq_attn[tokenmajor,D=160,S=22]", tm, "tokenmajor",
         (510, 22, 1280, 8)),
        # 512x512 inference: the mid block's 8x8-token spatial attention,
        # and the temporal attention where J = 5 does not divide N
        ("small_seq_attn[tokenmajor,D=160,S=64]", tm, "tokenmajor",
         (22, 64, 1280, 8)),
        ("small_seq_attn[bhsd,D=40,S=22]", pk, "packed", (4096, 22, 320, 8)),
        ("small_seq_attn[bhsd,D=80,S=22]", pk, "packed", (1024, 22, 640, 8)),
        ("small_seq_attn[bhsd,D=160,S=22]", pk, "packed",
         (256, 22, 1280, 8)),
    ]


def run_kernel_phase(ex2_per_s: float, seed: int = 0):
    import torch
    import torch.nn.functional as F
    from videovanish_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf16 = torch.device("cuda"), torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    rows = []
    for key, replaces, route, shape in kernel_cases():
        if route == "flash":
            B, H, Sq, Sk, D = shape
            # split views of token-major projections, as Attention makes them
            q = randn(B, Sq, H, D).permute(0, 2, 1, 3)
            k = randn(B, Sk, H, D).permute(0, 2, 1, 3)
            v = randn(B, Sk, H, D).permute(0, 2, 1, 3)
            scale = D ** -0.5
            assert A.attention_route(q.shape, k.shape, True) == "flash"

            def kern():
                return A.attention(q, k, v, scale)

            def plain():
                return A.flash_attention_ref(q.float(), k.float(), v.float(),
                                             scale)

            def lib():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)
            src = SRC_FLASH
        else:
            N, S, C, heads = shape
            d = C // heads
            B, H, Sq, Sk, D = N, heads, S, S, d
            q, k, v = randn(N, S, C), randn(N, S, C), randn(N, S, C)
            scale = d ** -0.5

            def split(t):
                return t.view(N, S, heads, d).permute(0, 2, 1, 3)
            if route == "tokenmajor":
                assert A.tokenmajor_route(q.shape, heads, True) == "tokenmajor"

                def kern():
                    return split(A.attention_tokenmajor(q, k, v, heads, scale))
            else:
                # the fallback when J does not divide N: attention() on the
                # head-split views
                assert A.attention_route(split(q).shape, split(k).shape,
                                         True) == "packed"

                def kern():
                    return A.attention(split(q), split(k), split(v), scale)

            def plain():
                return A.small_seq_attention_ref(
                    split(q).float(), split(k).float(), split(v).float(),
                    scale)

            def lib():
                return F.scaled_dot_product_attention(
                    split(q), split(k), split(v), scale=scale)
            src = SRC_SMALL

        before = A.LAUNCHES[key]
        got = kern()
        torch.cuda.synchronize()
        if A.LAUNCHES[key] != before + 1:
            raise RuntimeError(f"{key}: the call did not launch its kernel")
        ref = plain()
        err = (got.float() - ref).abs().max().item()
        limit = TOL * ref.abs().max().item()
        del ref
        ms = time_ms(kern)
        plain_ms = time_ms(plain, min_total_ms=0, max_reps=2)
        library_ms = time_ms(lib)
        b_ms, b_by = bound(B, H, Sq, Sk, D, ex2_per_s)
        row = {"name": key, "route": "cuda", "source": src,
               "replaces": replaces,
               "shape": {"B": B, "H": H, "Sq": Sq, "Sk": Sk, "D": D},
               "launches": 0, "max_abs_err": err,
               "tolerance": limit, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        print(f"[kernel] {key} err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} sdpa_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not math.isfinite(err) or err > limit:
            raise RuntimeError(f"{key}: max|kernel - plain| = {err} exceeds "
                               f"{limit}")
        rows.append(row)
        del q, k, v, got
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


def run_main_path(seed: int = 0):
    """Two requests through run_infill_on_frames on the card; returns
    (launch counts, report)."""
    import numpy as np
    import torch
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.ops import attention as A
    from videovanish_tpu_torch.ops.morphology import binarize_and_dilate
    from videovanish_tpu_torch.ops.edt import feather_alpha
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
    report = []
    A.reset_launch_counts()
    for i, (T, H, W) in enumerate(requests):
        frames, masks, prior = synthetic_request(T, H, W, seed + i)
        latents.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infill.run_infill_on_frames(
            list(frames), list(masks), propainer_frames=list(prior),
            device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = np.stack(out)
        if out.shape != (T, H, W, 3) or out.dtype != np.uint8:
            raise RuntimeError(f"output {out.shape} {out.dtype}, expected "
                               f"({T}, {H}, {W}, 3) uint8")
        if not latents or not all(bool(torch.isfinite(z).all())
                                  for z in latents):
            raise RuntimeError("non-finite latents before decode")
        z = torch.cat(latents)
        # pixels where the feathered alpha is 0 must be the input's
        m = binarize_and_dilate(torch.from_numpy(masks[..., None]).cuda(),
                                cfg.infill.mask_dilation_iter)
        alpha = feather_alpha(m > 0, float(cfg.infill.feather_px)).cpu().numpy()
        outside = alpha == 0
        if not np.array_equal(out[outside], frames[outside]):
            raise RuntimeError("pixels outside the feathered mask changed")
        inside = ~outside
        diff = np.abs(out.astype(np.int16) - frames.astype(np.int16))[inside]
        h, w = z.shape[-2] * 8, z.shape[-1] * 8
        report.append({"frames": [T, H, W], "inference_hw": [h, w],
                       "seconds": secs, "peak_gib": peak,
                       "latent_absmax": float(z.abs().max()),
                       "inside_mean_abs_change": float(diff.mean())})
        print(f"[main] request {i}: {T}x{H}x{W} -> {h}x{w} inference, "
              f"{secs:.2f} s, peak {peak:.2f} GiB", flush=True)
    counts = dict(A.LAUNCHES)
    print(f"[main] launches {json.dumps(counts, sort_keys=True)}", flush=True)
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
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {line.strip()}")

    rows = run_kernel_phase(ex2_per_s, args.seed)
    counts, report = run_main_path(args.seed)
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    unchecked = sorted(set(counts) - {r["name"] for r in rows})
    if unchecked:
        raise RuntimeError(f"main-path kernel instances without a "
                           f"kernel-phase check: {unchecked}")
    print(json.dumps({"kernels": rows, "main_path": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
