"""Chunked long-video inpainting: file in, file out, resumable (port of
videovanish_tpu/pipeline/chunking.py).

- Frames stream from disk a chunk at a time through decode-ahead threads
  (`video/staging.py`), so a long 720p video never sits whole in host
  memory.
- Each chunk runs the whole pipeline (dilation, ProPainter prior,
  DiffuEraser, composite). Neighbouring chunks share `overlap` frames and
  blend in latent space: noise is a function of the global frame index, a
  chunk withholds its overlap tail from the VAE decode and hands the blend
  accumulators (`carry_z`, `carry_w`, f32) to the next chunk, which ramps
  its own windows into them. A chunk seam is then the same cross-fade as a
  seam between windows, and a rerun of a video is bitwise identical.
- Each finished chunk is saved as an .npz (its frames and the carry) with
  a JSON manifest, so a job that failed or was cancelled resumes from its
  last saved chunk. Cancellation is polled between chunks.
- A single-thread "io" pool compresses and saves chunk N behind chunk
  N+1. Each chunk's dilation and prior run inline, on the main stream,
  inside `run_infill_on_frames`. The JAX driver's "prep" pool, which
  starts chunk N+1's prior from `on_device_idle`, is not ported: on a
  stream of its own it moved the wall time of an 88-frame 720p job on the
  H100 by less than the run-to-run spread (PERF.md,
  `scripts/chunk_prior_ab.py`).
- Under torchrun (one process per card) every rank reads the videos and
  computes every chunk through the mesh of `run_infill_on_frames`; rank 0
  alone writes the chunk files, the manifest and the output video. Which
  chunks a resume skips, their latent carry and a cancellation are rank
  0's, broadcast to every rank, so the ranks stay in step.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from videovanish_tpu_torch.core.mesh import (
    agree, barrier, initialize_distributed, is_writer,
)
from videovanish_tpu_torch.core.prog import (
    CancelledError, null_prog, scale_prog,
)
from videovanish_tpu_torch.pipeline import infill
from videovanish_tpu_torch.utils.observability import record_stage
from videovanish_tpu_torch.video.io import (
    probe_video, write_video_frames_to_path,
)
from videovanish_tpu_torch.video.staging import PrefetchingFrameSource


def _chunk_plan(total: int, chunk: int, overlap: int):
    """(start, end) half-open chunk windows sharing `overlap` frames with
    their neighbours. When total > chunk every chunk has exactly `chunk`
    frames: the last one snaps back and widens its overlap."""
    if total <= chunk:
        return [(0, total)]
    stride = chunk - overlap
    plan = []
    s = 0
    while True:
        if s + chunk >= total:
            plan.append((total - chunk, total))
            break
        plan.append((s, s + chunk))
        s += stride
    return plan


def _pair_overlaps(plan):
    """overlaps[i] = the frames chunk i shares with chunk i-1 (0 for i=0)."""
    return [0] + [plan[i - 1][1] - plan[i][0] for i in range(1, len(plan))]


def vanish_video_chunked(color_video: str, mask_video: str, out_video: str,
                         start_frame: int = 0, max_frames: int = -1,
                         chunk_frames: Optional[int] = None,
                         overlap_frames: Optional[int] = None,
                         mask_dilation_iter: int = 8,
                         max_img_size: int = 960,
                         keep_unmasked_original: bool = True,
                         feather_px: int = 3,
                         prog=None, is_canceled=None,
                         resume: bool = True,
                         work_dir: Optional[str] = None,
                         device="cuda") -> str:
    """Remove the masked objects of `color_video` under `mask_video` in
    overlapped chunks and write `out_video` (FFV1); resumable through the
    work directory's manifest. `device` as in run_infill_on_frames."""
    prog = prog or null_prog
    device = torch.device(device)
    initialize_distributed(device_type=device.type)
    writer = is_writer()
    cfg = infill._get_config().chunking
    chunk = chunk_frames or cfg.chunk_frames
    overlap = overlap_frames if overlap_frames is not None \
        else cfg.overlap_frames
    overlap = min(overlap, chunk - 1)

    n_total, fps, H0, W0 = probe_video(color_video)
    if start_frame > 0:
        n_total = max(0, n_total - start_frame)
    if max_frames > 0:
        n_total = min(n_total, max_frames)
    if n_total <= 0:
        raise AssertionError("No frames to process")

    plan = _chunk_plan(n_total, chunk, overlap)
    pair_ov = _pair_overlaps(plan)

    # fmt2: the chunk files carry carry_z / carry_w and leave out the
    # withheld tail. "torch" and the device type keep this package's chunks
    # apart from the JAX package's and the CPU's (f32) from the card's
    # (bf16): a manifest of another format, package or device does not
    # match the id, and the job starts fresh
    job_id = hashlib.sha1(
        f"fmt2-torch|{device.type}|{os.path.abspath(color_video)}|"
        f"{os.path.abspath(mask_video)}|"
        f"{start_frame}|{max_frames}|{chunk}|{overlap}|{mask_dilation_iter}|"
        f"{max_img_size}|{keep_unmasked_original}|{feather_px}".encode()
    ).hexdigest()[:16]
    wd = work_dir or (os.path.splitext(out_video)[0] + f".vvwork_{job_id}")
    manifest_path = os.path.join(wd, "manifest.json")

    manifest = {"job_id": job_id, "chunks": len(plan), "completed": []}
    if writer:
        os.makedirs(wd, exist_ok=True)
        if resume and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                old = json.load(f)
            if old.get("job_id") == job_id:
                manifest = old

    def chunk_path(ci):
        return os.path.join(wd, f"chunk_{ci:05d}.npz")

    # the chunks a resume skips: the writer's, on every rank
    saved = set(agree(
        [ci for ci in manifest["completed"]
         if os.path.exists(chunk_path(ci))] if writer else None))

    color_rd = PrefetchingFrameSource(color_video, start_frame, max_frames,
                                      prefetch_frames=chunk + overlap)
    mask_rd = PrefetchingFrameSource(mask_video, start_frame, max_frames,
                                     prefetch_frames=chunk + overlap)
    pos = 0  # frames read so far from both sources
    # the overlap frames chunk i read, handed on to chunk i+1
    carry_c: list = []
    carry_m: list = []

    def materialize(ci):
        """The frames and masks of chunk ci, read in increasing ci."""
        nonlocal pos, carry_c, carry_m
        need = plan[ci][1] - pos
        new_c = color_rd.read_chunk(need) if need > 0 else []
        new_m = mask_rd.read_chunk(need) if need > 0 else []
        pos += len(new_c)
        frames = carry_c + new_c
        masks = carry_m + new_m
        if ci < len(plan) - 1:  # the last pair's overlap can be wider
            ovn = pair_ov[ci + 1]
            carry_c = frames[-ovn:] if ovn else []
            carry_m = masks[-ovn:] if ovn else []
        return frames, masks

    io_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vv-io")
    save_futs = []

    def save_chunk(ci, out_list, carry):
        t0 = time.perf_counter()
        arrays = {"frames": np.stack(out_list)}
        if carry is not None:
            arrays.update(carry_z=np.asarray(carry[0]),
                          carry_w=np.asarray(carry[1]))
        np.savez_compressed(chunk_path(ci), **arrays)
        manifest["completed"] = sorted(set(manifest["completed"]) | {ci})
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)
        record_stage("chunk_save", time.perf_counter() - t0, chunk=ci)

    latent_carry = None  # (z_acc, w_acc) handed chunk to chunk
    try:
        for ci, (s, e) in enumerate(plan):
            if agree(is_canceled is not None and bool(is_canceled())):
                raise CancelledError("job canceled")
            ov_next = pair_ov[ci + 1] if ci < len(plan) - 1 else 0
            frames, masks = materialize(ci)

            if ci in saved:
                prog(5 + 85 * (ci + 1) / len(plan),
                     f"chunk {ci + 1}/{len(plan)} (resumed)")
                latent_carry = None
                if ov_next and writer:  # the carry for the next chunk
                    with np.load(chunk_path(ci)) as z:
                        latent_carry = (z["carry_z"], z["carry_w"])
                latent_carry = agree(latent_carry)
                continue

            sub_prog = scale_prog(prog, 5 + 85 * ci / len(plan),
                                  5 + 85 * (ci + 1) / len(plan),
                                  prefix=f"[chunk {ci + 1}/{len(plan)}] ")
            t0 = time.perf_counter()
            out = infill.run_infill_on_frames(
                frames, masks, mask_dilation_iter=mask_dilation_iter,
                max_img_size=max_img_size,
                keep_unmasked_original=keep_unmasked_original,
                feather_px=feather_px, prog=sub_prog,
                frame_offset=s, latent_carry=latent_carry,
                return_latent_tail=ov_next, device=device)
            record_stage("chunk", time.perf_counter() - t0, chunk=ci,
                         frames=e - s)
            if ov_next:
                out, latent_carry = out
            else:
                latent_carry = None
            if writer:
                save_futs.append(io_pool.submit(save_chunk, ci, out,
                                                latent_carry))
        for f in save_futs:  # raise the io thread's failures
            f.result()
    finally:
        io_pool.shutdown(wait=True)
        color_rd.close()
        mask_rd.close()

    # every chunk's frames are final (the seams blended in latent space):
    # stream them into the output in order
    prog(92, "assembling output")
    if not writer:  # rank 0 writes the output; wait for it
        barrier()
        prog(100, "done")
        return out_video

    def saved_frames():
        for ci in range(len(plan)):
            with np.load(chunk_path(ci)) as z:
                yield from z["frames"]

    t0 = time.perf_counter()
    write_video_frames_to_path(out_video, saved_frames(), fps, H0, W0)
    record_stage("assemble", time.perf_counter() - t0, chunks=len(plan))

    for fn in os.listdir(wd):  # done: clear the work directory
        os.remove(os.path.join(wd, fn))
    os.rmdir(wd)
    barrier()
    prog(100, "done")
    return out_video
