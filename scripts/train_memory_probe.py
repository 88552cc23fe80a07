#!/usr/bin/env python3
"""Peak device memory of the port's DiffuEraser training step at full width.

    python3 scripts/train_memory_probe.py [--hw 64]

Builds the default config's UNet (motion modules) and BrushNet on the card
(seeded with init_random_), takes STEPS AdamW steps of
`videovanish_tpu_torch.train.make_train_step` with remat (chip_smoke's
training phase) on one clip of FRAMES frames of hw x hw latents, and
prints the parameters' bytes resident before the first step, each step's
seconds and peak memory, or, when the card runs out of memory, the error's
first line and the peak reached (exit code 1). The card's name and power limit come
first. One size a process: an out-of-memory error leaves the allocator's
cache behind it.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FRAMES = 22  # the default clip: temporal attention at S = 22
STEPS = 2    # the first step's peak, and a second's to show it holds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=64, help="latent height=width")
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import card_line
    from videovanish_tpu_torch.config import default_config
    from videovanish_tpu_torch.models.diffueraser.blocks import init_random_
    from videovanish_tpu_torch.models.diffueraser.brushnet import (
        BrushNetModel,
    )
    from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition
    from videovanish_tpu_torch.train import make_train_step
    if not torch.cuda.is_available():
        print("train_memory_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}", flush=True)
    cfg = default_config().diffueraser
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        unet = UNetCondition(4, 4, cfg.block_out_channels,
                             cfg.layers_per_block, cfg.attention_head_dim,
                             cfg.cross_attention_dim)
        brushnet = BrushNetModel(9, cfg.block_out_channels,
                                 cfg.layers_per_block, cfg.attention_head_dim,
                                 cfg.cross_attention_dim)
    init_random_(unet, gen)
    init_random_(brushnet, gen)
    init_fn, step_fn = make_train_step(unet, brushnet, None, remat=True)
    state = init_fn()
    B, T, h = 1, FRAMES, args.hw
    batch = {"latents": torch.randn(B, T, h, h, 4, generator=gen,
                                    device="cuda"),
             "masked_lat": torch.randn(B, T, h, h, 4, generator=gen,
                                       device="cuda"),
             "mask_lat": torch.ones(B, T, h, h, 1, device="cuda"),
             "text_emb": torch.randn(B, 77, cfg.cross_attention_dim,
                                     generator=gen, device="cuda")}
    torch.cuda.synchronize()
    print(f"[probe] latents {T}x{h}x{h} ({h * 8}x{h * 8} frames), remat: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB resident "
          f"(params and AdamW moments)", flush=True)
    for i in range(STEPS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            state, loss = step_fn(state, batch, gen)
            torch.cuda.synchronize()
        except torch.OutOfMemoryError as e:
            print(f"[probe] step {i}: out of memory, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB: "
                  f"{str(e).splitlines()[0]}", flush=True)
            return 1
        print(f"[probe] step {i}: loss {float(loss):.6f}, "
              f"{time.perf_counter() - t0:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
