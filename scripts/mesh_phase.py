#!/usr/bin/env python3
"""chip_smoke.py's mesh phase alone, on every card of the machine.

    python3 scripts/mesh_phase.py

Builds the kernels, then runs `chip_smoke.run_mesh_phase`: the 24-frame
1280x720 infill request with the prior computed on one card, then through
a ("data", "model") mesh over one rank a card (spawned, NCCL; in this
process at one card), held against each other, and ring attention over the
mesh's data group against the plain attention; then the DiffuEraser
trainer on the mesh at full width: the one-card step on every card at
once (the baseline), then at one card a 1x1 mesh, bitwise equal to it;
on N cards (data N, model 1) with N clips (first loss and gradients held
to one card's on the same clips), (data 1, model N) with one (every loss
held to the baseline's), and (data 1, model N) with one clip of 64x64
latents (first loss held to a one-card forward), each with its warm step
time and peak per rank. Prints the card names and power limits, the phase's
lines, its report as JSON and rank 0's kernel launches of the mesh run.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    # f32 products in full f32, as chip_smoke.py's main() sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from videovanish_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s; torch "
          f"{torch.__version__}, {torch.cuda.device_count()} cards",
          flush=True)
    counts, report = chip_smoke.run_mesh_phase(0)
    print(json.dumps(report))
    print(json.dumps(counts, sort_keys=True))
    return 0


if __name__ == "__main__":  # spawned ranks import this file again
    sys.exit(main())
