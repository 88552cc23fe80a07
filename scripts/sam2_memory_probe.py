#!/usr/bin/env python3
"""How much of the SAM2 request's peak card memory is the request's own.

    python3 scripts/sam2_memory_probe.py [--root DIR]

Imports the port and chip_smoke.py from --root (default: this checkout;
give an unpacked earlier commit to read it the same way), then runs
chip_smoke.py's SAM2 request (`run_sam2_on_frames`, 24 frames at 1280x720,
two objects, default config, seeded weights) twice: first on a card that
holds only the SAM2 predictor, then after building the infill models
(`get_model`, `get_propainter`), which chip_smoke.py's earlier phases leave
resident. Each time it reads the memory allocated before the request and
the request's peak (a warm-up run first, the peak of the second). Prints
the card's line and one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, sam2_annotations, synthetic_request
    from videovanish_tpu_torch.pipeline import infill, masker

    gib = 2 ** 30
    T, H, W = 24, 720, 1280
    frames = list(synthetic_request(T, H, W, 3)[0])
    ann = sam2_annotations(H, W)
    masker._get_predictor("cuda")

    def request():
        masker.run_sam2_on_frames(frames, ann, device="cuda")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() / gib
        torch.cuda.reset_peak_memory_stats()
        masker.run_sam2_on_frames(frames, ann, device="cuda")
        torch.cuda.synchronize()
        return {"resident_before_gib": before,
                "peak_gib": torch.cuda.max_memory_allocated() / gib}

    alone = request()
    infill.get_model("2-Step", "cuda")
    infill.get_propainter("cuda")
    torch.cuda.synchronize()
    with_infill = request()
    report = {"root": os.path.abspath(args.root), "card": card_line(),
              "sam2_alone": alone, "with_infill_models": with_infill,
              "infill_models_gib": with_infill["resident_before_gib"]
              - alone["resident_before_gib"]}
    print(card_line(), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
