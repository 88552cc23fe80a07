"""Command-line entry points of the port.

    python -m videovanish_tpu_torch.cli.sam2_masker --color_video ... \\
        --annotations ...
    python -m videovanish_tpu_torch.cli.diffuerase --color_video ... \\
        --mask_video ...
    python -m videovanish_tpu_torch.cli.compare --a ... --b ...
    python -m videovanish_tpu_torch.cli.convert ...

They run on the card; VV_PLATFORM=cpu runs them on the CPU, as the JAX
package's CLIs read it.
"""
from __future__ import annotations

import os


def device_from_env() -> str:
    """"cpu" under VV_PLATFORM=cpu, else "cuda", which must exist: without
    a card a CLI stops rather than run on the CPU unasked."""
    if os.environ.get("VV_PLATFORM") == "cpu":
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set VV_PLATFORM=cpu to run on "
                           "the CPU")
    return "cuda"
