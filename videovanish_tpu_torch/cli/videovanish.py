"""CLI/GUI entry: videovanish (port of videovanish_tpu/cli/videovanish.py),
flag for flag with the reference (videovanish.py:1744-1766).

    python -m videovanish_tpu_torch.cli.videovanish [--color_video ...] \\
        [--mask_video ...] [--infilled_video ...]

Opens the PySide6 window, whose jobs run on the card (VV_PLATFORM=cpu: on
the CPU). Without PySide6 it exits with code 2 and a message that points
at the command-line pipelines, instead of a stack trace.
"""
from __future__ import annotations

import argparse
import sys

from videovanish_tpu_torch.cli import device_from_env


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="VideoVanish — interactive video object removal.")
    ap.add_argument("--color_video", type=str, default=None,
                    help="Color video to open at startup.")
    ap.add_argument("--mask_video", type=str, default=None,
                    help="Mask video to open at startup.")
    ap.add_argument("--infilled_video", type=str, default=None,
                    help="Infilled video to open at startup.")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    try:
        from videovanish_tpu_torch.gui.app import run_app
    except ImportError as e:
        print("[videovanish] GUI unavailable (PySide6 not installed): "
              f"{e}\n"
              "Use the CLI pipelines instead:\n"
              "  python -m videovanish_tpu_torch.cli.sam2_masker "
              "--color_video ... --annotations ...\n"
              "  python -m videovanish_tpu_torch.cli.diffuerase "
              "--color_video ... --mask_video ...",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(run_app(color_video=args.color_video,
                     mask_video=args.mask_video,
                     infilled_video=args.infilled_video,
                     device=device_from_env()))


if __name__ == "__main__":
    main()
