"""The control on the card: the reference with its linear and convolution
layers in fp8, put in the program's place, fails a number of the cell's
check, while the program (bf16) passes every one. At the cells' widths on
a shorter, smaller clip than the cells', so that a test run holds it;
the readings at the cells' own size come from `benchmark/calibrate.py`
(PERF.md). Run on the card:

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests
"""
import pytest

from benchmark import calibrate, harness

SEEDS = (4400000001, 4400000002, 4400000003)


def _small(cell: str) -> dict:
    wl = harness.workload(cell)
    frames = 16 if wl["entry"] == "mask" else 12
    wl["traffic"] = dict(wl["traffic"], frames=frames, height=360,
                         width=640)
    wl["warmup"] = 0
    return wl


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["infill.720p.24f", "mask.720p.48f.2obj"])
def test_control_fails_and_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = _small(cell)
    recs = calibrate.readings(cell, SEEDS, SEEDS, wl=wl, emit=lambda s: None)
    limits = wl["limits"]
    for r in recs:
        over = [n for n, v in r["numbers"].items() if v > limits[n]]
        if r["side"] == "program":
            assert not over, r
        else:
            assert over, r
