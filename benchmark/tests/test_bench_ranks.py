"""A cell of four chips, rehearsed on the CPU: four gloo ranks started
by `ranks.run` run the tiny infill cell, its workload asking for four
chips, on the port's ("data" 4, "model" 1) mesh and agree with the
reference; with the exchange between the ranks left out (each rank's
block where the all-gather should put every rank's) the run is not
correct."""
import json
import sys
import time

import pytest

from benchmark import ranks

from .helpers import tiny_spec, tiny_workload

CELL = "infill.720p.24f"
NO_EXCHANGE = """
import runpy, sys, torch, torch.distributed as dist
from videovanish_tpu_torch.core import mesh
mesh.all_gather_cat = lambda t, group, dim=0: torch.cat(
    [t] * dist.get_world_size(group), dim)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _run(tmp_path, python=(sys.executable,)):
    wl = dict(tiny_workload(CELL, 8), chips=4)
    (tmp_path / "wl.json").write_text(json.dumps(wl))
    (tmp_path / "cfg.json").write_text(json.dumps(tiny_spec()))
    return ranks.run(CELL, 11, 0.5, False, time.perf_counter(), 4,
                     extra_args=("--device", "cpu", "--wl-file",
                                 str(tmp_path / "wl.json"), "--cfg-file",
                                 str(tmp_path / "cfg.json")),
                     python=python)


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks(tmp_path, fault):
    python = (sys.executable,) if fault is None else \
        (sys.executable, "-c", NO_EXCHANGE)
    r = _run(tmp_path, python)
    assert r is not None and r["device"]["count"] == 4
    assert r["correct"] is (fault is None), r["checks"]
