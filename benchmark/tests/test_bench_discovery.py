"""A new cell, per-layer metric or kernel class is found by its file
alone: no code of the harness names one."""
import json
import shutil
from pathlib import Path

from benchmark import harness, trace

BENCH = Path(__file__).resolve().parents[1]


def test_workload_file_found_without_code(tmp_path):
    d = tmp_path / "workloads"
    shutil.copytree(BENCH / "workloads", d)
    wl = json.loads((d / "infill.720p.24f.json").read_text())
    wl.update(name="infill.1080p.12f", traffic_name="clip.1080p.12f")
    wl["traffic"] = dict(wl["traffic"], frames=12, height=1080, width=1920)
    (d / "infill.1080p.12f.json").write_text(json.dumps(wl))
    got = harness.workload("infill.1080p.12f", directory=d)
    assert got["traffic"]["height"] == 1080
    assert harness.entry_class(got["entry"]).__name__ == "Entry"


def test_kernel_class_file_found_without_code(tmp_path):
    d = tmp_path / "kernel_classes"
    shutil.copytree(BENCH / "kernel_classes", d)
    classes = trace.kernel_classes(d)
    assert trace.classify("my_fused_glue_kernel", classes) == trace.OTHER
    (d / "fused.json").write_text(json.dumps(
        {"order": 5, "patterns": ["my_fused"]}))
    assert trace.classify("my_fused_glue_kernel",
                          trace.kernel_classes(d)) == "fused"


def test_metrics_listed_for_a_cell_come_from_the_spec():
    spec = {"per_layer": [{"name": "a.x", "workloads": ["c1"]},
                          {"name": "b.x"},
                          {"name": "c.x", "workloads": ["c2"]}]}
    assert [m["name"] for m in harness.metrics_for(spec, "per_layer", "c1")] \
        == ["a.x", "b.x"]


def test_metric_reader_loads_from_a_dotted_file(tmp_path):
    p = tmp_path / "new_ms.infill.py"
    p.write_text("def read(t):\n    return 1.5\n")
    assert harness.load_file(p, "m").read(None) == 1.5


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "videovanish_tpu_torch_x",
                        types.ModuleType("videovanish_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxish", types.ModuleType("jaxish"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
