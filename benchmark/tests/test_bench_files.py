"""Every data file of the benchmark loads, and every name and unit keeps to
the characters the benchmark's contract allows."""
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DATA = sorted(p for p in BENCH.rglob("*.json"))


@pytest.mark.parametrize("path", DATA, ids=lambda p: str(p.relative_to(BENCH)))
def test_data_file_loads(path):
    json.loads(path.read_text())


def test_benchmark_json_names_and_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert (wl["config"], wl["chips"], wl["traffic_name"]) == \
            (w["config"], w["chips"], w["traffic"])
        assert (BENCH / "entries" / f"{wl['entry']}.py").is_file()
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        wl = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        assert wl["rate_metric"] in e2e
        assert any(cell in m.get("workloads", [cell])
                   for m in spec["per_layer"])


def test_every_path_is_a_name():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = str(p.relative_to(ROOT))
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
