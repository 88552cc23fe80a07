"""The port (videovanish_tpu_torch), chip_smoke.py and the port's profile
scripts import nothing of JAX, nothing of the JAX package, and neither cv2
nor the safetensors, regex and transformers packages (the port keeps its
own .safetensors reader and pre-tokenizer and needs torch alone), checked
on the source with `ast`; and chip_smoke.py refuses to run without a CUDA
device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "videovanish_tpu", "cv2", "safetensors",
             "regex", "transformers")
SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 (ROOT / "videovanish_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "scripts/profile_port_infill.py",
       "scripts/profile_port_sam2.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("rel", SOURCES)
def test_port_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_package_found():
    assert len(SOURCES) > 10


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card here: chip_smoke.py exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
