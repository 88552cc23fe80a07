"""The port (videovanish_tpu_torch), chip_smoke.py and the port's profile
scripts import nothing of JAX, nothing of the JAX package, and neither the
safetensors, regex and transformers packages (the port keeps its own
.safetensors reader and pre-tokenizer), checked on the source with `ast`.
cv2, the JAX package's codec, is imported by the port's video files module
alone, and only inside its functions: importing the pipelines leaves it
unloaded, so the compute path needs torch alone. PySide6 is imported by the
GUI's window modules alone. chip_smoke.py refuses to run without a CUDA
device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "videovanish_tpu", "safetensors",
             "regex", "transformers")
CODEC = "cv2"
CODEC_MODULE = "videovanish_tpu_torch/video/io.py"
# the window's modules alone import Qt; these run without PySide6
QT = "PySide6"
QT_MODULES = {f"videovanish_tpu_torch/gui/{m}.py" for m in (
    "app", "dock", "main_window", "player", "view", "worker")}
SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 (ROOT / "videovanish_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "scripts/profile_port_infill.py",
       "scripts/profile_port_sam2.py", "scripts/chunk_prior_ab.py",
       "scripts/sam2_memory_probe.py", "scripts/mesh_phase.py"]


def _imported(tree):
    """Every module the source imports."""
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


def _imported_at_module_level(tree):
    """The modules imported outside any function."""
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside |= {id(n) for n in ast.walk(fn) if n is not fn}
    for node in ast.walk(tree):
        if id(node) in inside:
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.Call)):
            yield from _imported(node)


def _top(names):
    return {m.split(".")[0] for m in names}


@pytest.mark.parametrize("rel", SOURCES)
def test_port_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"
    if rel == CODEC_MODULE:
        assert CODEC in _top(_imported(tree))
        assert CODEC not in _top(_imported_at_module_level(tree)), \
            f"{rel} imports {CODEC} at module level"
    else:
        assert CODEC not in _top(_imported(tree)), f"{rel} imports {CODEC}"
    if rel not in QT_MODULES:
        assert QT not in _top(_imported(tree)), f"{rel} imports {QT}"


def test_pipelines_load_without_the_codec():
    """Importing the pipelines, the chunked pipeline, the CLIs, the GUI's
    jobs and the profiling module leaves cv2 out of sys.modules."""
    script = (
        "import sys\n"
        "import videovanish_tpu_torch.pipeline.infill\n"
        "import videovanish_tpu_torch.pipeline.masker\n"
        "import videovanish_tpu_torch.pipeline.chunking\n"
        "import videovanish_tpu_torch.cli.diffuerase\n"
        "import videovanish_tpu_torch.cli.sam2_masker\n"
        "import videovanish_tpu_torch.cli.compare\n"
        "import videovanish_tpu_torch.cli.videovanish\n"
        "import videovanish_tpu_torch.gui.jobs\n"
        "import videovanish_tpu_torch.utils.profiling\n"
        "print('cv2' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False"]


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
