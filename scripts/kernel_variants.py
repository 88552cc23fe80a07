"""Build edited copies of one of the port's CUDA sources, for the probes
`scripts/flash_ablation.py` and `scripts/small_seq_ablation.py`.

A variant is the source in `videovanish_tpu_torch/ops/csrc/` with a list of
(pattern, replacement) edits applied, or another copy of the source (an
earlier version, with its own headers). Every variant is compiled with the
port's nvcc flags, all at once, and bound like the port's own library.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def variant_source(cu: str, edits) -> str:
    """The text of csrc/<cu> with each (pattern, replacement) applied by
    re.subn; a pattern that matches nothing raises."""
    from videovanish_tpu_torch.ops import kernels
    src = (kernels.CSRC / cu).read_text()
    for pattern, repl in edits:
        src, n = re.subn(pattern, repl, src)
        if n == 0:
            raise RuntimeError(f"pattern not in {cu}: {pattern}")
    return src


def build(library: str, sources: dict, out: Path) -> dict[str, ctypes.CDLL]:
    """Compile {name: (source text, include directory or None)} into
    out/<name>.so, one nvcc per variant started together; print every
    ptxas line that reports spills; bind the C functions that
    kernels.LIBRARIES[library] names. Returns {name: library}."""
    from videovanish_tpu_torch.ops import kernels
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
               str(include or kernels.CSRC), "-o", str(out / f"{name}.so"),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    fns = kernels.LIBRARIES[library][1]
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        for line in log.splitlines():
            if "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"[ptxas] {name}: {line.strip()}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, (restype, argtypes) in fns.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs
