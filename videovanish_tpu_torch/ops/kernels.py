"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface and loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go to `build/vv_kernels/` at the root
of the checkout (`build/` is git-ignored), named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
`build()` starts one `nvcc` per missing library, all at once, and waits for
all of them; `nvcc -Xptxas -v` output (registers, shared memory, spills)
is kept in a `.log` beside each library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vv_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEADERS = ("mma_bf16.cuh", "hopper.cuh", "attn_bwd.cuh")

_P = ctypes.c_void_p
_I = ctypes.c_int
# B, H, Sq, Sk, D, the strides, the scale times log2(e), the stream
_DIMS = [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_float, _P]
# name -> (source, {C function: (restype, argtypes)})
LIBRARIES = {
    "flash_attn": ("flash_attn.cu", {
        # q, k, v, o, lse (or null)
        "vv_flash_attn_fwd": (_I, [_P] * 5 + _DIMS),
        "vv_flash_supported": (_I, [_I]),
    }),
    "small_seq_attn": ("small_seq_attn.cu", {
        "vv_small_seq_attn": (_I, [_P] * 4 + _DIMS),
        "vv_small_seq_supported": (_I, [_I, _I, _I]),
    }),
    "flash_attn_bwd": ("flash_attn_bwd.cu", {
        # q, k, v, o, dO, dq, dk, dv, lse, delta (scratch)
        "vv_flash_attn_bwd": (_I, [_P] * 10 + _DIMS),
        "vv_flash_bwd_supported": (_I, [_I]),
    }),
    "small_seq_attn_bwd": ("small_seq_attn_bwd.cu", {
        # q, k, v, o, dO, dq, dk, dv
        "vv_small_seq_attn_bwd": (_I, [_P] * 8 + _DIMS),
        "vv_small_seq_bwd_supported": (_I, [_I, _I, _I]),
    }),
}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = LIBRARIES[name][0]
    h = hashlib.sha256()
    for f in (src, *HEADERS):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(LIBRARIES)) -> dict[str, Path]:
    """Compile every library of `names` that is not built yet, one nvcc
    process per source, all started together. Raises with the compiler's
    output if any of them fails. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    jobs = []
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log_path = so.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[name][0])]
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, so, tmp, log_path, proc))
    failed = []
    for name, so, tmp, log_path, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log_path.read_text()[-4000:]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in LIBRARIES[name][1].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib
