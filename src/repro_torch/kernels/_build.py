"""Build a CUDA source of this package with ``nvcc`` and load it with ctypes.

Each kernel source exports plain C functions; the wrapper module binds
their ``argtypes``. The shared library is built at first use into
``build/repro_torch_kernels/`` (listed in ``.gitignore``), under a name
that hashes the source and the flags, so an edited source or flag set
never loads a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# IEEE division and true f32/f64 arithmetic throughout: no --use_fast_math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_library(src: Path) -> Tuple[ctypes.CDLL, str]:
    """Compile ``src`` (or reuse the library built from the same source and
    flags) and load it. Returns the library and the compiler's resource
    report (``-Xptxas -v``; empty when the library was already built)."""
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    log = ""
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: cannot build the CUDA kernel {src.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        log = proc.stderr
    return ctypes.CDLL(str(lib_path)), log
