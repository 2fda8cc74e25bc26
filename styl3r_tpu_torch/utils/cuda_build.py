"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
into its own shared library, loaded with ctypes. Libraries go into
`styl3r_tpu_torch/_build/` (ignored by git), named by a hash of their source,
so an edited source is rebuilt and a built one is reused. Nothing here runs
at import time: the first wrapper call builds every kernel not yet built,
as `build(KERNELS)` does, one nvcc process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Flags of one kernel, after NVCC_FLAGS; both go into the library's hash.
KERNEL_FLAGS = {
    # Both contract multiply-adds, except in the values that decide the masks
    # (power, alpha >= 1/255), which the sources round operation by operation
    # as PyTorch's separate elementwise ops do, so a threshold test decides
    # the same way in a kernel and in its plain version. The forward runs
    # faster at 40 registers a thread than at the 48 ptxas picks by itself
    # (scripts/composite_fwd_variants.py, PERF.md).
    "composite_fwd": ("-maxrregcount=40",),
    "composite_bwd": (),
    # Rounds every product and sum with __fmul_rn / __fadd_rn (never
    # contracted), as PyTorch's separate elementwise ops round them.
    "rope2d": (),
    # Contracts every multiply-add (FFMA), in a fixed order.
    "conv3x3_f32": (),
}

# Every kernel source under csrc/, by name.
KERNELS = tuple(KERNEL_FLAGS)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def nvcc_flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *KERNEL_FLAGS[name])


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all in parallel.
    Returns each compiled kernel's nvcc output (register and shared-memory
    use); raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`. The first load builds every kernel not yet
    built, all in parallel, so the path's later kernels cost no serial
    compile."""
    if name not in _loaded:
        build(KERNELS)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
