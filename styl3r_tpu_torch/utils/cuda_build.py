"""Build, bind and launch the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C entry point `<name>` and is compiled
by nvcc into its own shared library, loaded with ctypes. Libraries go into
`styl3r_tpu_torch/_build/` (ignored by git), named by a hash of their source,
so an edited source is rebuilt and a built one is reused. Nothing here runs
at import time: the first launch builds every kernel not yet built, as
`build(KERNELS)` does, one nvcc process per source, all started together.

`KERNELS` holds one row per source, and `launch(name, device, *args)` is
the one place a kernel is launched: on the current stream of `device`,
raising on a launch error, and counted under `name` in utils/trace.py. A
new kernel is a row here and a `launch` call in its wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class Kernel(NamedTuple):
    flags: Tuple[str, ...]  # nvcc flags after NVCC_FLAGS; both go into the library's hash
    args: str  # the entry point's arguments before the stream, which comes last: p pointer, i int, l long long
    launches: int = 1  # kernel launches a call of the entry point makes


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}

# Every kernel source under csrc/, by name: the source's stem, its entry
# point and its launch counter (tests/test_torch_cuda_build.py holds each
# row's argument kinds against the entry point's parameters).
KERNELS = {
    # Both contract multiply-adds, except in the values that decide the masks
    # (power, alpha >= 1/255), which the sources round operation by operation
    # as PyTorch's separate elementwise ops do, so a threshold test decides
    # the same way in a kernel and in its plain version. The forward runs
    # faster at 40 registers a thread than at the 48 ptxas picks by itself
    # (scripts/composite_fwd_variants.py, PERF.md).
    "composite_fwd": Kernel(("-maxrregcount=40",), "p" * 9 + "i" * 5),
    "composite_bwd": Kernel((), "p" * 10 + "i" * 5, launches=2),
    # Rounds every product and sum with __fmul_rn / __fadd_rn (never
    # contracted), as PyTorch's separate elementwise ops round them.
    "rope2d": Kernel((), "iiiiip" + "pllpllpi" * 2),
    # Contracts every multiply-add (FFMA), in a fixed order.
    "conv3x3_f32": Kernel((), "p" * 4 + "i" * 9 + "pp"),
}

_bound: Dict[str, Callable[..., int]] = {}  # name -> the entry point launch() calls
trace = None  # utils/trace.py, imported at the first bind(): it imports this module for KERNELS


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def nvcc_flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *KERNELS[name].flags)


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
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


def bind(name: str, library: Optional[str] = None) -> Callable[..., int]:
    """Binds the entry point `name` of `library` with its KERNELS row's
    argument types, and makes launch(name, ...) call it from now on. The
    library defaults to the build of csrc/<name>.cu; its first bind builds
    every kernel not yet built, all in parallel, so the path's later kernels
    cost no serial compile."""
    global trace
    from . import trace

    if library is None:
        build()
        library = str(library_path(name))
    fn = getattr(ctypes.CDLL(library), name)
    fn.argtypes = [_CTYPES[kind] for kind in KERNELS[name].args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _bound[name] = fn
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Calls the entry point `name` with `args` and the current stream of
    `device` (a CUDA device with its index), on that device; raises on a
    nonzero CUDA error and counts the row's launches under `name`."""
    fn = _bound.get(name) or bind(name)
    # The raw stream, not current_stream().cuda_stream: the same pointer
    # without building a Stream object, which costs as much as a launch.
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    trace.count(name, KERNELS[name].launches)
