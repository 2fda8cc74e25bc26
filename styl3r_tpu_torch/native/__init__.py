"""Native host data loading: batched JPEG decode and Lanczos resize
(counterpart of styl3r_tpu/native; `loader.cpp` here is the port's own copy
of its source).

g++ and libjpeg build `loader.cpp` at first use into the git-ignored
`styl3r_tpu_torch/_build/`, named by a hash of the source and the flags, as
utils/cuda_build.py does for the kernels; the flags are the JAX package's
Makefile's, since `-march=native` lets g++ contract the Lanczos sums into
FMAs and equal bits need the same contraction. Where the library cannot be
built or loaded (no g++, no `jpeglib.h`), each function returns None and
`unavailable_reason()` says why: the dataset then decodes with PIL, as the
JAX dataset does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")


class _Library:
    """The loaded library, or the reason there is none; built once a
    process."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.reason: Optional[str] = None
        self.tried = False


_state = _Library()


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join((*CXX_FLAGS, *LIBS)).encode())
    return BUILD_DIR / f"libstyl3r_io_{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the library into `out`; the reason it failed, or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError as exc:
        return f"cannot write {BUILD_DIR}: {exc}"
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LIBS], capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        return f"cannot run {cxx}: {exc}"
    if proc.returncode != 0:
        os.unlink(tmp)
        if "jpeglib.h" in proc.stderr:
            return "no jpeglib.h (libjpeg's headers are not installed)"
        last = proc.stderr.strip().splitlines()[-1:] or ["no output"]
        return f"{cxx} exited {proc.returncode}: {last[0]}"
    os.replace(tmp, out)  # atomic: concurrent builds leave one whole file
    return None


def _load() -> Optional[ctypes.CDLL]:
    if _state.tried:
        return _state.lib
    _state.tried = True
    path = library_path()
    if not path.exists():
        _state.reason = _build(path)
        if _state.reason is not None:
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        _state.reason = f"cannot load {path.name}: {exc}"
        return None
    lib.styl3r_decode_jpeg_batch.restype = ctypes.c_int
    lib.styl3r_decode_jpeg_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.styl3r_resize_lanczos_f32.restype = None
    lib.styl3r_resize_lanczos_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    _state.lib = lib
    return lib


def native_available() -> bool:
    """Whether the library is built (building it now if need be) and loaded."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded; None when it is
    loaded or was not tried yet."""
    return _state.reason


def decode_jpeg_batch(jpegs: List[bytes], out_shape: Tuple[int, int], num_threads: int = 8) -> Optional[np.ndarray]:
    """A batch of JPEG byte strings -> (n, h, w, 3) float32 in [0, 1], each
    frame of another shape than `out_shape` Lanczos-resized to it. None when
    the library is unavailable or any frame fails to decode (the caller
    decodes with PIL)."""
    lib = _load()
    if lib is None:
        return None
    n = len(jpegs)
    h, w = out_shape
    data = np.frombuffer(b"".join(jpegs), dtype=np.uint8)
    sizes = np.asarray([len(j) for j in jpegs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.zeros((n, h, w, 3), np.float32)
    ok = lib.styl3r_decode_jpeg_batch(
        data.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, n, out.ctypes.data, h, w, num_threads
    )
    return out if ok == n else None


def resize_lanczos(image: np.ndarray, out_shape: Tuple[int, int]) -> Optional[np.ndarray]:
    """(h, w, 3) float32 in [0, 1] -> Lanczos-resized (out_h, out_w, 3),
    through uint8 as the decoder's path; None when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(image, np.float32)
    h, w = out_shape
    out = np.zeros((h, w, 3), np.float32)
    lib.styl3r_resize_lanczos_f32(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, h, w)
    return out
