"""utils/cuda_build.py's kernel table against the sources under csrc/, and
its binding and launch on the CPU with a stand-in library.

A wrong ctypes signature corrupts a kernel's arguments without an error, so
each row's argument kinds are read back from its source's extern "C" entry
point: every csrc/*.cu has one row and every row a source, the entry point
takes the row's kinds in order with the stream last, and its launches are
counted under the kernel's own name in utils/trace.py.
"""

import ctypes
import re

import pytest
import torch

from styl3r_tpu_torch.utils import cuda_build, trace

NAMES = sorted({path.stem for path in cuda_build.CSRC.glob("*.cu")} | set(cuda_build.KERNELS))
KIND = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_longlong: "l"}


def _kind(param: str) -> str:
    """p, i or l of one C parameter (`const void* x`, `int n`, `long long s`)."""
    ctype = " ".join(param.split()[:-1])
    if ctype.endswith("*"):
        return "p"
    return {"int": "i", "long long": "l"}[ctype]


@pytest.mark.parametrize("name", NAMES)
def test_each_source_has_one_row_whose_signature_is_its_entry_points(name):
    assert name in cuda_build.KERNELS, f"csrc/{name}.cu has no row in cuda_build.KERNELS"
    source = cuda_build.CSRC / f"{name}.cu"
    assert source.exists(), f"cuda_build.KERNELS[{name!r}] has no source {source}"
    found = re.findall(rf'extern "C"\s*(?:\{{[^{{}}]*)?\bint\s+{name}\s*\(([^)]*)\)', source.read_text())
    assert len(found) == 1, f"{source.name}: {len(found)} extern \"C\" entry points named {name}"
    params = [" ".join(p.split()) for p in found[0].split(",")]
    assert "".join(_kind(p) for p in params) == cuda_build.KERNELS[name].args + "p", params
    assert params[-1] == "void* stream", params
    assert name in trace.COUNTERS


@pytest.mark.parametrize("name", sorted(cuda_build.KERNELS))
def test_launch_binds_the_rows_types_passes_the_stream_last_raises_and_counts(name, monkeypatch):
    row = cuda_build.KERNELS[name]
    calls = []

    class Entry:
        rc = 0

        def __call__(self, *args):
            calls.append(args)
            return self.rc

    entry = Entry()

    class Library:
        def __init__(self, path):
            assert path == "stand-in.so"

        def __getattr__(self, attr):
            assert attr == name
            return entry

    monkeypatch.setattr(cuda_build, "_bound", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", Library)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)

    assert cuda_build.bind(name, "stand-in.so") is entry
    assert "".join(KIND[t] for t in entry.argtypes) == row.args + "p" and entry.restype is ctypes.c_int
    args = tuple(range(len(row.args)))
    before = trace.counters()[name]
    cuda_build.launch(name, torch.device("cuda", 0), *args)
    assert calls == [(*args, 1000)]
    assert trace.counters()[name] == before + row.launches
    entry.rc = 700
    with pytest.raises(RuntimeError, match=f"^{name} kernel launch failed with CUDA error 700$"):
        cuda_build.launch(name, torch.device("cuda", 0), *args)
    assert trace.counters()[name] == before + row.launches
