"""Build and bind the CUDA kernels of `kernels/csrc/`.

Each `.cu` source is compiled by its own `nvcc` process for `sm_90a` (all
started together), then linked into one shared library with a plain C
interface, loaded with `ctypes`. Nothing is built at import: the first
kernel launch builds, into `build/repro_torch_kernels/` at the root of the
checkout. The library's name carries a hash of the sources and flags, so a
changed source never loads a stale build. Every C entry point returns
`cudaGetLastError()` after its launch; `check` raises when it is not 0.

The wrappers launch through `launch` and count through `count`, both safe
for the shard threads of a sharded fit (`dist.group.spmd`): `launch` makes
the tensors' card the current device for the call (the current device is
a thread's own), and `count` adds to a wrapper's `launches` under a lock,
so no two threads lose a count.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argument types (pointers and the stream as
# c_void_p, ints as c_int or c_longlong, floats as c_float). All return an
# int error code.
SIGNATURES = {
    "rt_histogram_private": [_P] * 5 + [_I] * 12 + [_P],
    "rt_histogram_rows": [_P] * 6 + [_I] * 12 + [_P],
    "rt_histogram_packed": [_P] * 5 + [_I] * 7 + [_P],
    "rt_histogram_dequantise": [_P] * 3 + [_L, _I, _P],
    "rt_fixed_exponent": [_P, _I, _P, _P, _L, _P],
    "rt_decompress": [_P] * 2 + [_I] * 4 + [_P],
    "rt_split_scan": [_P] * 6 + [_I] * 3 + [_F, _F, _P],
    "rt_empty_launch": [_P],
    "rt_quantile_cuts": [_P, _P, _P, _I, _I, _I, _P],
    "rt_ensemble_margins": [_P] * 3 + [_I] * 10 + [_P],
    "rt_pairwise_grad": [_P] * 7 + [_I, _P],
    "rt_histogram_occupancy": [_I] * 4 + [_P],
    "rt_capture_begin": [_P],
    "rt_capture_kernels": [_P, _P, _I, _P],
    "rt_device_limits": [_I, _P],
}


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of this process's build, 0.0 when cached
    ptxas: str  # nvcc's -Xptxas -v report: registers, shared memory, spills


_loaded: tuple[ctypes.CDLL, BuildInfo] | None = None
_load_lock = threading.Lock()  # one build and load, whichever thread asks first
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile and link the kernels unless this exact build exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    key = _digest()
    lib = BUILD_DIR / f"librepro_torch_kernels_{key}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists() and log.exists():
        return BuildInfo(lib, 0.0, log.read_text())
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{key}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    reports = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        reports.append(f"== {src.name}\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    report = "\n".join(reports)
    log.write_text(report)
    return BuildInfo(lib, time.perf_counter() - t0, report)


def library() -> tuple[ctypes.CDLL, BuildInfo]:
    """The loaded kernel library (built on first use) and its build info."""
    global _loaded
    with _load_lock:
        if _loaded is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded = (lib, info)
    return _loaded


def lib() -> ctypes.CDLL:
    return library()[0]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` with `args` and PyTorch's current
    stream on `device`, with `device` as the current device, and raise if
    the launch failed."""
    with torch.cuda.device(device):
        check(getattr(lib(), entry)(*args, stream(device)), entry.removeprefix("rt_"))


def count(wrapper) -> None:
    """One more launch of `wrapper` (its `launches`), under a lock."""
    with _count_lock:
        wrapper.launches += 1


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """A kernel argument must be a contiguous CUDA tensor of this dtype and
    rank; anything else raises (the kernels take no other layout)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the pointer the C side takes."""
    return torch.cuda.current_stream(device).cuda_stream


class DeviceLimits(NamedTuple):
    n_sm: int  # streaming multiprocessors
    smem_block: int  # opt-in shared memory a block may use, bytes
    smem_sm: int  # shared memory of one SM, bytes
    smem_reserved: int  # shared memory the system reserves for each block
    threads_sm: int  # resident threads one SM holds


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> DeviceLimits:
    """The card's SM count, shared-memory limits and threads per SM."""
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    attrs = (ctypes.c_int * 4)()
    check(lib().rt_device_limits(index, ctypes.addressof(attrs)), "rt_device_limits")
    return DeviceLimits(n_sm, *attrs)
