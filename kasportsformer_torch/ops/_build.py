"""Build the hand-written CUDA kernels with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and includes no PyTorch
header (only the repository's own `csrc/*.cuh`), so it compiles in seconds.
It is compiled for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into `build/kernels/` under the
repository root (a directory `.gitignore` lists) the first time a kernel is
needed. The library's file name carries a hash of its source, the shared
headers and the flags, so an edited source is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("masked_sdpa", "masked_sdpa_bwd", "mlp_ln", "mlp_ln_bwd", "mlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# the compiler's `-Xptxas -v` report of each source this process built
PTXAS: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    """Start one nvcc into a temporary file beside the final library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, dict]:
    """Compile every named kernel source in parallel (one nvcc each, all
    started together) and load them. Returns, per source, the seconds from
    the common start to its library being ready and the compiler's
    `-Xptxas -v` report (registers, shared memory, spills)."""
    report: dict[str, dict] = {}
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names
                   if n not in _libs and not library_path(n).exists()}
        for n, job in started.items():
            log = _finish(n, *job)
            report[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
            PTXAS[n] = log
        for n in names:
            if n not in _libs:
                lib = ctypes.CDLL(str(library_path(n)))
                lib.kasf_error_string.argtypes = [ctypes.c_int]
                lib.kasf_error_string.restype = ctypes.c_char_p
                _libs[n] = lib
            report.setdefault(n, {"seconds": 0.0, "ptxas": "(cached)"})
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def bind(name: str, sym: str, argtypes: list) -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library of `csrc/<name>.cu` and its C function `sym`, typed with
    `argtypes` and an int (cudaError_t) result on first use."""
    lib = library(name)
    fn = getattr(lib, sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (its cudaGetLastError())."""
    if code != 0:
        msg = lib.kasf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a contiguous copy of it, whose data and every row start on a
    16-byte boundary: the kernels move their operands in 16-byte (f32) or
    8-byte (bf16) vectors. The model's operands (projection slices, permuted
    views, parameters) pass through uncopied."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * size % 16 == 0
                                      for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)
