"""Build ``ops/csrc/*.cu`` with nvcc at first use and bind it with ctypes.

The kernels have a plain ``extern "C"`` interface (pointers, ints, floats and
the CUDA stream), so they compile without PyTorch's headers in seconds.  Each
source compiles in its own nvcc process, all started together, and one more
links the objects.  The shared library goes to ``build/ai2bmd_torch/`` at
the root of the checkout, named by a hash of the sources and flags; a library
that already exists for the same hash is loaded as it is.  A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ai2bmd_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels unless a library for the same sources exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libai2bmd_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (code {proc.returncode}):\n{stderr[-8000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (code {proc.returncode}):\n{proc.stderr[-8000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "last_build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=seconds, cached=False, ptxas="\n".join(log))
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ai2bmd_error_string.argtypes = [I]
        lib.ai2bmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, argtypes: list, *args) -> None:
    """Launch ``name`` from the library on PyTorch's current stream.

    ``args`` exclude the trailing stream argument; a nonzero return code
    (the ``cudaGetLastError`` after the launch) raises."""
    lib = library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, P]
        fn.restype = I
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.ai2bmd_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32,
          device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
