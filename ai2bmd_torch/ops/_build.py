"""Build ``ops/csrc/*.cu`` with nvcc at first use and bind it with ctypes.

The kernels have a plain ``extern "C"`` interface (pointers, ints, floats and
the CUDA stream), so they compile without PyTorch's headers in seconds.  Each
source compiles in its own nvcc process, all started together, and one more
links the objects.  The edge kernels' sources (``STORE_SOURCES``) compile
twice, in parallel: for float storage and, with ``-DAI2BMD_STORE_BF16``,
for bfloat16 (their ``*_bf16_launch`` entry points, ``csrc/common.cuh``),
so every mode's library holds both instantiations and the float objects
are what they were.  One library a product mode (``MODES``: ``b3``, the
production mode, ``highest`` and ``default``; ``-DAI2BMD_MM_MODE``,
``csrc/common.cuh``), each built when its mode is first used, so the
production build keeps its time.  A library goes to ``build/ai2bmd_torch/``
at the root of the checkout, named by its mode and a hash of the sources and
flags; one that already exists for the same hash is loaded as it is.  A
failed build or launch raises, naming the mode; no mode runs another's
library.

``MM_MODE`` is the mode the wrappers launch from (``ops.vismp`` sets it from
``AI2BMD_KERNEL_MM_PRECISION``), and ``LIBRARY_LAUNCHES[mode]`` counts the
launches ``call`` made from each mode's library (``ops.reset_launches``
empties it), so a run can show which library its kernels came from.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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

# the sources with a bfloat16-storage instantiation, compiled once more
STORE_SOURCES = ("edge_fwd.cu", "edge_bwd_msg.cu", "edge_bwd_upd.cu")
# the products' mode -> AI2BMD_MM_MODE (csrc/common.cuh)
MODES = {"b3": 0, "highest": 1, "default": 2}
MM_MODE = "b3"
LIBRARY_LAUNCHES: dict[str, int] = {}

_libs: dict[str, ctypes.CDLL] = {}
# the last build's mode, path, seconds, whether it was cached, ptxas's report
# and the seconds each source's nvcc took to end (units)
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


def _flags(mode: str) -> list[str]:
    if mode not in MODES:
        raise ValueError(f"no kernel library for product mode {mode!r}; modes: {sorted(MODES)}")
    return [*NVCC_FLAGS, f"-DAI2BMD_MM_MODE={MODES[mode]}"]


def build(mode: str = "b3") -> Path:
    """Compile this mode's kernels unless a library for the same sources and
    flags exists."""
    flags = _flags(mode)
    h = hashlib.sha256(" ".join([*flags, *STORE_SOURCES]).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libai2bmd_kernels_{mode}_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(mode=mode, path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{mode}.{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    units = [(src, "", []) for src in sorted(CSRC.glob("*.cu"))]
    units += [(CSRC / name, ".bf16", ["-DAI2BMD_STORE_BF16"]) for name in STORE_SOURCES]
    for src, kind, extra in units:
        obj = BUILD_DIR / f"{src.stem}{kind}.{tag}.o"
        cmd = [nvcc, *flags, *extra, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    def finish(job):        # each job's output, and its end after the start of the build
        stdout, stderr = job[2].communicate()
        return stdout, stderr, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(finish, jobs))
    log, failed, units = [], [], {}
    for (cmd, obj, proc), (stdout, stderr, end) in zip(jobs, done):
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        units[obj.name.split(f".{tag}")[0]] = end
        if proc.returncode != 0:
            failed.append(f"{obj.name} (code {proc.returncode}):\n{stderr[-8000:]}")
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
    (BUILD_DIR / f"last_build_{mode}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed to build the {mode!r} kernel library:\n"
                           + "\n".join(failed))
    os.replace(tmp, out)
    BUILD_INFO.update(mode=mode, path=str(out), seconds=seconds, cached=False,
                      ptxas="\n".join(log), units=units)
    return out


def library(mode: str = "b3") -> ctypes.CDLL:
    """This mode's library, built at its first use."""
    lib = _libs.get(mode)
    if lib is None:
        lib = ctypes.CDLL(str(build(mode)))
        lib.ai2bmd_error_string.argtypes = [I]
        lib.ai2bmd_error_string.restype = ctypes.c_char_p
        _libs[mode] = lib
    return lib


def call(name: str, argtypes: list, *args) -> None:
    """Launch ``name`` from ``MM_MODE``'s library on PyTorch's current stream
    and count it in ``LIBRARY_LAUNCHES``.

    ``args`` exclude the trailing stream argument; a nonzero return code
    (the ``cudaGetLastError`` after the launch) raises, naming the mode."""
    mode = MM_MODE
    lib = library(mode)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, P]
        fn.restype = I
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.ai2bmd_error_string(rc).decode()
        raise RuntimeError(f"{name} ({mode} library) failed to launch: CUDA error {rc} ({msg})")
    LIBRARY_LAUNCHES[mode] = LIBRARY_LAUNCHES.get(mode, 0) + 1


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
