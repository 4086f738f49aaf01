"""The native runtime: an asynchronous trajectory writer in C++.

Port of ``ai2bmd_tpu/runtime/__init__.py``.  ``AsyncTrajectoryWriter``
copies each frame into a queue and returns; a worker thread of
``traj_writer.cpp`` writes the DCD and XYZ files, byte for byte what the
Python writers of ``io/trajectory.py`` write, except the DCD title (``Created
by ai2bmd-torch native runtime``).  ``md.simulation.Simulator`` uses it when
it builds and opens, and the Python writers otherwise, as the JAX package's
does.

Where it differs from the JAX package's loader:
  * Build location.  The library is built with g++ (``-O2 -shared -fPIC
    -std=c++17 ... -lpthread``) into ``build/ai2bmd_torch/`` at the root of
    the checkout (beside the kernel libraries of ``ops/_build.py``), never
    next to the source; JAX's builds next to its source and rebuilds by
    mtime.
  * Cache and concurrency.  The library's name carries a hash of the source
    and flags; one that exists is loaded as it is.  A build compiles to a
    name of its own process and is ``os.replace``d into place, so processes
    that build at once (test workers, CLI subprocesses) never load a
    half-written file.
  * Guards.  ``write`` refuses a frame whose shape is not ``(n_atoms, 3)``
    (JAX's copies ``3 n_atoms`` floats from whatever it is given);
    ``pending`` after ``close`` raises ``RuntimeError`` (JAX's hands C a null
    handle); an IO failure in the worker (a short write, a failed close)
    raises ``OSError`` from the next ``write`` after the worker met it and
    from ``close``, as the Python writers raise from their ``write`` or
    ``close`` (``traj_write`` returns -2 once the worker has failed,
    ``traj_close`` 0 or -1; JAX's report nothing).

``library()`` builds and loads the library, raising ``RuntimeError`` that
names why it cannot (no g++, a failed build); ``native_available()`` says
whether it can.  ``BUILD_INFO`` holds the last build's path, seconds and
whether it was cached.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ai2bmd_torch.io.pdb import SYMBOLS

SOURCE = Path(__file__).resolve().parent / "traj_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ai2bmd_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def build() -> Path:
    """Compile ``traj_writer.cpp`` unless a library for the same source and
    flags exists; raise ``RuntimeError`` on failure."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libai2bmd_runtime_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (code {proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, cached=False)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built at first use.  A failure is kept: later
    calls raise the same ``RuntimeError``."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                _error = str(e)
            else:
                lib.traj_open.restype = ctypes.c_void_p
                lib.traj_open.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)]
                lib.traj_write.restype = ctypes.c_int
                lib.traj_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_double, ctypes.c_long]
                lib.traj_pending.restype = ctypes.c_long
                lib.traj_pending.argtypes = [ctypes.c_void_p]
                lib.traj_close.restype = ctypes.c_int
                lib.traj_close.argtypes = [ctypes.c_void_p]
                _lib = lib
        if _lib is None:
            raise RuntimeError(f"native runtime unavailable: {_error}")
        return _lib


def native_available() -> bool:
    try:
        library()
        return True
    except RuntimeError:
        return False


class AsyncTrajectoryWriter:
    """Background-thread trajectory writer (DCD and/or XYZ; a path of None
    writes no such file).  ``cell``: orthorhombic box lengths for the DCD's
    unit-cell records.  Raises ``RuntimeError`` when the library is
    unavailable and ``OSError`` when a file cannot be opened."""

    def __init__(self, dcd_path: str | None, xyz_path: str | None, numbers,
                 timestep_fs: float = 1.0, save_interval: int = 1, cell=None):
        lib = library()
        self._lib = lib
        self.n_atoms = len(numbers)
        symbols = " ".join(SYMBOLS[int(z)] for z in numbers)
        cell_ptr = None
        if cell is not None:
            cell_arr = np.ascontiguousarray(cell, dtype=np.float64)
            cell_ptr = cell_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._h = lib.traj_open((dcd_path or "").encode(), (xyz_path or "").encode(),
                                self.n_atoms, float(timestep_fs), int(save_interval),
                                symbols.encode(), cell_ptr)
        if not self._h:
            raise OSError(f"could not open trajectory outputs {dcd_path} / {xyz_path}")
        self.paths = (dcd_path, xyz_path)

    def write(self, positions, energy: float = 0.0, step: int = 0):
        """Queue one frame ([n_atoms, 3], copied before this returns); raise
        ``OSError`` once the worker has failed to write an earlier one."""
        if not self._h:
            raise RuntimeError("write on closed trajectory")
        arr = np.ascontiguousarray(positions, dtype=np.float32)
        if arr.shape != (self.n_atoms, 3):
            raise ValueError(f"frame of shape {arr.shape}; this trajectory takes "
                             f"({self.n_atoms}, 3)")
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        rc = self._lib.traj_write(self._h, ptr, float(energy), int(step))
        if rc == -2:
            raise OSError(f"writing trajectory outputs {self.paths[0]} / {self.paths[1]} "
                          f"failed")
        if rc != 0:
            raise RuntimeError("write on closed trajectory")

    def pending(self) -> int:
        """Frames queued and not yet taken by the worker."""
        if not self._h:
            raise RuntimeError("pending on closed trajectory")
        return int(self._lib.traj_pending(self._h))

    def close(self):
        """Drain the queue, patch the DCD header and close the files; raise
        ``OSError`` if any write or close failed."""
        if self._h:
            h, self._h = self._h, None
            if self._lib.traj_close(h) != 0:
                raise OSError(f"writing trajectory outputs {self.paths[0]} / {self.paths[1]} "
                              f"failed")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
