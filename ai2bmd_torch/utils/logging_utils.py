"""Output tee and metrics logging.

Port of ``ai2bmd_tpu/utils/logging_utils.py``: an in-process TeeWriter in
place of the reference's dup2-into-tee redirection (src/utils/system.py:
8-16, main.py:27-28), and a per-interval metrics CSV (step, epot, ekin,
etot, temperature, wall ms/step) whose columns and formats are the JAX
package's byte for byte.  ``untee_output`` undoes ``tee_output`` (an
in-process CLI run must leave ``sys.stdout``/``sys.stderr`` as it found
them).
"""

from __future__ import annotations

import os
import sys
import time


class TeeWriter:
    """Mirror a stream into a logfile (stdout/stderr tee)."""

    def __init__(self, stream, path: str):
        self.stream = stream
        self.file = open(path, "a", buffering=1)

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)
        return len(data)

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()


def tee_output(log_dir: str, name: str | None = None, path: str | None = None) -> str:
    """Mirror stdout+stderr into a timestamped logfile (or, given ``path``,
    append to that one); returns its path."""
    if path is None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(log_dir, f"{name or 'run'}-{stamp}.log")
    sys.stdout = TeeWriter(sys.stdout, path)
    sys.stderr = TeeWriter(sys.stderr, path)
    return path


def untee_output() -> None:
    """Undo ``tee_output``: restore the streams it wrapped, close its files."""
    for name in ("stdout", "stderr"):
        stream = getattr(sys, name)
        if isinstance(stream, TeeWriter):
            stream.flush()
            setattr(sys, name, stream.stream)
            stream.close()


class MetricsLog:
    """Append-only CSV of per-interval simulation metrics."""

    COLUMNS = ("step", "epot_eV", "ekin_eV", "etot_eV", "temp_K", "ms_per_step")

    def __init__(self, path: str):
        fresh = not os.path.exists(path)
        self.f = open(path, "a", buffering=1)
        if fresh:
            self.f.write(",".join(self.COLUMNS) + "\n")

    def write(self, step, epot, ekin, temp, ms_per_step):
        self.f.write(
            f"{step},{epot:.6f},{ekin:.6f},{epot + ekin:.6f},"
            f"{temp:.2f},{ms_per_step:.3f}\n"
        )

    def close(self):
        self.f.close()

