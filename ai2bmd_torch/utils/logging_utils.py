"""Output tee and metrics logging.

Port of ``ai2bmd_tpu/utils/logging_utils.py``: an in-process TeeWriter in
place of the reference's dup2-into-tee redirection (src/utils/system.py:
8-16, main.py:27-28), and a per-interval metrics CSV (step, epot, ekin,
etot, temperature, wall ms/step) whose columns and formats are the JAX
package's byte for byte.  ``untee_output`` undoes ``tee_output`` (an
in-process CLI run must leave ``sys.stdout``/``sys.stderr`` as it found
them).  ``StepTimer`` times named stages on the host clock, and
``profile_trace`` writes a ``torch.profiler`` Chrome trace (JAX's writes a
``jax.profiler`` trace) under ``log_dir/trace``.
"""

from __future__ import annotations

import contextlib
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


class StepTimer:
    """Wall-clock per-stage timing (the reference's @record_time,
    utils.py:17-25, generalized to named stages)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {1e3 * total / n:.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the block (host, and
    the card's kernels where there is a card), written on exit as a Chrome
    trace (chrome://tracing, Perfetto) into ``log_dir/trace``.  Yields the
    profiler; its ``trace_path`` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = os.path.join(log_dir, "trace")
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(out, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-"
                                        f"{os.getpid()}.json")
    prof.export_chrome_trace(prof.trace_path)
