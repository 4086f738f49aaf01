"""Hang/stuck-process debugging.

Equivalent of the reference's SIGUSR2 stack dumper
(src/utils/signals.py:21-101): on SIGUSR2, write every thread's stack to
`stacktraces-{pid}.log` (honoring AMLT_OUTPUT_DIR like the reference) and
optionally forward the signal to child processes.  Registration is opt-in,
same as the reference.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import traceback


def dump_all_stacks(out=None) -> str:
    lines = []
    for thread in threading.enumerate():
        lines.append(f"--- thread {thread.name} (ident {thread.ident}) ---")
        frame = sys._current_frames().get(thread.ident)
        if frame is not None:
            lines.extend(l.rstrip() for l in traceback.format_stack(frame))
    text = "\n".join(lines) + "\n"
    if out:
        out.write(text)
    return text


def _child_pids() -> list[int]:
    try:
        out = []
        me = os.getpid()
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = int(f.read().split()[3])
                if ppid == me:
                    out.append(int(pid))
            except (OSError, IndexError, ValueError):
                continue
        return out
    except OSError:
        return []


def register_print_stack_on_sigusr2(propagate: bool = False, out_dir: str | None = None):
    """Install the SIGUSR2 handler.  `kill -USR2 <pid>` then inspect
    stacktraces-<pid>.log."""
    out_dir = out_dir or os.environ.get("AMLT_OUTPUT_DIR") or os.getcwd()

    def handler(signum, frame):
        path = os.path.join(out_dir, f"stacktraces-{os.getpid()}.log")
        with open(path, "a") as f:
            f.write(f"=== SIGUSR2 stack dump (pid {os.getpid()}) ===\n")
            dump_all_stacks(f)
        if propagate:
            for pid in _child_pids():
                try:
                    os.kill(pid, signal.SIGUSR2)
                except OSError:
                    pass

    signal.signal(signal.SIGUSR2, handler)
