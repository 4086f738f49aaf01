"""Start a world of ranks for the mesh (no counterpart in the JAX package: XLA
runs one SPMD program over every device and needs no launcher).

``launch(fn, n, device_type)`` runs ``fn(rank, *args)`` on each rank of a
world of n processes and returns their results in rank order:

  * the ranks are spawned (``torch.multiprocessing``, the ``spawn`` start
    method) and meet through a ``FileStore`` in a temporary directory;
  * the backend is NCCL on the card, one rank a card, and gloo on the CPU
    (``backend="gloo"`` on the card lets several ranks share one card, as a
    rehearsal: NCCL does not put two ranks on one device);
  * each rank calls ``torch.cuda.set_device(local_rank)`` before anything is
    built (``utils.device.require_cuda`` returns the current device), and
    takes ``threads`` torch threads;
  * an exception on any rank fails the whole world: the other ranks are
    terminated and ``launch`` raises with that rank's traceback; nothing is
    caught and carried on;
  * a run has no deadline unless the caller gives ``timeout_s`` (a check
    that must end in bounded time); a collective that hangs fails at the
    process group's own timeout (``torch.distributed``'s default, or
    ``timeout_s``);
  * under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) it joins that world
    instead, runs ``fn`` in this process and returns its result alone;
  * a matmul precision chosen in this process
    (``utils.device.set_matmul_precision``, the CLI's ``--matmul-precision``)
    is set on every spawned rank before ``fn`` runs; the kernels' mode
    reaches them through the environment (``AI2BMD_KERNEL_MM_PRECISION``).

A spawned rank imports the module of ``fn`` afresh, so ``fn`` lives in a
module that imports what the rank needs and no more.  Results cross
processes pickled; tensors in them come back as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ai2bmd_torch.utils import device as D


@dataclasses.dataclass(frozen=True)
class Rank:
    """Where a rank runs: its rank in the world, the world's size, its rank on
    its host, and its device."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device


def under_torchrun() -> bool:
    """Whether this process is a rank of a world that ``torchrun`` started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _to_host(obj):
    """``obj`` with every tensor in it (in dicts, lists, tuples) as numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _run_rank(fn, args, rank: int, n: int, local_rank: int, device_type: str,
              backend: str | None, store_path: str | None, timeout_s: float | None,
              threads: int | None, precision: str | None = None):
    if threads:
        torch.set_num_threads(threads)
    if precision is not None:
        D.set_matmul_precision(precision)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store_path is None:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=n, **kw)
    else:
        dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                                world_size=n, **kw)
    try:
        return fn(Rank(rank, n, local_rank, device), *args)
    finally:
        dist.destroy_process_group()


def _child(fn, args, rank, n, device_type, backend, store_path, timeout_s, threads, precision,
           results):
    try:
        out = _run_rank(fn, args, rank, n, rank, device_type, backend, store_path, timeout_s,
                        threads, precision)
        results.put((rank, True, _to_host(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(fn, n: int, device_type: str = "cuda", args: tuple = (), backend: str | None = None,
           timeout_s: float | None = None, threads: int | None = 1) -> list:
    """``fn(rank, *args)`` on every rank of a world of ``n``; the results in
    rank order.  ``device_type`` "cuda" (one rank a card, NCCL unless
    ``backend`` says otherwise) or "cpu" (gloo).  Raises if any rank raises,
    exits without a result, or the world outlasts ``timeout_s`` (None: no
    deadline)."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    if under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"torchrun started {world} ranks, this run needs {n}")
        return [_run_rank(fn, args, int(os.environ["RANK"]), n,
                          int(os.environ.get("LOCAL_RANK", 0)), device_type, backend, None,
                          timeout_s, None)]
    if device_type == "cuda" and (backend or "nccl") == "nccl":
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(f"an NCCL world of {n} ranks needs {n} cards, this machine has "
                             f"{cards} (NCCL does not put two ranks on one device)")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ai2bmd_world_")
    results = ctx.Queue()
    precision = D.chosen_matmul_precision()
    procs = [ctx.Process(target=_child, args=(fn, args, r, n, device_type, backend,
                                              os.path.join(tmp, "store"), timeout_s, threads,
                                              precision, results))
             for r in range(n)]
    got: dict[int, object] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while len(got) < n and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        # its message may still be in flight
                        time.sleep(1.0)
                        if results.empty():
                            failure = f"rank {r} exited with code {p.exitcode} and no result"
                        break
                if failure is None and deadline is not None and time.monotonic() > deadline:
                    failure = f"the world of {n} ranks outlasted {timeout_s:.0f} s"
                continue
            if ok:
                got[rank] = payload
                continue
            failure = f"rank {rank} failed:\n{payload}"
            # the other ranks' errors follow (often lost connections): report them too
            end = time.monotonic() + 2.0
            while time.monotonic() < end:
                try:
                    rank, ok, payload = results.get(timeout=max(0.0, end - time.monotonic()))
                except queue.Empty:
                    break
                if not ok:
                    failure += f"\nrank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if (failure is not None or len(got) < n) and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(n)]


def is_rank0() -> bool:
    """True outside a world and on rank 0 of one."""
    return not dist.is_initialized() or dist.get_rank() == 0
