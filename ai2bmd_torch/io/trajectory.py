"""Trajectory output and restart checkpoints.

Port of ``ai2bmd_tpu/io/trajectory.py``.  The writers and ``read_dcd`` are
numpy copies (extended XYZ; CHARMM/NAMD-style binary DCD, readable by VMD
and MDAnalysis), so the port writes the same bytes as the JAX package apart
from the DCD title, which names the port.

Restart checkpoints are npz files with the JAX package's keys where the
meaning is the same (``positions``, ``velocities``, ``step``, ``forces``,
``energy``, ``aux_0``: the port's aux is the cap-offset tensor [R,S,3], the
layout of JAX's ``initial_cap_delta``).  In place of JAX's threefry
``rng_key`` the port stores its generator's state (``rng_state``, the bytes
of ``torch.Generator.get_state()``); a file without it was written by the
JAX package.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ai2bmd_torch.io.pdb import SYMBOLS
from ai2bmd_torch.utils.tree import tree_leaves


class XYZTrajectory:
    def __init__(self, path: str, numbers: np.ndarray, append: bool = False):
        self.path = path
        self.symbols = [SYMBOLS[z] for z in numbers]
        self._f = open(path, "a" if append else "w")

    def write(self, positions: np.ndarray, energy: float | None = None, step: int = 0):
        n = len(self.symbols)
        comment = f"step={step}"
        if energy is not None:
            comment += f" energy_eV={energy:.6f}"
        self._f.write(f"{n}\n{comment}\n")
        for s, p in zip(self.symbols, positions):
            self._f.write(f"{s} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        self._f.flush()

    def close(self):
        self._f.close()


class DCDTrajectory:
    """Minimal CHARMM-format DCD writer (float32).

    When `cell` (orthorhombic box lengths [a, b, c] in Angstrom) is given,
    the header sets icntrl[10]=1 and every frame is preceded by the CHARMM
    XTLABC unit-cell record: 6 doubles (a, cos(gamma), b, cos(beta),
    cos(alpha), c), all cosines 0 for an orthorhombic box.
    """

    TITLE = b"Created by ai2bmd-torch"

    def __init__(self, path: str, n_atoms: int, timestep_fs: float = 1.0,
                 save_interval: int = 1, cell: np.ndarray | None = None):
        self.path = path
        self.n_atoms = n_atoms
        self.n_frames = 0
        self.cell = None if cell is None else np.asarray(cell, np.float64)
        self._f = open(path, "wb")
        # AKMA time unit = 48.88821 fs
        delta = timestep_fs * save_interval / 48.88821
        icntrl = [0] * 20
        icntrl[0] = 0                      # nframes (patched on close)
        icntrl[1] = 0                      # first step
        icntrl[2] = save_interval
        icntrl[3] = 0                      # total steps (patched)
        icntrl[9] = struct.unpack("i", struct.pack("f", delta))[0]
        icntrl[10] = 1 if self.cell is not None else 0   # unit-cell flag
        icntrl[19] = 24                    # CHARMM version
        hdr = b"CORD" + struct.pack("20i", *icntrl)
        self._record(hdr)
        self._record(struct.pack("i", 1) + self.TITLE.ljust(80))
        self._record(struct.pack("i", n_atoms))

    def _record(self, payload: bytes):
        marker = struct.pack("i", len(payload))
        self._f.write(marker + payload + marker)

    def write(self, positions: np.ndarray, cell: np.ndarray | None = None, **_kw):
        if self.cell is not None:
            c = self.cell if cell is None else np.asarray(cell, np.float64)
            a, b, cc = float(c[0]), float(c[1]), float(c[2])
            self._record(struct.pack("6d", a, 0.0, b, 0.0, 0.0, cc))
        pos = np.asarray(positions, dtype=np.float32)
        for axis in range(3):
            self._record(pos[:, axis].tobytes())
        self.n_frames += 1
        self._f.flush()

    def close(self):
        # patch frame counts in the header
        self._f.seek(4 + 4)        # record marker + "CORD"
        self._f.write(struct.pack("i", self.n_frames))
        self._f.seek(4 + 4 + 3 * 4)
        self._f.write(struct.pack("i", self.n_frames))
        self._f.close()


def read_dcd(path: str, return_cells: bool = False):
    """Read back a DCD written by DCDTrajectory -> [frames, atoms, 3]
    (optionally also the per-frame [frames, 3] box lengths, or None)."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def rec():
        nonlocal off
        (n,) = struct.unpack_from("i", raw, off)
        off += 4
        payload = raw[off:off + n]
        off += n + 4
        return payload

    hdr = rec()
    if hdr[:4] != b"CORD":
        raise ValueError(f"{path} is not a CHARMM DCD file")
    nframes = struct.unpack_from("i", hdr, 4)[0]
    has_cell = struct.unpack_from("i", hdr, 4 + 10 * 4)[0] == 1
    rec()  # title
    n_atoms = struct.unpack("i", rec())[0]
    frames, cells = [], []
    for _ in range(nframes):
        if has_cell:
            xtl = struct.unpack("6d", rec())
            cells.append([xtl[0], xtl[2], xtl[5]])   # a, b, c
        xyz = [np.frombuffer(rec(), dtype=np.float32) for _ in range(3)]
        frames.append(np.stack(xyz, axis=1))
    out = np.array(frames).reshape(nframes, n_atoms, 3)
    if return_cells:
        return out, (np.array(cells) if has_cell else None)
    return out


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_restart(path: str, positions, velocities, step: int,
                 rng_state: torch.Tensor | None = None, forces=None, energy=None, aux=None):
    """Checkpoint for a continuous restart: positions, velocities, step, the
    generator's state (``rng_state``, ``Generator.get_state()``), and the
    state's forces, energy and potential carry ``aux`` (the cap offsets, or
    a tuple of tensors, stored leaf by leaf as ``aux_0``, ``aux_1``, ...).
    Restoring them all resumes the trajectory exactly where it stopped.
    Written to a temporary name and renamed, so a crash mid-write leaves the
    previous checkpoint."""
    extra = {}
    if rng_state is not None:
        extra["rng_state"] = _np(rng_state).astype(np.uint8)
    if forces is not None:
        extra["forces"] = _np(forces)
    if energy is not None:
        extra["energy"] = _np(energy)
    for k, leaf in enumerate(tree_leaves(aux)):
        extra[f"aux_{k}"] = _np(leaf)
    tmp = path + ".tmp.npz"
    np.savez(tmp, positions=_np(positions), velocities=_np(velocities), step=np.asarray(step),
             **extra)
    os.replace(tmp, path)


def load_restart(path: str, aux_leaves: int = 1):
    """Load a restart checkpoint -> (positions, velocities, step, rng_state,
    extras).  ``rng_state`` is a uint8 tensor for ``Generator.set_state``,
    or None for a file the JAX package wrote (its threefry key has no torch
    counterpart).  ``extras`` may hold "forces", "energy" and "aux": the
    file's one aux leaf ``aux_0`` when the caller's carry has
    ``aux_leaves`` = 1 (the cap offsets), else the list of its
    ``aux_leaves`` leaves.  A file with another number of aux leaves is a
    checkpoint of another engine and raises."""
    with np.load(path) as raw:
        extras = {k: raw[k] for k in ("forces", "energy") if k in raw}
        n_aux = sum(1 for k in raw.files if k.startswith("aux_"))
        if n_aux and n_aux != aux_leaves:
            raise ValueError(f"{path} holds {n_aux} aux leaves; this engine carries "
                             f"{aux_leaves}")
        if n_aux == 1:
            extras["aux"] = raw["aux_0"]
        elif n_aux:
            extras["aux"] = [raw[f"aux_{k}"] for k in range(n_aux)]
        rng_state = torch.from_numpy(raw["rng_state"].copy()) if "rng_state" in raw else None
        return raw["positions"], raw["velocities"], int(raw["step"]), rng_state, extras

