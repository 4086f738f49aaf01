"""Cell-bucket tile pairs: the direct-space nonbonded sum without O(N^2).

Port of ``ai2bmd_tpu/physics/cellpair.py``.  Atoms are sorted into an
[NC, OCC] grid of spatial cells whose edge covers cutoff + skin (one argsort
and a scatter, ``assign``); the pair sum then evaluates, for each home cell,
one dense [OCC, 27 * OCC] block against the concatenated buckets of its
3 x 3 x 3 neighbourhood, with the pair math of the dense path
(``mm.pair_block``).  Each pair is evaluated from both sides, so energies are
halved and each atom's force is its own row sum; the only scatter is the
un-bucketing, one add per atom.

Blocks go in chunks of ``cell_chunk`` home cells, sized so that a chunk
holds about ``CHUNK_SLOTS`` pair slots (on the solvated Chignolin box, 150
cells of 184 slots: 137 M slots a step, 548 MB for each float32
intermediate if evaluated at once).

Where JAX re-assigns under ``lax.cond`` when an atom moved more than skin/2
since the last assignment (``needs_rebuild``), the port's QM/MM step calls
``assign`` on every step (``physics/qmmm.py``): a CUDA graph cannot branch
on device data, and fresh buckets always hold every pair inside the cutoff,
so only the summation order differs.  ``CellState.overflow`` flags a cell
that held more than OCC atoms at assignment (its extra atoms are missing
from the pair sum); ``Simulator._check_overflow`` raises on it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ai2bmd_torch.ops.neighbors import _pbc_diff, neighbor_cells
from ai2bmd_torch.physics import mm as MM

# pair slots a chunk of home cells holds: on the card 2^24 (about 20
# float32 intermediates of 64 MiB live at once), on the CPU 2^21
CHUNK_SLOTS = {"cuda": 1 << 24, "cpu": 1 << 21}


class CellState(NamedTuple):
    """One assignment of atoms to cells (rides the integrator's carry)."""

    bucket_idx: torch.Tensor  # [NC, OCC] int64 atom ids; n_atoms = empty slot
    anchor: torch.Tensor      # [N, 3] positions at assignment
    overflow: torch.Tensor    # 0-d bool: some cell held more than OCC atoms


@dataclasses.dataclass(frozen=True)
class CellPairs:
    """Static geometry of the cell decomposition."""

    n_atoms: int
    nc3: tuple                # cells per axis (nx, ny, nz)
    occ: int                  # slots a cell
    cutoff: float
    skin: float
    cell: torch.Tensor        # [3] box lengths (static NVT box)
    nbr: torch.Tensor         # [NC, 27] int64 neighbour cell ids (wrapped)

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.nc3))


def build_cellpairs(cell: np.ndarray, cutoff: float, n_atoms: int, device,
                    min_skin: float = 0.35, occ_margin_sigmas: float = 5.0,
                    dtype=torch.float32) -> CellPairs | None:
    """The densest cell grid whose edge still covers cutoff + min_skin
    (``cellpair.py:66-113``), OCC = mean occupancy + 5 sigma + 8, rounded up
    to a multiple of 8; None when the box holds fewer than 3 cells on some
    axis (the caller takes the dense path)."""
    cell = np.asarray(cell, np.float64)
    nc3 = tuple(int(max(1, np.floor(L / (cutoff + min_skin)))) for L in cell)
    if min(nc3) < 3:
        return None
    skin = min(L / n for L, n in zip(cell, nc3)) - cutoff
    nc = int(np.prod(nc3))
    mean_occ = n_atoms / nc
    occ = int(mean_occ + occ_margin_sigmas * np.sqrt(mean_occ) + 8)
    occ = ((occ + 7) // 8) * 8
    # the full symmetric set of 27 offsets (JAX measured a half set with
    # Newton's third law no faster, cellpair.py:88-93)
    nbr = neighbor_cells(nc3)
    return CellPairs(n_atoms=n_atoms, nc3=nc3, occ=occ, cutoff=cutoff, skin=float(skin),
                     cell=torch.as_tensor(np.asarray(cell, np.float32), dtype=dtype,
                                          device=device),
                     nbr=torch.as_tensor(nbr, device=device))


def assign(cp: CellPairs, P: torch.Tensor, prev: CellState | None = None) -> CellState:
    """Sort atoms into cells: one argsort and a scatter, no host sync (it
    runs inside the captured step).  With ``prev`` (the carry's last
    assignment) the overflow flag is sticky: it stays set once any step
    overflowed, so a guard that reads the carry only at record intervals
    still sees an overflow of a step between them."""
    N, dev = cp.n_atoms, P.device
    frac = P / cp.cell
    frac = frac - torch.floor(frac)                     # wrap into [0, 1)
    cid3 = [torch.clamp((frac[:, a] * n).long(), 0, n - 1) for a, n in enumerate(cp.nc3)]
    key = (cid3[0] * cp.nc3[1] + cid3[1]) * cp.nc3[2] + cid3[2]
    order = torch.argsort(key, stable=True)
    sk = key[order]
    starts = torch.searchsorted(sk, torch.arange(cp.n_cells, device=dev))
    rank = torch.arange(N, device=dev) - starts[sk]
    bucket = torch.full((cp.n_cells, cp.occ), N, dtype=torch.long, device=dev)
    bucket[sk, torch.clamp(rank, max=cp.occ - 1)] = torch.where(rank < cp.occ, order, N)
    overflow = (rank >= cp.occ).any()
    if prev is not None:
        overflow = overflow | prev.overflow
    return CellState(bucket_idx=bucket, anchor=P, overflow=overflow)


def needs_rebuild(cp: CellPairs, state: CellState, P: torch.Tensor) -> torch.Tensor:
    """The Verlet-skin criterion on the displacement since ``state.anchor``."""
    disp = _pbc_diff(P - state.anchor, cp.cell)
    return (disp * disp).sum(-1).max() > (0.5 * cp.skin) ** 2


def default_chunk(cp: CellPairs, device) -> int:
    """Home cells a chunk: about CHUNK_SLOTS pair slots."""
    slots = CHUNK_SLOTS["cuda" if torch.device(device).type == "cuda" else "cpu"]
    return max(1, min(cp.n_cells, slots // (cp.nbr.shape[1] * cp.occ * cp.occ)))


def pair_energy_forces(cp: CellPairs, state: CellState, P: torch.Tensor, charge, sigma, eps,
                       beta: float, cell_chunk: int | None = None):
    """(E, F, W): erfc-Coulomb + LJ over every pair inside the cutoff
    (``cellpair.py:141-236``), the same function as
    ``mm.dense_pair_energy_forces``.  Per home cell one [OCC, 27 * OCC]
    block against the concatenated neighbour buckets; ``cell_chunk`` home
    cells a pass (``default_chunk`` when None)."""
    N, OCC, NC = cp.n_atoms, cp.occ, cp.n_cells
    NOFF = cp.nbr.shape[1]
    G = cell_chunk or default_chunk(cp, P.device)
    bucket = state.bucket_idx
    pad = lambda a, v: torch.cat([a, torch.full((1,) + a.shape[1:], v, dtype=a.dtype,
                                                device=a.device)])
    Pb = pad(P, 1e6)[bucket]                             # [NC, OCC, 3]
    qb, sb, eb = pad(charge, 0.0)[bucket], pad(sigma, 0.0)[bucket], pad(eps, 0.0)[bucket]
    es, fs, ws = [], [], []
    with torch.no_grad():
        for start in range(0, NC, G):
            home = slice(start, min(start + G, NC))
            nb = cp.nbr[home]                            # [G, NOFF]
            g = nb.shape[0]
            Pi, Pj = Pb[home], Pb[nb].reshape(g, NOFF * OCC, 3)
            gi, gj = bucket[home], bucket[nb].reshape(g, NOFF * OCC)
            d = [_pbc_diff(Pj[:, None, :, a] - Pi[:, :, None, a], cp.cell[a]) for a in range(3)]
            m = (gi < N)[:, :, None] & (gj < N)[:, None, :] & (gi[:, :, None] != gj[:, None, :])
            col = lambda t: t[nb].reshape(g, 1, NOFF * OCC)
            e, f, w = MM.pair_block(d, m, qb[home][:, :, None], col(qb), sb[home][:, :, None],
                                    col(sb), eb[home][:, :, None], col(eb), beta, cp.cutoff)
            es.append(e)
            fs.append(f)
            ws.append(w)
        # un-bucket: every real atom sits in exactly one slot
        F = torch.zeros((N + 1, 3), dtype=P.dtype, device=P.device)
        F.index_add_(0, bucket.reshape(-1), torch.cat(fs).reshape(-1, 3))
    return 0.5 * torch.stack(es).sum(), F[:N], 0.5 * torch.stack(ws).sum()


def mm_energy_forces_cellpair(mm: MM.MMSystem, P: torch.Tensor, state: CellState,
                              cp: CellPairs):
    """(E, F) of an MMSystem with the cell-bucket pair path: bonded, PME
    reciprocal and exclusion terms by autograd, as in
    ``mm.mm_energy_forces_dense``."""
    e_s, f_s = MM.smooth_energy_forces(mm, P)
    e_p, f_p, _ = pair_energy_forces(cp, state, P, mm.charge, mm.sigma, mm.eps, mm.beta)
    return e_s + e_p, f_p + f_s
