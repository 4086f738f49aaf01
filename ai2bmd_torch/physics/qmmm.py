"""Subtractive QM/MM with explicit solvent.

Port of ``ai2bmd_tpu/physics/qmmm.py`` for the ``ff19sb`` MM backend.  The
reference scheme (src/Calculators/qmmm.py:48-83):

    E = E_MM(full solvated box) + E_QM(protein) - E_MM(protein only)
    F = F_MM(full);  F[protein] += F_QM - F_MM(protein)

where the reference's MM evaluations are Tinker9 AMOEBA co-processes; here
both are the fixed-charge engine (``physics/mm.py``).  The protein's internal
MM terms cancel between the two evaluations in exact arithmetic; in float32
the two large sums part by up to ~1e-2 eV/A on protein atoms, in this port
as in the JAX package (ROADMAP.md, Queue 3).

The full box's direct-space pairs take one of three routes
(``pair_backend``, the JAX ladder of ``qmmm.py:146-272``):
  * ``cellpair`` (``auto`` when the box holds 3 cells an axis and the input
    structure fits the buckets): cell-bucket tile blocks,
    ``physics/cellpair.py``.  ``assign`` runs on every call, so the step
    holds no data-dependent branch and is captured as one CUDA graph; its
    overflow flag is sticky in the carry, so the Simulator's guard sees an
    overflow of any step;
  * ``dense`` (``auto`` otherwise, up to 40,000 atoms): every pair;
  * ``nl``: an [N, K] neighbour list rebuilt when an atom moved more than
    skin/2, a host decision that a captured step cannot make: on the CPU
    only, and refused on the card (ROADMAP.md, Queue 2), as is ``auto``
    where it would reach it.
The protein-only evaluation is dense (or ``nl`` on the ``nl`` route).

Refused, naming the ROADMAP item: ``mm_backend="amoeba"`` (Queue 1 item
15), ``polarizable=True`` (the item 13 remainder, item 13b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ai2bmd_torch.data.protein_topology import SystemTopology, build_topology
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.md.langevin import lift_potential
from ai2bmd_torch.ops import neighbors as NL
from ai2bmd_torch.physics import cellpair as CP
from ai2bmd_torch.physics import mm as MM
from ai2bmd_torch.utils.device import resolve_device

PAIR_BACKENDS = ("auto", "cellpair", "dense", "nl")
NL_ON_CARD = ("the nl pair route rebuilds its list on a host decision, which a captured step "
              "cannot make; it runs on the CPU only (ROADMAP.md, Queue 2: the nl route on the "
              "card)")


def _subsystem_topology(top: SystemTopology, idx: np.ndarray) -> SystemTopology:
    """Restrict a topology to a subset of atoms, index-remapped
    (``qmmm.py:38-86``)."""
    remap = -np.ones(top.n_atoms, dtype=np.int64)
    remap[idx] = np.arange(len(idx))

    def keep_terms(atoms_arr, *params):
        if len(atoms_arr) == 0:
            return (atoms_arr,) + params
        mask = np.all(remap[atoms_arr] >= 0, axis=1)
        return (remap[atoms_arr[mask]].astype(np.int32),) + tuple(p[mask] for p in params)

    bonds, bond_k, bond_r0 = keep_terms(top.bonds, top.bond_k, top.bond_r0)
    angles, angle_k, angle_t0 = keep_terms(top.angles, top.angle_k, top.angle_t0)
    dih, dk, dn, dp = keep_terms(top.dihedrals, top.dih_k, top.dih_n, top.dih_phase)
    excl, = keep_terms(top.excl_pairs)
    p14, = keep_terms(top.pairs14)
    # CMAP subsets too: the combiner needs the protein evaluation to carry
    # the terms of the full one, so that they cancel
    cmap_atoms = np.zeros((0, 5), np.int32)
    cmap_type = np.zeros((0,), np.int32)
    cmap_grids = np.zeros((0, 24, 24))
    if top.cmap_atoms is not None and len(top.cmap_atoms):
        cmap_atoms, cmap_type = keep_terms(top.cmap_atoms, top.cmap_type)
        cmap_grids = top.cmap_grids
    return SystemTopology(
        n_atoms=len(idx),
        charges=top.charges[idx], sigmas=top.sigmas[idx],
        epsilons=top.epsilons[idx], masses=top.masses[idx],
        bonds=bonds, bond_k=bond_k, bond_r0=bond_r0,
        angles=angles, angle_k=angle_k, angle_t0=angle_t0,
        dihedrals=dih, dih_k=dk, dih_n=dn, dih_phase=dp,
        excl_pairs=excl, pairs14=p14,
        water_oxygens=np.zeros(0, np.int32),
        protein_atoms=np.arange(len(idx), dtype=np.int32),
        cmap_atoms=cmap_atoms, cmap_type=cmap_type, cmap_grids=cmap_grids,
    )


@dataclasses.dataclass
class QMMMPotential:
    """Stateful potential (P_full, aux) -> (E, F_full, aux), aux = (the full
    box's pair state: CellState, NeighborList or None; the QM carry).  The
    QM term is stateful, (P_prot, qm_aux) -> (E, F, qm_aux) (``qm_stateful``,
    e.g. warm-started caps), or a stateless ``qm_energy_forces`` lifted."""

    mm_full: MM.MMSystem
    mm_prot: MM.MMSystem
    qm_energy_forces: Callable
    qm_init_aux: Any
    sel: torch.Tensor         # [n_prot] protein atom indices
    n_atoms: int
    k_neighbors: int
    skin: float
    top: SystemTopology
    cutoff: float
    backend: str              # cellpair | dense | nl
    cp: CP.CellPairs | None = None
    nl_grid: Any = None       # (nc, max_occ) of the O(N) list rebuild past 24k atoms

    @classmethod
    def build(cls, atoms: PDBAtoms, qm_energy_forces=None, cutoff: float = 9.0,
              beta: float = 0.35, grid_spacing: float = 1.0, k_neighbors: int = 640,
              skin: float = 1.5, qm_stateful=None, qm_init_aux=None, polarizable: bool = False,
              mm_backend: str = "ff19sb", pair_backend: str = "auto", device=None,
              dtype=torch.float32) -> "QMMMPotential":
        """``device`` None means the card (raises without one); the MM tables
        take ``dtype``."""
        if mm_backend == "amoeba":
            raise NotImplementedError(
                "mm_backend='amoeba' (the polarizable AMOEBA solvent) is not ported yet "
                "(ROADMAP.md, Queue 1 item 15)")
        if mm_backend != "ff19sb":
            raise ValueError(f"unknown mm_backend {mm_backend!r}")
        if polarizable:
            raise NotImplementedError(
                "polarizable=True (the induced-dipole hybrid of physics/polarization.py) is not "
                "ported yet (ROADMAP.md, Queue 1 item 13b)")
        if pair_backend not in PAIR_BACKENDS:
            raise ValueError(f"unknown pair_backend {pair_backend!r}; one of {PAIR_BACKENDS}")
        if atoms.cell is None:
            raise ValueError("solvated QM/MM needs a periodic cell (CRYST1)")
        device = resolve_device(device)
        if pair_backend == "nl" and device.type == "cuda":
            raise NotImplementedError(NL_ON_CARD)
        top = build_topology(atoms)
        sel = top.protein_atoms
        cp = None
        if pair_backend in ("auto", "cellpair"):
            cp = CP.build_cellpairs(atoms.cell, cutoff, top.n_atoms, device, dtype=dtype)
            if cp is None and pair_backend == "cellpair":
                raise ValueError("box too small for the cellpair backend (needs >= 3 cells per "
                                 "axis at the cutoff); use dense")
            if cp is not None and pair_backend == "auto":
                # the bucket size assumes liquid-like occupancy: under "auto"
                # an input that overflows a cell takes the dense path
                # (JAX's own probe, qmmm.py:174-187)
                probe = CP.assign(cp, torch.as_tensor(atoms.positions, dtype=dtype,
                                                      device=device))
                if bool(probe.overflow):
                    cp = None
        if cp is not None:
            backend = "cellpair"
        elif pair_backend == "dense" or (pair_backend == "auto" and top.n_atoms <= 40_000):
            backend = "dense"
        elif device.type == "cuda":
            raise NotImplementedError(f"{top.n_atoms} atoms that overflow a cell bucket take "
                                      f"the nl pair route under 'auto': {NL_ON_CARD}")
        else:
            backend = "nl"
        mm = lambda t: MM.MMSystem.build(t, atoms.cell, cutoff=cutoff, beta=beta,
                                         grid_spacing=grid_spacing, device=device, dtype=dtype)
        return cls(
            mm_full=mm(top), mm_prot=mm(_subsystem_topology(top, sel)),
            qm_energy_forces=qm_stateful or lift_potential(qm_energy_forces),
            qm_init_aux=qm_init_aux,
            sel=torch.as_tensor(np.asarray(sel, np.int64), device=device),
            n_atoms=top.n_atoms, k_neighbors=k_neighbors, skin=skin, top=top, cutoff=cutoff,
            backend=backend, cp=cp,
            nl_grid=(NL.cell_grid(atoms.cell, cutoff + skin, top.n_atoms)
                     if top.n_atoms > 24_000 else None),
        )

    def _build_nl(self, P: torch.Tensor) -> NL.NeighborList:
        if self.nl_grid is not None:
            nc, max_occ = self.nl_grid
            return NL.build_neighbor_list_cells(P, self.cutoff + self.skin, self.k_neighbors,
                                                self.mm_full.cell, nc, max_occ)
        return NL.build_neighbor_list(P, self.cutoff + self.skin, self.k_neighbors,
                                      self.mm_full.cell)

    def init_aux(self, P: torch.Tensor):
        """(pair state, QM carry) at P; raises on a cell or list overflow
        (``qmmm.py:407-431``)."""
        state = None
        if self.backend == "cellpair":
            state = CP.assign(self.cp, P)
            if bool(state.overflow):
                raise ValueError(
                    f"cell-bucket overflow at build time: some cell holds more than "
                    f"occ={self.cp.occ} atoms; the box density is far from liquid-like (check "
                    f"the input structure)")
        elif self.backend == "nl":
            state = self._build_nl(P)
            if bool(state.overflow):
                raise ValueError(
                    f"neighbor list overflow at build time: some atom has more than "
                    f"k_neighbors={self.k_neighbors} neighbors within cutoff+skin="
                    f"{self.cutoff + self.skin:.2f} A; raise k_neighbors in QMMMPotential.build")
        return (state, self.qm_init_aux)

    def mm_full_energy_forces(self, P: torch.Tensor, state):
        """(E, F, state) of the full box on this route."""
        if self.backend == "cellpair":
            state = CP.assign(self.cp, P, prev=state)
            return (*CP.mm_energy_forces_cellpair(self.mm_full, P, state, self.cp), state)
        if self.backend == "dense":
            return (*MM.mm_energy_forces_dense(self.mm_full, P), None)
        if bool(NL.needs_rebuild(state, P, self.skin, self.mm_full.cell)):
            new = self._build_nl(P)     # the overflow flag stays sticky, as on cellpair
            state = new._replace(overflow=new.overflow | state.overflow)
        return (*MM.mm_energy_forces(self.mm_full, P, state), state)

    def mm_prot_energy_forces(self, P_prot: torch.Tensor):
        """(E, F) of the protein alone (dense, or a fresh list on ``nl``)."""
        n_prot = P_prot.shape[0]
        if self.backend == "nl":
            nl = NL.build_neighbor_list(P_prot, self.cutoff, min(self.k_neighbors, n_prot),
                                        self.mm_prot.cell, tile=min(512, n_prot))
            return MM.mm_energy_forces(self.mm_prot, P_prot, nl)
        return MM.mm_energy_forces_dense(self.mm_prot, P_prot, tile=n_prot)

    def __call__(self, P: torch.Tensor, aux):
        state, qm_aux = aux
        e2, f2, state = self.mm_full_energy_forces(P, state)
        P_prot = P[self.sel]
        e1, f1 = self.mm_prot_energy_forces(P_prot)
        eq, fq, qm_aux = self.qm_energy_forces(P_prot, qm_aux)
        energy = e2 + eq - e1
        forces = f2.index_add(0, self.sel, fq - f1)
        return energy, forces, (state, qm_aux)
