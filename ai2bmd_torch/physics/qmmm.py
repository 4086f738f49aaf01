"""Subtractive QM/MM with explicit solvent.

Port of ``ai2bmd_tpu/physics/qmmm.py``.  The reference scheme
(src/Calculators/qmmm.py:48-83):

    E = E_MM(full solvated box) + E_QM(protein) - E_MM(protein only)
    F = F_MM(full);  F[protein] += F_QM - F_MM(protein)

where the reference's MM evaluations are Tinker9 AMOEBA co-processes.  Two
MM backends (``mm_backend``):
  * ``ff19sb``: the fixed-charge engine (``physics/mm.py``), optionally with
    the induced-dipole hybrid (``polarizable=True``, ``physics/
    polarization.py``, on the ``nl`` route).  The protein's internal MM
    terms cancel between the two evaluations in exact arithmetic; in
    float32 the two large sums part by up to ~1e-2 eV/A on protein atoms,
    in this port as in the JAX package (ROADMAP.md, Queue 3);
  * ``amoeba``: the polarizable AMOEBA engine (``physics/amoeba_system.py``)
    for both MM terms, on the ``nl`` route: permanent multipoles, buffered
    14-7 vdW and mutual induction, by default the variational full-Ewald
    solve whose dipole pairs (mu_d, mu_p) ride in the carry and warm-start
    the next step's solves (``amoeba_induction="ewald"``), or real-space SOR
    (``"sor"``); the protein's valence terms are left out of both
    evaluations (they cancel) and the AMOEBA water bond / angle terms are
    added on the full box.

The full box's direct-space pairs take one of three routes
(``pair_backend``, the JAX ladder of ``qmmm.py:146-272``):
  * ``cellpair`` (``auto`` when the box holds 3 cells an axis, the input
    structure fits the buckets, on ff19SB without the hybrid): cell-bucket
    tile blocks, ``physics/cellpair.py``;
  * ``dense`` (``auto`` otherwise on ff19SB without the hybrid, up to
    40,000 atoms): every pair;
  * ``nl``: an [N, K] neighbour list within cutoff + skin (both polarizable
    backends, and ``auto`` past 40,000 atoms that overflow a cell).
Every route holds no data-dependent branch, so on the card the step is
captured as one CUDA graph: the cell assignment and the neighbour list are
rebuilt on every call (JAX rebuilds them under ``lax.cond`` when an atom
moved more than skin/2; fresh lists hold every pair within the cutoff, so
the pair set is JAX's and the summation order differs), the list by the
cell build wherever the box holds 3 cells an axis at cutoff + skin, else
the tiled dense build (and for an input one of whose cells would overflow
the cell build's occupancy); their overflow flags are sticky in the carry, so the
Simulator's guard sees an overflow of any step.  The protein-only
evaluation is dense on ff19SB (a fresh list on ``nl``).

The carry is (pair state: CellState, NeighborList or None; the QM carry),
and on the AMOEBA ewald backend also the MM carry ((mu_d, mu_p) of the full
box, of the protein), as the JAX package's third entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.data.protein_topology import SystemTopology, build_topology
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.md.langevin import lift_potential
from ai2bmd_torch.ops import neighbors as NL
from ai2bmd_torch.physics import cellpair as CP
from ai2bmd_torch.physics import mm as MM
from ai2bmd_torch.physics.amoeba import WATER_R_OH, WATER_THETA_DEG
from ai2bmd_torch.physics.amoeba_protein import assign_amoeba
from ai2bmd_torch.physics.amoeba_system import AmoebaPeriodicSystem
from ai2bmd_torch.physics.polarization import PolarizationParams
from ai2bmd_torch.utils.device import resolve_device

PAIR_BACKENDS = ("auto", "cellpair", "dense", "nl")
MM_BACKENDS = ("ff19sb", "amoeba")


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


def water_bonded(P: torch.Tensor, wat_o: torch.Tensor) -> torch.Tensor:
    """AMOEBA water bond and angle terms, harmonic part (amoebabio18.prm bond
    90-91, angle 91-90-91; ``qmmm.py:320-344``); waters ordered O, H1, H2."""
    if wat_o.shape[0] == 0:
        return P.new_zeros(())
    bond_k = 556.85 * units.kcal_per_mol
    angle_k = 48.70 * units.kcal_per_mol
    o = wat_o
    e = P.new_zeros(())
    for h in (o + 1, o + 2):
        d = torch.sqrt(((P[h] - P[o]) ** 2).sum(-1))
        e = e + (bond_k * (d - WATER_R_OH) ** 2).sum()
    v1, v2 = P[o + 1] - P[o], P[o + 2] - P[o]
    th = torch.atan2(torch.sqrt((torch.linalg.cross(v1, v2, dim=-1) ** 2).sum(-1)),
                     (v1 * v2).sum(-1))
    return e + (angle_k * (th - math.radians(WATER_THETA_DEG)) ** 2).sum()


@dataclasses.dataclass
class AmoebaBackend:
    """The AMOEBA MM terms of ``QMMMPotential`` (``qmmm.py:299-393``): one
    periodic system for the full box and one for the protein alone, both in
    the box's cell."""

    full: AmoebaPeriodicSystem
    prot: AmoebaPeriodicSystem
    water_o: torch.Tensor     # [W] water oxygens of the full box
    induction: str            # ewald | sor
    cg_iters: int

    def energy_forces(self, sys_: AmoebaPeriodicSystem, P: torch.Tensor, nl: NL.NeighborList,
                      carry, bonded: bool):
        """(E, F, carry) by autograd: the variational full-Ewald energy from
        the carried dipole pair on ``ewald``, the SOR energy on ``sor``."""
        with torch.enable_grad():
            p = P.detach().requires_grad_(True)
            if self.induction == "ewald":
                e, carry = sys_.energy_ewald_variational(p, nl, carry[0], carry[1],
                                                         cg_iters=self.cg_iters)
            else:
                e = sys_.energy(p, nl)
            if bonded:
                e = e + water_bonded(p, self.water_o)
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g, carry

    def init_carry(self):
        """((mu_d, mu_p) of the full box, of the protein): zeros on
        ``ewald``, None on ``sor``."""
        if self.induction != "ewald":
            return None
        z = lambda s: torch.zeros((s.n_atoms, 3), dtype=s.q.dtype, device=s.q.device)
        return ((z(self.full), z(self.full)), (z(self.prot), z(self.prot)))


@dataclasses.dataclass
class QMMMPotential:
    """Stateful potential (P_full, aux) -> (E, F_full, aux), aux = (the full
    box's pair state: CellState, NeighborList or None; the QM carry) and, on
    the AMOEBA ewald backend, the MM carry.  The QM term is stateful,
    (P_prot, qm_aux) -> (E, F, qm_aux) (``qm_stateful``, e.g. warm-started
    caps), or a stateless ``qm_energy_forces`` lifted."""

    mm_full: MM.MMSystem | None      # ff19sb tables (None on amoeba)
    mm_prot: MM.MMSystem | None
    qm_energy_forces: Callable
    qm_init_aux: Any
    sel: torch.Tensor         # [n_prot] protein atom indices
    n_atoms: int
    k_neighbors: int
    skin: float
    top: SystemTopology
    cutoff: float
    cell: torch.Tensor        # [3], rounded through float32 as the MM tables
    backend: str              # cellpair | dense | nl
    cp: CP.CellPairs | None = None
    nl_grid: Any = None       # (nc, max_occ) of the cell build of the list, or None (dense build)
    nbr_cells: torch.Tensor | None = None   # [C, 27] the cell build's neighbourhoods
    amoeba: AmoebaBackend | None = None

    @classmethod
    def build(cls, atoms: PDBAtoms, qm_energy_forces=None, cutoff: float = 9.0,
              beta: float = 0.35, grid_spacing: float = 1.0, k_neighbors: int = 640,
              skin: float = 1.5, qm_stateful=None, qm_init_aux=None, polarizable: bool = False,
              mm_backend: str = "ff19sb", amoeba_sor_iters: int = 8,
              amoeba_induction: str = "ewald", amoeba_cg_iters: int = 8,
              pair_backend: str = "auto", device=None,
              dtype=torch.float32) -> "QMMMPotential":
        """``qmmm.py:109-294``.  ``device`` None means the card (raises
        without one); the MM tables take ``dtype``."""
        if mm_backend not in MM_BACKENDS:
            raise ValueError(f"unknown mm_backend {mm_backend!r}")
        if pair_backend not in PAIR_BACKENDS:
            raise ValueError(f"unknown pair_backend {pair_backend!r}; one of {PAIR_BACKENDS}")
        if mm_backend == "amoeba" and amoeba_induction not in ("ewald", "sor"):
            raise ValueError(f"unknown amoeba_induction {amoeba_induction!r}")
        if atoms.cell is None:
            raise ValueError("solvated QM/MM needs a periodic cell (CRYST1)")
        device = resolve_device(device)
        top = build_topology(atoms)
        sel = top.protein_atoms
        top_prot = _subsystem_topology(top, sel)
        plain = mm_backend == "ff19sb" and not polarizable     # the routes without a list
        cp = None
        if pair_backend in ("auto", "cellpair") and plain:
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
        elif mm_backend == "ff19sb" and (
                pair_backend == "dense" or (pair_backend == "auto" and plain
                                            and top.n_atoms <= 40_000)):
            backend = "dense"
        else:
            backend = "nl"
        if backend == "dense" and polarizable:
            raise ValueError("dense path does not support the legacy polarization hybrid; use "
                             "mm_backend='amoeba' for polarizable MM")

        mm_full = mm_prot = amoeba = None
        if mm_backend == "amoeba":
            amoeba = _build_amoeba_backend(atoms, top, top_prot, sel, cutoff, amoeba_sor_iters,
                                           amoeba_induction, amoeba_cg_iters, device, dtype)
        else:
            pol_full = pol_prot = None
            if polarizable:
                # induced dipoles driven by the fixed charges (the hybrid;
                # superseded by mm_backend="amoeba")
                pol_full = PolarizationParams.build(atoms.numbers, top.charges, top.excl_pairs,
                                                    cutoff=cutoff, device=device, dtype=dtype)
                pol_prot = PolarizationParams.build(atoms.numbers[sel], top_prot.charges,
                                                    top_prot.excl_pairs, cutoff=cutoff,
                                                    device=device, dtype=dtype)
            mm = lambda t, pol: MM.MMSystem.build(t, atoms.cell, cutoff=cutoff, beta=beta,
                                                  grid_spacing=grid_spacing, polarization=pol,
                                                  device=device, dtype=dtype)
            mm_full, mm_prot = mm(top, pol_full), mm(top_prot, pol_prot)
        nl_grid = nbr_cells = None
        if backend == "nl":
            nl_grid, nbr_cells = NL.cell_plan(atoms.cell, atoms.positions, cutoff + skin, device)
        return cls(
            mm_full=mm_full, mm_prot=mm_prot,
            qm_energy_forces=qm_stateful or lift_potential(qm_energy_forces),
            qm_init_aux=qm_init_aux,
            sel=torch.as_tensor(np.asarray(sel, np.int64), device=device),
            n_atoms=top.n_atoms, k_neighbors=k_neighbors, skin=skin, top=top, cutoff=cutoff,
            cell=torch.as_tensor(np.asarray(atoms.cell, np.float32), dtype=dtype, device=device),
            backend=backend, cp=cp, nl_grid=nl_grid, nbr_cells=nbr_cells, amoeba=amoeba,
        )

    @property
    def engine(self) -> str:
        """The MM engine, for the CLI's QM/MM line."""
        if self.amoeba is not None:
            return "AMOEBA"
        return "ff19SB + induced dipoles" if self.mm_full.polarization is not None else "ff19SB"

    @property
    def mesh(self) -> tuple:
        """The full box's reciprocal-space mesh."""
        return self.amoeba.full.pme.grid if self.amoeba is not None else self.mm_full.grid

    def _build_nl(self, P: torch.Tensor) -> NL.NeighborList:
        """The full box's list within cutoff + skin: the cell build wherever
        the box holds 3 cells an axis, else the tiled dense build."""
        return NL.build_list(P, self.cutoff + self.skin, self.k_neighbors, self.cell,
                             self.nl_grid, self.nbr_cells)

    def init_aux(self, P: torch.Tensor):
        """(pair state, QM carry[, MM carry]) at P; raises on a cell or list
        overflow (``qmmm.py:407-431``)."""
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
        carry = self.amoeba.init_carry() if self.amoeba is not None else None
        return (state, self.qm_init_aux) + (() if carry is None else (carry,))

    def mm_full_energy_forces(self, P: torch.Tensor, state, carry=None):
        """(E, F, state, carry) of the full box on this route; the pair
        state is rebuilt on every call, its overflow flag kept."""
        if self.backend == "cellpair":
            state = CP.assign(self.cp, P, prev=state)
            return (*CP.mm_energy_forces_cellpair(self.mm_full, P, state, self.cp), state, carry)
        if self.backend == "dense":
            return (*MM.mm_energy_forces_dense(self.mm_full, P), None, carry)
        state = NL.rebuild(state, P, self._build_nl)
        if self.amoeba is not None:
            e, f, carry = self.amoeba.energy_forces(self.amoeba.full, P, state, carry,
                                                    bonded=True)
            return e, f, state, carry
        return (*MM.mm_energy_forces(self.mm_full, P, state), state, carry)

    def mm_prot_energy_forces(self, P_prot: torch.Tensor, carry=None):
        """(E, F, carry) of the protein alone (dense, or a fresh list on
        ``nl``, ``qmmm.py:457-460``)."""
        n_prot = P_prot.shape[0]
        if self.backend != "nl":
            return (*MM.mm_energy_forces_dense(self.mm_prot, P_prot, tile=n_prot), carry)
        nl = NL.build_neighbor_list(P_prot, self.cutoff, min(self.k_neighbors, n_prot),
                                    self.cell, tile=min(512, n_prot))
        if self.amoeba is not None:
            return self.amoeba.energy_forces(self.amoeba.prot, P_prot, nl, carry, bonded=False)
        return (*MM.mm_energy_forces(self.mm_prot, P_prot, nl), carry)

    def __call__(self, P: torch.Tensor, aux):
        state, qm_aux, *mm_carry = aux
        carry_full, carry_prot = mm_carry[0] if mm_carry else (None, None)
        e2, f2, state, carry_full = self.mm_full_energy_forces(P, state, carry_full)
        P_prot = P[self.sel]
        e1, f1, carry_prot = self.mm_prot_energy_forces(P_prot, carry_prot)
        eq, fq, qm_aux = self.qm_energy_forces(P_prot, qm_aux)
        energy = e2 + eq - e1
        forces = f2.index_add(0, self.sel, fq - f1)
        return energy, forces, (state, qm_aux) + (((carry_full, carry_prot),) if mm_carry else ())


def _build_amoeba_backend(atoms, top, top_prot, sel, cutoff, sor_iters, induction, cg_iters,
                          device, dtype) -> AmoebaBackend:
    """``qmmm.py:299-393``: AMOEBA assignments of the full box and of the
    protein (from names and bonds), each a periodic system in the box's
    cell (mesh spacing 0.9 A)."""
    build = lambda asg: AmoebaPeriodicSystem.build(asg, atoms.cell, cutoff=cutoff,
                                                   sor_iters=sor_iters, grid_spacing=0.9,
                                                   device=device, dtype=dtype)
    asg_full = assign_amoeba(atoms.atom_names, atoms.residue_names, atoms.positions, top.bonds)
    asg_prot = assign_amoeba([atoms.atom_names[i] for i in sel],
                             [atoms.residue_names[i] for i in sel], atoms.positions[sel],
                             top_prot.bonds)
    return AmoebaBackend(
        full=build(asg_full), prot=build(asg_prot),
        water_o=torch.as_tensor(np.asarray(top.water_oxygens, np.int64), device=device),
        induction=induction, cg_iters=cg_iters)
