"""Protein/system container.

Host-side (numpy) description of the simulated system: geometry, chemistry
and per-atom force-field parameters.  Replaces the reference's
``Protein(ase.Atoms)`` (src/AIMD/protein.py:15-175); the OpenMM-based
nonbonded parameter extraction (protein.py:153-175) is replaced by a lookup
into our converted ff19SB tables (ai2bmd_torch/data assets).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ai2bmd_torch import data
from ai2bmd_torch.io.pdb import PDBAtoms, read_pdb

WATER_RESIDUES = {"WAT", "HOH", "TIP3", "T3P", "SPC"}
ION_RESIDUES = {"NA+", "NA", "CL-", "CL", "K+", "K"}

# TIP3P + Joung-Cheatham monovalent ion parameters (public standard values):
# charge (e), sigma (A), eps (kcal/mol)
_EXTRA_FF = {
    ("WAT", "O"): (-0.834, 3.1508, 0.1521),
    ("WAT", "H1"): (0.417, 0.0, 0.0),
    ("WAT", "H2"): (0.417, 0.0, 0.0),
    ("Na+", "Na+"): (1.0, 2.439, 0.0874393),
    ("Cl-", "Cl-"): (-1.0, 4.478, 0.035591),
}


@dataclasses.dataclass
class Protein:
    """System state + static chemistry tables (numpy, host side)."""

    atoms: PDBAtoms
    charges: np.ndarray    # [N] e
    sigmas: np.ndarray     # [N] A
    epsilons: np.ndarray   # [N] kcal/mol

    # populated by fragmentation (ai2bmd_torch.frag.indexer)
    frag: object | None = None

    def __len__(self):
        return len(self.atoms)

    @property
    def positions(self) -> np.ndarray:
        return self.atoms.positions

    @property
    def numbers(self) -> np.ndarray:
        return self.atoms.numbers

    @property
    def masses(self) -> np.ndarray:
        return self.atoms.masses

    @property
    def cell(self) -> np.ndarray | None:
        return self.atoms.cell

    @classmethod
    def from_pdb(cls, path: str) -> "Protein":
        return cls.from_atoms(read_pdb(path))

    @classmethod
    def from_atoms(cls, atoms: PDBAtoms) -> "Protein":
        charges, sigmas, epsilons = assign_nonbonded_params(atoms)
        return cls(atoms=atoms, charges=charges, sigmas=sigmas, epsilons=epsilons)

    def select(self, idx: np.ndarray) -> "Protein":
        a = self.atoms
        sub = PDBAtoms(
            positions=a.positions[idx].copy(),
            numbers=a.numbers[idx].copy(),
            atom_names=a.atom_names[idx].copy(),
            residue_names=a.residue_names[idx].copy(),
            residue_numbers=a.residue_numbers[idx].copy(),
            cell=a.cell,
        )
        return Protein(
            atoms=sub,
            charges=self.charges[idx].copy(),
            sigmas=self.sigmas[idx].copy(),
            epsilons=self.epsilons[idx].copy(),
        )

    def protein_indices(self) -> np.ndarray:
        """Indices of non-water, non-ion atoms (the QM region)."""
        mask = ~np.isin(
            np.char.upper(self.atoms.residue_names.astype(str)),
            sorted(WATER_RESIDUES | ION_RESIDUES),
        )
        return np.flatnonzero(mask)


_NAME_ALIASES = {
    # common PDB naming variants -> prmtop naming
    "HN": "H",
    "OXT": "O",
}


def _lookup(table, res: str, name: str):
    for key in ((res, name), (res, _NAME_ALIASES.get(name, name))):
        if key in table:
            return table[key]
    # amber renames for terminal-ish hydrogens: try leading-digit rotation
    # (e.g. 1HB2 <-> HB21)
    if name and name[0].isdigit():
        rotated = name[1:] + name[0]
        if (res, rotated) in table:
            return table[(res, rotated)]
    return None


def assign_nonbonded_params(atoms: PDBAtoms):
    """Charge / sigma / epsilon per atom from the converted ff19SB tables."""
    table = dict(data.ff_nonbonded())
    table.update(_EXTRA_FF)
    n = len(atoms)
    charges = np.zeros(n)
    sigmas = np.zeros(n)
    epsilons = np.zeros(n)
    missing = []
    for i in range(n):
        res = str(atoms.residue_names[i])
        name = str(atoms.atom_names[i])
        if res.upper() in WATER_RESIDUES:
            res = "WAT"
            if atoms.numbers[i] == 8:
                name = "O"
            else:
                name = "H1"
        hit = _lookup(table, res, name)
        if hit is None and res == "HIS":
            hit = _lookup(table, "HIE", name)
        if hit is None:
            missing.append((res, name))
            continue
        charges[i], sigmas[i], epsilons[i] = hit
    if missing:
        raise KeyError(
            f"no ff parameters for {sorted(set(missing))[:8]}"
            f" ({len(missing)} atoms total)"
        )
    return charges, sigmas, epsilons
