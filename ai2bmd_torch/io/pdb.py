"""PDB reading/writing without external dependencies.

Replaces the reference's ase.io readers plus its atom-name fixups
(reference: src/utils/pdb.py:10-39).  Parsing is column-based per the PDB
standard, with the same quirks handled:

  * element taken from columns 77-78 when present, otherwise derived from
    the atom-name field, where any name starting with H is hydrogen
    (protein H naming such as 1HB2/HD21 confuses naive parsers)
  * CRYST1 provides an orthorhombic cell when available
  * residue numbers wrap at 10000 (tinker output quirk,
    reference src/utils/pdb.py:103-135); we renumber continuously
"""

from __future__ import annotations

import dataclasses

import numpy as np

# IUPAC 2021 standard atomic weights (abridged), indexed by atomic number.
ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.95,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
    58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
])

SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
]
_SYMBOL_TO_Z = {s.upper(): z for z, s in enumerate(SYMBOLS)}


def element_to_z(sym: str) -> int:
    sym = sym.strip().upper()
    if not sym:
        raise ValueError("empty element symbol")
    if sym.startswith("H") and sym not in ("HE", "HF", "HG", "HO", "HS"):
        return 1
    if sym in _SYMBOL_TO_Z:
        return _SYMBOL_TO_Z[sym]
    if sym[0] in _SYMBOL_TO_Z:
        return _SYMBOL_TO_Z[sym[0]]
    raise ValueError(f"unknown element symbol: {sym!r}")


@dataclasses.dataclass
class PDBAtoms:
    """Raw parsed contents of a PDB file (host-side, numpy)."""

    positions: np.ndarray       # [N, 3] float64, Angstrom
    numbers: np.ndarray         # [N] int32 atomic numbers
    atom_names: np.ndarray      # [N] str (stripped, e.g. 'CA', 'HB2')
    residue_names: np.ndarray   # [N] str (e.g. 'ALA', 'ACE', 'WAT')
    residue_numbers: np.ndarray  # [N] int32, made continuous starting at 1
    cell: np.ndarray | None     # [3] orthorhombic box lengths or None

    def __len__(self):
        return len(self.numbers)

    @property
    def masses(self) -> np.ndarray:
        return ATOMIC_MASSES[self.numbers]


def _z_from_line(line: str) -> int:
    element_field = line[76:78].strip() if len(line) >= 78 else ""
    if element_field:
        return element_to_z(element_field)
    name = line[12:16].strip()
    # numeric prefixes like 1HB2 are hydrogens; otherwise first letter run
    lead = name.lstrip("0123456789")
    if lead.startswith("H"):
        return 1
    return element_to_z(lead[:2] if lead[:2].upper() in _SYMBOL_TO_Z else lead[:1])


def read_pdb(path: str) -> PDBAtoms:
    positions, numbers, atom_names, res_names, res_ids = [], [], [], [], []
    cell = None
    with open(path) as f:
        for line in f:
            if line.startswith("CRYST1"):
                a, b, c = float(line[6:15]), float(line[15:24]), float(line[24:33])
                cell = np.array([a, b, c])
            if not (line.startswith("ATOM") or line.startswith("HETATM")):
                continue
            positions.append(
                [float(line[30:38]), float(line[38:46]), float(line[46:54])]
            )
            numbers.append(_z_from_line(line))
            atom_names.append(line[12:16].strip())
            res_names.append(line[17:21].strip())
            res_ids.append(int(line[22:26]))
    if not positions:
        raise ValueError(f"no atoms found in {path}")

    # renumber residues continuously from 1, robust to the 10000-wrap quirk
    raw = np.array(res_ids, dtype=np.int64)
    new_res = np.ones(len(raw), dtype=np.int32)
    counter = 1
    for i in range(1, len(raw)):
        if raw[i] != raw[i - 1]:
            counter += 1
        new_res[i] = counter

    return PDBAtoms(
        positions=np.array(positions, dtype=np.float64),
        numbers=np.array(numbers, dtype=np.int32),
        atom_names=np.array(atom_names),
        residue_names=np.array(res_names),
        residue_numbers=new_res,
        cell=cell,
    )


def write_pdb(path: str, atoms: PDBAtoms, positions: np.ndarray | None = None):
    pos = atoms.positions if positions is None else positions
    with open(path, "w") as f:
        if atoms.cell is not None:
            a, b, c = atoms.cell
            f.write(
                f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}  90.00  90.00  90.00 P 1           1\n"
            )
        for i in range(len(atoms)):
            name = atoms.atom_names[i]
            pad = f" {name:<3s}" if len(name) < 4 else name
            sym = SYMBOLS[atoms.numbers[i]]
            # strict column layout: name 13-16, resName 18-21, resSeq 23-26
            f.write(
                f"ATOM  {(i + 1) % 100000:>5d} {pad:<4s} "
                f"{atoms.residue_names[i]:<4s} "
                f"{atoms.residue_numbers[i] % 10000:>4d}    "
                f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}"
                f"  1.00  0.00          {sym:>2s}\n"
            )
        f.write("END\n")
