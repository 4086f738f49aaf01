"""Atom-order normalization.

The fragmentation templates (seq_permutations asset) are defined over the
"tinker" per-residue atom layout produced by the reference's preprocessing
(N, CA, C, O, H, HA, heavy sidechain, sidechain hydrogens; reference:
src/utils/pdb.py:196-272).  Raw PDBs typically come in AMBER layout
(N, H, CA, HA, sidechain interleaved, C, O).  This module permutes a parsed
PDB into the tinker layout so that either input style can be simulated.
"""

from __future__ import annotations

import functools

import numpy as np

from ai2bmd_torch.data import asset_path
from ai2bmd_torch.io.pdb import PDBAtoms


@functools.lru_cache(maxsize=None)
def amber2tinker_table() -> dict[str, np.ndarray]:
    raw = np.load(asset_path("amber2tinker.npz"), allow_pickle=False)
    return {k: raw[k] for k in raw.files}


def _tinker_expected_first(res: str) -> str:
    return {"ACE": "CH3", "NME": "N", "PRO": "N"}.get(res, "N")


def is_tinker_ordered(atoms: PDBAtoms) -> bool:
    """Heuristic: in tinker layout the backbone starts N, CA, C, O with H
    after O; in AMBER layout H immediately follows N."""
    names = atoms.atom_names
    resnum = atoms.residue_numbers
    for r in range(2, int(resnum.max())):
        idx = np.flatnonzero(resnum == r)
        if len(idx) < 5:
            continue
        local = [str(names[i]) for i in idx]
        if "H" not in local:
            continue
        return local.index("H") > local.index("O" if "O" in local else "CA")
    return True


def reorder_amber_to_tinker(atoms: PDBAtoms) -> PDBAtoms:
    """Return a copy with each residue permuted into tinker layout."""
    table = amber2tinker_table()
    order: list[int] = []
    resnum = atoms.residue_numbers
    for r in range(1, int(resnum.max()) + 1):
        idx = np.flatnonzero(resnum == r)
        res = str(atoms.residue_names[idx[0]]).strip()
        key = {"HIS": "HIE", "HID": "HIE"}.get(res, res)
        perm = table.get(key)
        if perm is not None and len(perm) == len(idx):
            order.extend(idx[perm].tolist())
        else:
            order.extend(idx.tolist())
    order = np.asarray(order)
    return PDBAtoms(
        positions=atoms.positions[order].copy(),
        numbers=atoms.numbers[order].copy(),
        atom_names=atoms.atom_names[order].copy(),
        residue_names=atoms.residue_names[order].copy(),
        residue_numbers=atoms.residue_numbers[order].copy(),
        cell=atoms.cell,
    )


def normalize_atom_order(atoms: PDBAtoms) -> PDBAtoms:
    if is_tinker_ordered(atoms):
        return atoms
    return reorder_amber_to_tinker(atoms)
