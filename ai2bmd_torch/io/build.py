"""Synthetic peptide builder (extended-conformation polyalanine).

Generates ACE-(ALA)n-NME chains from ideal internal coordinates via NeRF
(natural extension reference frames).  Used for self-contained tests,
dry runs, and benchmarks when no input PDB is available; geometry is close
enough to ideal that the AMBER cap optimizer and pre-equilibration relax it
immediately.  Output uses the tinker atom layout the fragmentation
templates expect (ai2bmd_torch.io.reorder).  A copy of
``ai2bmd_tpu/io/build.py``: the same chains, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

from ai2bmd_torch.io.pdb import PDBAtoms


def _place(a, b, c, bond, angle_deg, torsion_deg):
    """NeRF: position of atom d given chain a-b-c and internal coords."""
    angle = math.radians(angle_deg)
    torsion = math.radians(torsion_deg)
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= max(np.linalg.norm(n), 1e-9)
    m = np.cross(n, bc)
    d_local = np.array(
        [
            -bond * math.cos(angle),
            bond * math.sin(angle) * math.cos(torsion),
            bond * math.sin(angle) * math.sin(torsion),
        ]
    )
    return c + d_local[0] * bc + d_local[1] * m + d_local[2] * n


def build_polyalanine(n_res: int, phi: float = -135.0, psi: float = 135.0) -> PDBAtoms:
    """ACE-(ALA)n-NME in a beta-strand-like conformation."""
    return build_peptide(["ALA"] * n_res, phi=phi, psi=psi)


def build_peptide(sequence: list[str], phi: float = -135.0, psi: float = 135.0) -> PDBAtoms:
    """ACE-<sequence>-NME chain from ideal internal coordinates.

    Supported residues: ALA, GLY, CYX (cysteine in a disulfide; SG placed
    so the fragmentation indexer's min-distance S-S pairing can be
    exercised)."""
    n_res = len(sequence)
    if n_res < 2:
        raise ValueError("need at least 2 residues to fragment")
    for res in sequence:
        if res not in ("ALA", "GLY", "CYX"):
            raise ValueError(f"unsupported residue {res!r}")
    positions: list[np.ndarray] = []
    names: list[str] = []
    resnames: list[str] = []
    resnums: list[int] = []
    numbers: list[int] = []

    def add(name, z, pos, res, resn):
        names.append(name)
        numbers.append(z)
        positions.append(np.asarray(pos, float))
        resnames.append(res)
        resnums.append(resn)
        return np.asarray(pos, float)

    # ACE: CH3, C, O, H1, H2, H3 (tinker order)
    ch3 = add("CH3", 6, [0.0, 0.0, 0.0], "ACE", 1)
    c = add("C", 6, [1.522, 0.0, 0.0], "ACE", 1)
    o = _place(np.array([0.0, 1.0, 0.0]), ch3, c, 1.229, 121.0, 0.0)
    add("O", 8, o, "ACE", 1)
    for k, t in enumerate((60.0, 180.0, 300.0)):
        h = _place(o, c, ch3, 1.09, 109.5, t)
        add(f"H{k + 1}", 1, h, "ACE", 1)

    prev = {"CA": ch3, "C": c, "O": o}
    for r, res in enumerate(sequence):
        resn = r + 2
        n = _place(prev["O"], prev["CA"], prev["C"], 1.335, 116.6, 180.0)
        ca = _place(prev["CA"], prev["C"], n, 1.449, 121.9, 180.0)
        cc = _place(prev["C"], n, ca, 1.522, 110.1, phi)
        oo = _place(n, ca, cc, 1.229, 120.5, psi + 180.0)
        add("N", 7, n, res, resn)
        add("CA", 6, ca, res, resn)
        add("C", 6, cc, res, resn)
        add("O", 8, oo, res, resn)
        h = _place(prev["C"], ca, n, 1.01, 118.0, 180.0)
        add("H", 1, h, res, resn)
        if res == "GLY":
            add("HA2", 1, _place(n, cc, ca, 1.09, 108.0, 120.0), res, resn)
            add("HA3", 1, _place(n, cc, ca, 1.09, 108.0, -120.0), res, resn)
        else:
            add("HA", 1, _place(n, cc, ca, 1.09, 108.0, 120.0), res, resn)
            cb = _place(n, cc, ca, 1.526, 110.5, -120.0)
            add("CB", 6, cb, res, resn)
            if res == "ALA":
                for k, t in enumerate((60.0, 180.0, 300.0)):
                    add(f"HB{k + 1}", 1, _place(n, ca, cb, 1.09, 109.5, t), res, resn)
            else:  # CYX: tinker order CB, SG, then HB2/HB3
                sg = _place(n, ca, cb, 1.81, 108.9, 180.0)
                add("SG", 16, sg, res, resn)
                add("HB2", 1, _place(n, ca, cb, 1.09, 109.5, 60.0), res, resn)
                add("HB3", 1, _place(n, ca, cb, 1.09, 109.5, 300.0), res, resn)
        prev = {"CA": ca, "C": cc, "O": oo}

    # NME: N, CH3, H, H1, H2, H3 (tinker order: N, CH3=C? the templates use
    # names N, CH3, H, HH31..; our ff table keys: NME N/CH3/H...)
    resn = n_res + 2
    n = _place(prev["O"], prev["CA"], prev["C"], 1.335, 116.6, 180.0)
    ch3 = _place(prev["CA"], prev["C"], n, 1.449, 121.9, 180.0)
    add("N", 7, n, "NME", resn)
    add("CH3", 6, ch3, "NME", resn)
    add("H", 1, _place(prev["C"], ch3, n, 1.01, 118.0, 180.0), "NME", resn)
    for k, t in enumerate((60.0, 180.0, 300.0)):
        add(f"HH3{k + 1}", 1, _place(prev["C"], n, ch3, 1.09, 109.5, t), "NME", resn)

    return PDBAtoms(
        positions=np.asarray(positions),
        numbers=np.asarray(numbers, np.int32),
        atom_names=np.asarray(names),
        residue_names=np.asarray(resnames),
        residue_numbers=np.asarray(resnums, np.int32),
        cell=None,
    )
