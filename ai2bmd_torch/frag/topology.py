"""Per-fragment-type AMBER topology tables for cap-hydrogen optimization.

Builds fixed-shape, type-indexed tensors from the converted ff19SB
capped-dipeptide topologies (data asset fragment_topologies.npz).  The
reference does this per dipeptide with torch tensors filtered to the cap
hydrogens (src/Fragmentation/hydrogen/ctable.py:168-231); here the tables
are per *template type* (at most ~25 of them), padded to common shapes, and
rows look their tables up by type id — the whole per-step optimization then
runs as fixed-shape batched tensor ops.

Two equivalent-simplifications vs the reference (constant terms w.r.t. the
only free coordinates, the cap hydrogens — same optimum, simpler tables):
  * all INC_HYDROGEN bonded terms are kept, not only those touching caps
  * the nonbonded pair list is the full exclusion complement, not only
    pairs touching caps
Units: AMBER native (kcal/mol, Angstrom, radians, amber charge units), as
in the reference optimizer (hydrogen/energies.py:8-61).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ai2bmd_torch import data


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclasses.dataclass
class TypeTopology:
    """Stacked [T, ...] tables; index 0 of every per-term row may be padding
    (force constant 0)."""

    names: list[str]                  # type order
    natom: np.ndarray                 # [T]
    # bonds
    bond_ij: np.ndarray               # [T, NB, 2] int32
    bond_k: np.ndarray                # [T, NB]
    bond_r0: np.ndarray               # [T, NB]
    # angles
    angle_ijk: np.ndarray             # [T, NA, 3]
    angle_k: np.ndarray               # [T, NA]
    angle_t0: np.ndarray              # [T, NA]
    # dihedrals (proper, first-term rows only; reference ctable.py:188-198)
    dih_ijkl: np.ndarray              # [T, ND, 4]
    dih_k: np.ndarray                 # [T, ND]
    dih_n: np.ndarray                 # [T, ND]
    dih_phase: np.ndarray             # [T, ND]
    # nonbonded exclusion-complement pairs
    nb_ij: np.ndarray                 # [T, NP, 2]
    nb_acoef: np.ndarray              # [T, NP]
    nb_bcoef: np.ndarray              # [T, NP]
    nb_qq: np.ndarray                 # [T, NP]  q_i q_j in amber charge units
    nb_mask: np.ndarray               # [T, NP]
    scee: float = 2.0
    scnb: float = 1.2

    def type_ids(self, prmtop_names: list[str]) -> np.ndarray:
        lut = {n: i for i, n in enumerate(self.names)}
        return np.array([lut.get(n, 0) for n in prmtop_names], dtype=np.int32)


def build_type_topology(type_names: list[str] | None = None, pad: int = 8) -> TypeTopology:
    """Build stacked tables for the given prmtop type names (default: all)."""
    tops = data.fragment_topologies()
    names = sorted(tops.keys()) if type_names is None else sorted(set(type_names))
    T = len(names)

    per_type = []
    for name in names:
        top = tops[name]
        n = top.natom

        bonds = top.bonds_h
        b_ij = bonds[:, :2]
        b_k = top.bond_k[bonds[:, 2]]
        b_r0 = top.bond_r0[bonds[:, 2]]

        angles = top.angles_h
        a_ijk = angles[:, :3]
        a_k = top.angle_k[angles[:, 3]]
        a_t0 = top.angle_t0[angles[:, 3]]

        dih = top.dihedrals_h
        keep = (dih[:, 5] == 0) & (dih[:, 6] == 0)
        dih = dih[keep]
        d_ijkl = dih[:, :4]
        d_k = top.dihedral_k[dih[:, 4]]
        d_n = top.dihedral_n[dih[:, 4]]
        d_ph = top.dihedral_phase[dih[:, 4]]

        # nonbonded: all pairs i<j minus amber exclusions
        excl = set(map(tuple, top.exclusion_pairs()))
        pairs = [
            (i, j)
            for i in range(n)
            for j in range(i + 1, n)
            if (i, j) not in excl
        ]
        pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
        ti = top.atom_type_index[pairs[:, 0]]
        tj = top.atom_type_index[pairs[:, 1]]
        lj = top.lj_pair_index(ti, tj)
        acoef = top.lj_acoef[lj]
        bcoef = top.lj_bcoef[lj]
        # charges stored in elementary units in our asset -> back to amber units
        qq = (top.charges[pairs[:, 0]] * top.charges[pairs[:, 1]]) * (18.2223**2)

        per_type.append(
            dict(
                natom=n, b_ij=b_ij, b_k=b_k, b_r0=b_r0,
                a_ijk=a_ijk, a_k=a_k, a_t0=a_t0,
                d_ijkl=d_ijkl, d_k=d_k, d_n=d_n, d_ph=d_ph,
                nb_ij=pairs, acoef=acoef, bcoef=bcoef, qq=qq,
            )
        )

    NB = _round_up(max(len(t["b_k"]) for t in per_type), pad)
    NA = _round_up(max(len(t["a_k"]) for t in per_type), pad)
    ND = _round_up(max(len(t["d_k"]) for t in per_type), pad)
    NP = _round_up(max(len(t["qq"]) for t in per_type), pad)

    def stack(key, width, n_pad, dtype=np.float32, is_idx=False):
        out = np.zeros((T, n_pad) + (() if width == 1 else (width,)),
                       dtype=np.int32 if is_idx else dtype)
        for t, d in enumerate(per_type):
            arr = d[key]
            m = len(arr)
            if m:
                out[t, :m] = arr
        return out

    nb_mask = np.zeros((T, NP), dtype=bool)
    for t, d in enumerate(per_type):
        nb_mask[t, : len(d["qq"])] = True

    return TypeTopology(
        names=names,
        natom=np.array([t["natom"] for t in per_type], dtype=np.int32),
        bond_ij=stack("b_ij", 2, NB, is_idx=True),
        bond_k=stack("b_k", 1, NB),
        bond_r0=stack("b_r0", 1, NB),
        angle_ijk=stack("a_ijk", 3, NA, is_idx=True),
        angle_k=stack("a_k", 1, NA),
        angle_t0=stack("a_t0", 1, NA),
        dih_ijkl=stack("d_ijkl", 4, ND, is_idx=True),
        dih_k=stack("d_k", 1, ND),
        dih_n=stack("d_n", 1, ND),
        dih_phase=stack("d_ph", 1, ND),
        nb_ij=stack("nb_ij", 2, NP, is_idx=True),
        nb_acoef=stack("acoef", 1, NP),
        nb_bcoef=stack("bcoef", 1, NP),
        nb_qq=stack("qq", 1, NP),
        nb_mask=nb_mask,
    )
