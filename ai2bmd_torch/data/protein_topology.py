"""Full-system AMBER topology builder.

A copy of ``ai2bmd_tpu/data/protein_topology.py`` (numpy) that reads the
port's own ``data``, ``io.pdb`` and ``system``.

Builds bonds/angles/dihedrals/exclusions/nonbonded parameters for an entire
solvated system (protein + water + ions) from the converted ff19SB
capped-residue topologies — replacing the reference's reliance on
AmberTools tleap/sander outputs and Tinker's internal topology
(SURVEY.md section 2 native-dependency table).

Protein terms come from per-residue mapping: each residue's capped
ACE-X-NME prmtop contains every bonded term X participates in; junction
atoms map as  prev.C->ACE.C, prev.O->ACE.O, next.N->NME.N, next.H->NME.H,
next.CA->NME.CH3 (and PRO's next.CD->... is internal to the next residue's
own prmtop, so it is picked up there).  Terms appearing in two residues'
prmtops (e.g. the backbone C-N bond) are deduplicated on their global atom
tuple.

Water is flexible TIP3P (bond k=553 kcal/mol/A^2 r0=0.9572 A, angle
k=100 kcal/mol/rad^2 theta0=104.52 deg — standard public constants);
monovalent ions are nonbonded-only.

Exclusions follow AMBER convention: 1-2 and 1-3 fully excluded; 1-4 pairs
excluded from the plain sum and re-added scaled by 1/scee (Coulomb) and
1/scnb (LJ).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ai2bmd_torch import data
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.system import ION_RESIDUES, WATER_RESIDUES, assign_nonbonded_params

TIP3P_BOND_K = 553.0
TIP3P_BOND_R0 = 0.9572
TIP3P_ANGLE_K = 100.0
TIP3P_ANGLE_T0 = np.deg2rad(104.52)
SCEE = 1.2  # note: amber stores per-dihedral; ff19SB uses 1.2 (elec)
SCNB = 2.0  # and 2.0 (LJ) — careful: amber SCEE=1.2, SCNB=2.0


@dataclasses.dataclass
class SystemTopology:
    n_atoms: int
    charges: np.ndarray          # [N] e
    sigmas: np.ndarray           # [N] A
    epsilons: np.ndarray         # [N] kcal/mol
    masses: np.ndarray
    bonds: np.ndarray            # [B,2] int32
    bond_k: np.ndarray           # kcal/mol/A^2
    bond_r0: np.ndarray
    angles: np.ndarray           # [A,3]
    angle_k: np.ndarray
    angle_t0: np.ndarray
    dihedrals: np.ndarray        # [D,4] (proper + improper, multi-term)
    dih_k: np.ndarray
    dih_n: np.ndarray
    dih_phase: np.ndarray
    excl_pairs: np.ndarray       # [E,2] 1-2 + 1-3 pairs (and water internal)
    pairs14: np.ndarray          # [P,2] 1-4 pairs (scaled)
    water_oxygens: np.ndarray    # [W] int32 indices
    protein_atoms: np.ndarray    # indices of protein atoms
    # ff19SB CMAP backbone phi/psi correction terms
    cmap_atoms: np.ndarray = None   # [M,5] C(-1) N CA C N(+1)
    cmap_type: np.ndarray = None    # [M] index into cmap_grids
    cmap_grids: np.ndarray = None   # [T,R,R] kcal/mol, phi-major, -180 deg origin


def _residue_spans(atoms: PDBAtoms):
    spans = []
    start = 0
    for i in range(1, len(atoms) + 1):
        if i == len(atoms) or atoms.residue_numbers[i] != atoms.residue_numbers[start]:
            spans.append((start, i))
            start = i
    return spans


def build_topology(atoms: PDBAtoms) -> SystemTopology:
    tops = data.fragment_topologies()
    templates = data.residue_templates()
    info = templates["info"]

    n = len(atoms)
    charges, sigmas, epsilons = assign_nonbonded_params(atoms)
    spans = _residue_spans(atoms)

    # classify residues
    res_kind = []
    for s, e in spans:
        name = str(atoms.residue_names[s]).strip().upper()
        if name in WATER_RESIDUES:
            res_kind.append("water")
        elif name in ION_RESIDUES or (e - s) == 1:
            res_kind.append("ion")
        else:
            res_kind.append("protein")

    # global name->index per residue
    def local_index(s, e):
        return {str(atoms.atom_names[i]): i for i in range(s, e)}

    bonds, bond_k, bond_r0 = [], [], []
    angles, angle_k, angle_t0 = [], [], []
    dihedrals, dih_k, dih_n, dih_phase = [], [], [], []
    seen_bonds, seen_angles, seen_dih = set(), set(), set()
    water_oxygens = []
    protein_atoms = []
    # CMAP: per-residue grids are deduplicated on their values so the global
    # table holds one copy per distinct map (ff19SB: one map per residue class)
    cmap_atoms, cmap_type = [], []
    cmap_grid_list, cmap_grid_key = [], {}
    seen_cmap = set()

    protein_spans = [
        (idx, s, e) for idx, ((s, e), kind) in enumerate(zip(spans, res_kind))
        if kind == "protein"
    ]
    for pi, (ri, s, e) in enumerate(protein_spans):
        protein_atoms.extend(range(s, e))
        name = str(atoms.residue_names[s]).strip()
        if name in ("ACE", "NME"):
            continue  # covered as junction atoms of their neighbors
        key = {"HIS": "HH", "HIE": "HH"}.get(name, info.get(name, (None,))[0])
        if key is None or key not in tops:
            raise KeyError(f"no capped topology for residue {name}")
        top = tops[key]

        # mapping: prmtop atom index -> global index
        res_of = top.residue_of_atom()
        # central residue in the prmtop is residue 1 (0-based; ACE=0, NME=2)
        local = local_index(s, e)
        prev_local = next_local = {}
        if pi > 0:
            _, ps, pe = protein_spans[pi - 1]
            prev_local = local_index(ps, pe)
        if pi + 1 < len(protein_spans):
            _, ns, ne = protein_spans[pi + 1]
            next_local = local_index(ns, ne)

        mapping: dict[int, int] = {}
        for ai in range(top.natom):
            aname = top.atom_names[ai]
            r = res_of[ai]
            if r == 1:  # central residue
                if aname in local:
                    mapping[ai] = local[aname]
            elif r == 0:  # ACE cap -> previous residue's C/O (or real ACE)
                tgt = {"C": "C", "O": "O", "CH3": "CH3", "H1": "H1",
                       "H2": "H2", "H3": "H3", "HH31": "H1", "HH32": "H2",
                       "HH33": "H3"}.get(aname)
                prev_is_ace = prev_local and str(
                    atoms.residue_names[list(prev_local.values())[0]]
                ).strip() == "ACE"
                if tgt and prev_local:
                    if prev_is_ace:
                        # map methyl too
                        if tgt in prev_local:
                            mapping[ai] = prev_local[tgt]
                    elif tgt in ("C", "O") and tgt in prev_local:
                        mapping[ai] = prev_local[tgt]
            else:  # NME cap -> next residue's N/H/CA (or real NME)
                next_is_nme = next_local and str(
                    atoms.residue_names[list(next_local.values())[0]]
                ).strip() == "NME"
                tgt = {"N": "N", "H": "H", "CH3": "CH3" if next_is_nme else "CA",
                       "HH31": "HH31", "HH32": "HH32", "HH33": "HH33"}.get(aname)
                if tgt and next_local and tgt in next_local:
                    mapping[ai] = next_local[tgt]
                elif aname == "CH3" and next_local and "CA" in next_local:
                    mapping[ai] = next_local["CA"]

        def try_map(idxs):
            out = []
            for ai in idxs:
                if ai not in mapping:
                    return None
                out.append(mapping[ai])
            return tuple(out)

        for arr, dest, keys, seen in (
            (top.bonds_h, "b", 2, seen_bonds),
            (top.bonds_noh, "b", 2, seen_bonds),
            (top.angles_h, "a", 3, seen_angles),
            (top.angles_noh, "a", 3, seen_angles),
        ):
            for row in arr:
                g = try_map(row[:keys])
                if g is None:
                    continue
                canon = tuple(min(g, g[::-1]))
                if canon in seen:
                    continue
                seen.add(canon)
                t = row[keys]
                if dest == "b":
                    bonds.append(g)
                    bond_k.append(top.bond_k[t])
                    bond_r0.append(top.bond_r0[t])
                else:
                    angles.append(g)
                    angle_k.append(top.angle_k[t])
                    angle_t0.append(top.angle_t0[t])

        for arr in (top.dihedrals_h, top.dihedrals_noh):
            for row in arr:
                g = try_map(row[:4])
                if g is None:
                    continue
                # multi-term dihedrals share atoms; key on atoms + params
                t = row[4]
                canon = tuple(min(g, g[::-1])) + (
                    round(float(top.dihedral_k[t]), 6),
                    round(float(top.dihedral_n[t]), 3),
                    round(float(top.dihedral_phase[t]), 6),
                    int(row[6]),          # improper flag distinguishes
                )
                if canon in seen_dih:
                    continue
                seen_dih.add(canon)
                dihedrals.append(g)
                dih_k.append(top.dihedral_k[t])
                dih_n.append(top.dihedral_n[t])
                dih_phase.append(top.dihedral_phase[t])

        for row in top.cmap_index:
            g = try_map(row[:5])
            if g is None or g in seen_cmap:
                continue
            seen_cmap.add(g)
            grid = top.cmap_grids[row[5]]
            key = grid.tobytes()
            if key not in cmap_grid_key:
                cmap_grid_key[key] = len(cmap_grid_list)
                cmap_grid_list.append(grid)
            cmap_atoms.append(g)
            cmap_type.append(cmap_grid_key[key])

    # water + ions
    for (s, e), kind in zip(spans, res_kind):
        if kind == "water":
            o = [i for i in range(s, e) if atoms.numbers[i] == 8]
            h = [i for i in range(s, e) if atoms.numbers[i] == 1]
            assert len(o) == 1 and len(h) == 2, "water residue must be O+2H"
            water_oxygens.append(o[0])
            for hi in h:
                bonds.append((o[0], hi))
                bond_k.append(TIP3P_BOND_K)
                bond_r0.append(TIP3P_BOND_R0)
            angles.append((h[0], o[0], h[1]))
            angle_k.append(TIP3P_ANGLE_K)
            angle_t0.append(TIP3P_ANGLE_T0)

    # exclusions from the bond graph
    adj: dict[int, set[int]] = {}
    for i, j in bonds:
        adj.setdefault(i, set()).add(j)
        adj.setdefault(j, set()).add(i)
    excl, p14 = set(), set()
    for i in range(n):
        n1 = adj.get(i, set())
        for j in n1:
            if i < j:
                excl.add((i, j))
            for k in adj.get(j, set()):
                if k != i and i < k:
                    excl.add((i, k))
                for l in adj.get(k, set()):
                    if l not in (i, j) and i < l and l not in n1:
                        p14.add((i, l))
    p14 -= excl
    # a 1-4 pair that is also 1-2/1-3 via a ring path is fully excluded
    p14 = {
        (i, j) for (i, j) in p14
        if j not in adj.get(i, set())
    }

    def arr(x, dtype=np.float64):
        return np.asarray(x, dtype=dtype)

    return SystemTopology(
        n_atoms=n,
        charges=charges,
        sigmas=sigmas,
        epsilons=epsilons,
        masses=atoms.masses,
        bonds=arr(bonds, np.int32).reshape(-1, 2),
        bond_k=arr(bond_k),
        bond_r0=arr(bond_r0),
        angles=arr(angles, np.int32).reshape(-1, 3),
        angle_k=arr(angle_k),
        angle_t0=arr(angle_t0),
        dihedrals=arr(dihedrals, np.int32).reshape(-1, 4),
        dih_k=arr(dih_k),
        dih_n=arr(dih_n),
        dih_phase=arr(dih_phase),
        excl_pairs=arr(sorted(excl), np.int32).reshape(-1, 2),
        pairs14=arr(sorted(p14), np.int32).reshape(-1, 2),
        water_oxygens=arr(water_oxygens, np.int32),
        protein_atoms=arr(sorted(protein_atoms), np.int32),
        cmap_atoms=arr(cmap_atoms, np.int32).reshape(-1, 5),
        cmap_type=arr(cmap_type, np.int32),
        cmap_grids=(
            np.stack(cmap_grid_list)
            if cmap_grid_list else np.zeros((0, 24, 24))
        ),
    )
