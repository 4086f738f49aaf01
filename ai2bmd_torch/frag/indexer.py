"""Host-side fragmentation index builder.

One-time setup that turns a capped protein into static, padded index arrays
consumed by the per-step pipeline (ai2bmd_torch.frag.runtime).  This is
the replacement for the reference's fragment engine
(src/Fragmentation/basefrag.py:93-167 and
src/Fragmentation/distancefrag.py:94-363): same fragmentation chemistry,
but the output is a fixed-shape [rows, slots] layout instead of ragged
per-fragment python lists, so the per-step path is pure gather/scatter.

Fragmentation scheme (reference semantics, Nature 2024 AI2BMD):
  * a protein with R residues (incl. ACE/NME caps) splits into R-2
    overlapping dipeptides and R-3 ACE-NME units
  * each dipeptide = [cap unit from prev residue: CA,HA,C,O + cap H]
    + central residue + [cap unit from next residue: N,H,CA,HA + cap H];
    severed bonds are terminated with hydrogens placed along the
    acceptor->replaced-atom direction at covalent-radius distance
  * atoms are permuted into the AMBER template order the ViSNet
    checkpoints were trained on (seq_permutations asset)
  * ACE-NME unit c = first 6 slots of dipeptide c+1 + last 6 slots of
    dipeptide c (both already in template order)
  * CYX-CYX disulfide dipeptide pairs merge into a single 44-atom fragment
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ai2bmd_torch import data
from ai2bmd_torch.io.pdb import PDBAtoms

# covalent radii used for cap-H bond lengths
# (reference: src/Fragmentation/distancefrag.py:383-388)
_RADII = {"H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66}

ACENME_Z = np.array([1, 6, 1, 1, 6, 8, 7, 1, 6, 1, 1, 1], dtype=np.int32)
ACENME_LEN = 12


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class FragmentIndex:
    """Static fragment layout.  All arrays are host numpy; shapes are final."""

    n_atoms: int
    n_dipeptides: int          # original dipeptide count (pre CYX merge)
    n_acenmes: int
    n_rows: int                # dipeptide rows incl. empty merged-away rows
    slots: int                 # padded slots per dipeptide row

    row_type: list[str]        # template name per row ('' for empty rows)
    row_prmtop: list[str]      # prmtop key per row ('' for empty rows)
    row_natom: np.ndarray      # [rows] true atom count per row
    row_z: np.ndarray          # [rows, slots] template atomic numbers (0 pad)
    valid: np.ndarray          # [rows, slots] bool
    is_cap: np.ndarray         # [rows, slots] bool (added hydrogens)
    gather_idx: np.ndarray     # [rows, slots] protein atom (acceptor for caps)
    cap_dir_idx: np.ndarray    # [rows, slots] protein atom the cap H replaces
    cap_radius: np.ndarray     # [rows, slots] cap bond length (A)

    dip_row: np.ndarray        # [n_dipeptides] row of each original dipeptide
    dip_offset: np.ndarray     # [n_dipeptides] slot offset within the row
    dip_length: np.ndarray     # [n_dipeptides]

    ace_rows: np.ndarray       # [n_acenmes, 12]
    ace_slots: np.ndarray      # [n_acenmes, 12]

    exclusion_pairs: np.ndarray  # [n_excl, 2] same-dipeptide protein pairs i<j

    @property
    def ace_is_cap(self) -> np.ndarray:
        return self.is_cap[self.ace_rows, self.ace_slots]

    @property
    def ace_origin(self) -> np.ndarray:
        return self.gather_idx[self.ace_rows, self.ace_slots]

    def exclusion_mask(self) -> np.ndarray:
        m = np.zeros((self.n_atoms, self.n_atoms), dtype=bool)
        if len(self.exclusion_pairs):
            i, j = self.exclusion_pairs.T
            m[i, j] = True
            m[j, i] = True
        return m


# ---------------------------------------------------------------------------
# raw membership (reference: basefrag.DipeptideFragment.get_fragments_index)
# ---------------------------------------------------------------------------

def _is_ha(name: str) -> bool:
    return name[:2] == "HA"


def _residue_atoms(atoms: PDBAtoms) -> list[np.ndarray]:
    """Atom indices per 1-based residue number (index 0 unused)."""
    n_res = int(atoms.residue_numbers.max())
    out = [np.zeros(0, dtype=np.int64)] * (n_res + 1)
    for r in range(1, n_res + 1):
        out[r] = np.flatnonzero(atoms.residue_numbers == r)
    return out


def raw_dipeptide_members(atoms: PDBAtoms) -> tuple[list[list[int]], list[list[int]]]:
    """Per-dipeptide raw atom index lists (sidechain spliced before 2nd N)
    and per-ACE-NME raw member lists."""
    res_atoms = _residue_atoms(atoms)
    n_res = len(res_atoms) - 1
    n_dip = n_res - 2
    n_ace = n_res - 3
    if n_dip < 2:
        raise ValueError(
            "protein must have at least 4 residues including ACE/NME caps; "
            "use visnet (no-fragmentation) mode for smaller systems"
        )
    names = atoms.atom_names
    resnames = atoms.residue_names

    dipeptides: list[list[int]] = []
    for d in range(n_dip):
        prev_r, cent_r, next_r = d + 1, d + 2, d + 3
        unit: list[int] = []
        # previous residue: full ACE for the first dipeptide, else CA/HA/C/O
        if str(resnames[res_atoms[prev_r][0]]).strip() == "ACE":
            unit.extend(res_atoms[prev_r].tolist())
        else:
            for i in res_atoms[prev_r]:
                if names[i] in ("CA", "C", "O") or _is_ha(str(names[i])):
                    unit.append(int(i))
        # central residue: backbone in file order; sidechain collected aside
        backbone, sidechain = [], []
        for i in res_atoms[cent_r]:
            if names[i] in ("N", "H", "CA", "C", "O") or _is_ha(str(names[i])):
                backbone.append(int(i))
            else:
                sidechain.append(int(i))
        unit.extend(backbone)
        # next residue: full NME for the last dipeptide, else N/H/CA/HA
        tail = []
        if str(resnames[res_atoms[next_r][0]]).strip() == "NME":
            tail.extend(res_atoms[next_r].tolist())
        else:
            for i in res_atoms[next_r]:
                if names[i] in ("N", "H", "CA") or _is_ha(str(names[i])):
                    tail.append(int(i))
        unit.extend(tail)
        # splice sidechain just before the second bare 'N'
        nitrogen_pos = [k for k, i in enumerate(unit) if names[i] == "N"]
        assert len(nitrogen_pos) == 2, (
            f"dipeptide {d}: expected 2 backbone N atoms, got {len(nitrogen_pos)}"
        )
        unit[nitrogen_pos[1]:nitrogen_pos[1]] = sidechain
        dipeptides.append(unit)

    acenmes: list[list[int]] = []
    for c in range(n_ace):
        unit = []
        for i in res_atoms[c + 2]:
            if names[i] in ("CA", "C", "O") or _is_ha(str(names[i])):
                unit.append(int(i))
        for i in res_atoms[c + 3]:
            if names[i] in ("N", "H", "CA") or _is_ha(str(names[i])):
                unit.append(int(i))
        acenmes.append(unit)

    return dipeptides, acenmes


# ---------------------------------------------------------------------------
# cap hydrogens (reference: distancefrag.get_hydrogen_indices)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CapSpec:
    acceptor: int   # protein atom the H bonds to
    replaced: int   # protein atom whose direction the H takes
    radius: float


def _first_named(atoms: PDBAtoms, residue: int, name: str) -> int:
    idx = np.flatnonzero(
        (atoms.residue_numbers == residue) & (atoms.atom_names == name)
    )
    if len(idx) == 0:
        raise ValueError(f"no atom {name!r} in residue {residue}")
    return int(idx[0])


def cap_hydrogens(atoms: PDBAtoms, d: int, unit: list[int]) -> list[CapSpec]:
    """Cap-H specs for dipeptide d, in the reference's generation order
    (N-terminal side first, then C-terminal side)."""
    resnames = atoms.residue_names
    caps: list[CapSpec] = []
    ch = _RADII["C"] + _RADII["H"]
    nh = _RADII["N"] + _RADII["H"]

    prev_res, next_res = d + 1, d + 3
    prev_name = str(resnames[unit[0]]).strip()
    next_name = str(resnames[unit[-1]]).strip()

    if prev_name == "GLY":
        ca = _first_named(atoms, prev_res, "CA")
        caps.append(CapSpec(ca, _first_named(atoms, prev_res, "N"), ch))
    elif prev_name != "ACE":
        ca = _first_named(atoms, prev_res, "CA")
        caps.append(CapSpec(ca, _first_named(atoms, prev_res, "N"), ch))
        caps.append(CapSpec(ca, _first_named(atoms, prev_res, "CB"), ch))

    if next_name == "GLY":
        ca = _first_named(atoms, next_res, "CA")
        caps.append(CapSpec(ca, _first_named(atoms, next_res, "C"), ch))
    elif next_name == "PRO":
        ca = _first_named(atoms, next_res, "CA")
        caps.append(CapSpec(ca, _first_named(atoms, next_res, "C"), ch))
        caps.append(CapSpec(ca, _first_named(atoms, next_res, "CB"), ch))
        caps.append(
            CapSpec(
                _first_named(atoms, next_res, "N"),
                _first_named(atoms, next_res, "CD"),
                nh,
            )
        )
    elif next_name != "NME":
        ca = _first_named(atoms, next_res, "CA")
        caps.append(CapSpec(ca, _first_named(atoms, next_res, "C"), ch))
        caps.append(CapSpec(ca, _first_named(atoms, next_res, "CB"), ch))

    return caps


# ---------------------------------------------------------------------------
# template ordering (reference: distancefrag.calculate_permutation_indices)
# ---------------------------------------------------------------------------

def _intermediate_order(state: int, last_res: str, next_res: str, length: int):
    """Rearrangement that moves appended cap hydrogens to their template
    positions.  state: 0 = first dipeptide, 1 = last, 2 = middle."""
    idx = list(range(length))
    out: list[int] = []
    if state == 0:
        if next_res != "PRO":
            out.extend(idx)
        else:
            out.extend(idx[:-5])
            out.append(idx[-1])
            out.extend(idx[-5:-1])
    elif state == 1:
        n_caps = 1 if last_res == "GLY" else 2
        out.extend([idx[1], idx[0]])
        out.extend(idx[-n_caps:])
        out.extend(idx[2:-n_caps])
    else:
        out.extend([idx[1], idx[0]])
        if next_res == "PRO":
            n_head = 1 if last_res == "GLY" else 2
            # N-side caps sit 4th/5th from the end (3 C-side caps follow)
            if n_head == 2:
                out.extend([idx[-4], idx[-5]])
                mid_end = -7
            else:
                out.append(idx[-4])
                mid_end = -6
            out.extend(idx[2:mid_end])
            out.append(idx[-1])                 # N-CD cap -> 5th from end
            out.extend(idx[mid_end:mid_end + 2])  # the C,O pair before NME unit
            out.extend(idx[-3:-1])
        elif next_res == "GLY":
            if last_res != "GLY":
                out.extend([idx[-2], idx[-3]])
                out.extend(idx[2:-3])
            else:
                out.append(idx[-2])
                out.extend(idx[2:-2])
            out.append(idx[-1])
        else:
            if last_res != "GLY":
                out.extend([idx[-3], idx[-4]])
                out.extend(idx[2:-4])
            else:
                out.append(idx[-3])
                out.extend(idx[2:-3])
            out.extend(idx[-2:])
    assert sorted(out) == idx, "intermediate order is not a permutation"
    return out


def template_permutation(
    state: int, resi_name: str, last_res: str, next_res: str, length: int
) -> np.ndarray:
    """final[i] = raw[perm[i]]: raw order (original atoms + appended cap H)
    -> AMBER template order."""
    inter = _intermediate_order(state, last_res, next_res, length)
    seq = data.seq_permutations()
    key = f"{last_res}_{resi_name}_{next_res}"
    if key not in seq:
        raise KeyError(f"no template permutation for residue triple {key}")
    perm = seq[key]
    assert len(perm) == length, (
        f"{key}: template length {len(perm)} != dipeptide length {length}"
    )
    return np.asarray(inter, dtype=np.int64)[perm]


# ---------------------------------------------------------------------------
# disulfides (reference: distancefrag.get_cystine_bonds)
# ---------------------------------------------------------------------------

def cystine_pairs(atoms: PDBAtoms, dipeptides: list[list[int]], resi_names: list[str]):
    cyx = [d for d, name in enumerate(resi_names) if name == "CYX"]
    if not cyx:
        return {}
    sg = []
    for d in cyx:
        s = [i for i in dipeptides[d] if atoms.atom_names[i] == "SG"]
        assert len(s) == 1, "CYX dipeptide without exactly one SG atom"
        sg.append(s[0])
    assert len(cyx) % 2 == 0, "odd number of CYX residues"
    pos = atoms.positions[sg]
    dist = np.linalg.norm(pos[None] - pos[:, None], axis=-1)
    np.fill_diagonal(dist, np.inf)
    pairs = {}
    used = set()
    for i, j in enumerate(np.argmin(dist, axis=-1)):
        if i in used or j in used:
            continue
        pairs[cyx[i]] = cyx[int(j)]
        used.update((i, int(j)))
    return pairs


# ---------------------------------------------------------------------------
# top-level build
# ---------------------------------------------------------------------------

def build_fragment_index(atoms: PDBAtoms, slot_multiple: int = 8) -> FragmentIndex:
    templates = data.residue_templates()
    dipeptides, _acenmes = raw_dipeptide_members(atoms)
    n_dip = len(dipeptides)
    n_ace = n_dip - 1
    n_atoms = len(atoms)
    resnames = atoms.residue_names

    # central residue name per dipeptide; the 7th raw atom always belongs to
    # the central residue (6-atom cap unit precedes it)
    resi_names = [str(resnames[unit[6]]).strip() for unit in dipeptides]
    states = [0] + [2] * (n_dip - 2) + [1]
    last_names = ["ACE"] + resi_names[:-1]
    next_names = resi_names[1:] + ["NME"]

    caps = [cap_hydrogens(atoms, d, unit) for d, unit in enumerate(dipeptides)]
    lengths = [len(u) + len(c) for u, c in zip(dipeptides, caps)]
    perms = [
        template_permutation(states[d], resi_names[d], last_names[d], next_names[d], lengths[d])
        for d in range(n_dip)
    ]

    # --- disulfide merge ---
    ss = cystine_pairs(atoms, dipeptides, resi_names)
    # row composition: each row is a list of original dipeptide ids
    merged_away = set(ss.values())
    row_members: list[list[int]] = []
    for d in range(n_dip):
        if d in merged_away:
            row_members.append([])
        elif d in ss:
            row_members.append([d, ss[d]])
        else:
            row_members.append([d])

    row_type = []
    row_prmtop = []
    info = templates["info"]
    for d, members in enumerate(row_members):
        if not members:
            row_type.append("")
            row_prmtop.append("")
        elif len(members) == 2:
            row_type.append("CYX")
            row_prmtop.append("CYX")
        else:
            name = resi_names[members[0]]
            row_type.append(name)
            row_prmtop.append(info[name][0])

    n_rows = n_dip
    max_len = max(
        sum(lengths[m] for m in members) if members else 0
        for members in row_members
    )
    slots = _round_up(max(max_len, ACENME_LEN), slot_multiple)

    valid = np.zeros((n_rows, slots), dtype=bool)
    is_cap = np.zeros((n_rows, slots), dtype=bool)
    gather_idx = np.zeros((n_rows, slots), dtype=np.int32)
    cap_dir_idx = np.zeros((n_rows, slots), dtype=np.int32)
    cap_radius = np.zeros((n_rows, slots), dtype=np.float32)
    row_z = np.zeros((n_rows, slots), dtype=np.int32)
    row_natom = np.zeros(n_rows, dtype=np.int32)

    dip_row = np.zeros(n_dip, dtype=np.int32)
    dip_offset = np.zeros(n_dip, dtype=np.int32)
    dip_length = np.array(lengths, dtype=np.int32)

    for r, members in enumerate(row_members):
        offset = 0
        for d in members:
            unit, cap, perm, length = dipeptides[d], caps[d], perms[d], lengths[d]
            n_orig = len(unit)
            dip_row[d] = r
            dip_offset[d] = offset
            for s_local, raw_idx in enumerate(perm):
                s = offset + s_local
                valid[r, s] = True
                if raw_idx < n_orig:
                    a = unit[raw_idx]
                    gather_idx[r, s] = a
                    cap_dir_idx[r, s] = a
                    row_z[r, s] = atoms.numbers[a]
                else:
                    spec = cap[raw_idx - n_orig]
                    is_cap[r, s] = True
                    gather_idx[r, s] = spec.acceptor
                    cap_dir_idx[r, s] = spec.replaced
                    cap_radius[r, s] = spec.radius
                    row_z[r, s] = 1
            offset += length
        row_natom[r] = offset
        if len(members) == 2:
            # a merged cystine row must not contain the same protein atom
            # twice: sequence-adjacent CYX pairs (|i-j| <= 2) share backbone
            # atoms between the two dipeptide halves, which puts duplicate
            # coordinates into one fragment (zero-distance AMBER pairs ->
            # NaN).  Chemically such disulfides do not exist; fail loudly
            # instead of producing NaN forces.  (The reference's merge,
            # distancefrag.py:189-240, has the same implicit assumption.)
            real = valid[r, :offset] & ~is_cap[r, :offset]
            gathered = gather_idx[r, :offset][real]
            if len(np.unique(gathered)) != len(gathered):
                raise ValueError(
                    "disulfide merge between sequence-adjacent cystines: "
                    f"dipeptides {members} share protein atoms; such a "
                    "disulfide is not representable as one fragment"
                )
        # hard parity check against the reference templates
        if members:
            tz = templates["z"][row_type[r]]
            assert len(tz) == offset, (
                f"row {r} ({row_type[r]}): length {offset} != template {len(tz)}"
            )
            assert np.array_equal(row_z[r, :offset], tz), (
                f"row {r} ({row_type[r]}): atom sequence does not match template"
            )

    # --- ACE-NME assembly: first 6 slots of dipeptide c+1 + last 6 of c ---
    ace_rows = np.zeros((n_ace, ACENME_LEN), dtype=np.int32)
    ace_slots = np.zeros((n_ace, ACENME_LEN), dtype=np.int32)
    for c in range(n_ace):
        nxt, cur = c + 1, c
        ace_rows[c, :6] = dip_row[nxt]
        ace_slots[c, :6] = dip_offset[nxt] + np.arange(6)
        ace_rows[c, 6:] = dip_row[cur]
        ace_slots[c, 6:] = dip_offset[cur] + dip_length[cur] - 6 + np.arange(6)
        assert np.array_equal(row_z[ace_rows[c], ace_slots[c]], ACENME_Z), (
            f"ACE-NME {c}: atom sequence does not match the AN template"
        )

    # --- same-dipeptide exclusion pairs (post-merge) ---
    pairs = set()
    for r, members in enumerate(row_members):
        atoms_r = sorted(
            {int(g) for g, cap_flag, v in zip(gather_idx[r], is_cap[r], valid[r]) if v and not cap_flag}
        )
        for a_i in range(len(atoms_r)):
            for b_i in range(a_i + 1, len(atoms_r)):
                pairs.add((atoms_r[a_i], atoms_r[b_i]))
    excl = np.array(sorted(pairs), dtype=np.int32) if pairs else np.zeros((0, 2), np.int32)

    return FragmentIndex(
        n_atoms=n_atoms,
        n_dipeptides=n_dip,
        n_acenmes=n_ace,
        n_rows=n_rows,
        slots=slots,
        row_type=row_type,
        row_prmtop=row_prmtop,
        row_natom=row_natom,
        row_z=row_z,
        valid=valid,
        is_cap=is_cap,
        gather_idx=gather_idx,
        cap_dir_idx=cap_dir_idx,
        cap_radius=cap_radius,
        dip_row=dip_row,
        dip_offset=dip_offset,
        dip_length=dip_length,
        ace_rows=ace_rows,
        ace_slots=ace_slots,
        exclusion_pairs=excl,
    )
