"""AMOEBA parameter assignment for proteins (and any biotype-covered
molecule): host numpy.

Port of ``ai2bmd_tpu/physics/amoeba_protein.py:1-393`` (``assign_amoeba``
and ``AmoebaAssignment``).  The reference gets AMOEBA on the protein by
shipping the geometry to Tinker9 (src/Calculators/tinker_async.py,
amoebabio18.prm at :130); this performs Tinker's parameter machinery from
the converted asset (``amoeba_params.npz``):

  biotype lookup  (atom name, residue) -> atom type, with the prm's
      generic-name convention (HB covers HB2/HB3, OD covers OD1/OD2; TRP's
      CD1/CD2 stay distinct, so the exact name is tried first)
  multipole frames: each type's records matched against the bonded
      neighbourhood (z among the neighbours, x among the neighbours of i or
      of z, Tinker kmpole's search order), Z-then-X (+ chirality y site) and
      bisector; the chkpole handedness flip is baked into the local dipole
      and quadrupole at build time
  scales: mpole 1-2/3/4/5 = 0/0/0.4/0.8, polar p-scale 1-2/3 = 0, vdW 1-2/3
      = 0 (bond-path BFS), and the group-based direct-11 = 0 mask from the
      prm's `polarize` group lists (connected components of in-group bonds)

Only the nonbonded AMOEBA terms are assigned here: in the subtractive QM/MM
combiner the protein's valence terms cancel between the two MM evaluations
(``physics/amoeba_valence.py`` assigns them for pure-AMOEBA MD).
``AmoebaVacuumSystem`` is the dense [N, N] evaluator of one molecule in
vacuum (``amoeba_protein.py:357-473``), sized for validation.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.physics.amoeba import (BOHR, AmoebaParams, _damping, _field_sum, _halgren,
                                         _parked, _sor, _value_and_forces,
                                         pair_permanent_energy, rotate_multipoles)
from ai2bmd_torch.utils.device import resolve_device

# PDB residue code -> prm biotype residue description
RESIDUE_DESC = {
    "ALA": "Alanine", "ARG": "Arginine", "ASN": "Asparagine",
    "ASP": "Aspartic Acid", "ASH": "Aspartic Acid (COOH)",
    "CYS": "Cysteine (SH)", "CYX": "Cystine (SS)", "CYM": "Cysteine (S-)",
    "GLN": "Glutamine", "GLU": "Glutamic Acid",
    "GLH": "Glutamic Acid (COOH)", "GLY": "Glycine",
    "HIS": "Histidine (HE)", "HIE": "Histidine (HE)",
    "HID": "Histidine (HD)", "HIP": "Histidine (+)",
    "ILE": "Isoleucine", "LEU": "Leucine", "LYS": "Lysine",
    "LYN": "Lysine (NH2)", "MET": "Methionine", "PHE": "Phenylalanine",
    "PRO": "Proline", "SER": "Serine", "THR": "Threonine",
    "TRP": "Tryptophan", "TYR": "Tyrosine", "VAL": "Valine",
    "ACE": "Acetyl N-Terminus", "NME": "N-MeAmide C-Terminus",
    "NHE": "Amide C-Terminus",
    "WAT": "Water", "HOH": "Water",
    "NA": "Sodium Ion", "NA+": "Sodium Ion", "CL": "Chloride Ion",
    "CL-": "Chloride Ion", "K": "Potassium Ion", "K+": "Potassium Ion",
}


def _biotype(par: AmoebaParams, res: str, name: str) -> int:
    desc = RESIDUE_DESC.get(res.upper())
    if desc is None:
        raise KeyError(f"no AMOEBA biotype mapping for residue {res!r}")
    # Resolution order: (1) PDB amide 'H' -> prm 'HN' (before the exact
    # match: NME has BOTH an amide H named HN and a methyl H named plain H
    # in the prm, and the PDB's amide atom is the bare 'H'); (2) exact
    # name (TRP CD1 vs CD2 are distinct types); (3) strip trailing digits
    # one at a time (HG21 -> HG2 -> HG covers THR's methyl and generic
    # HB2 -> HB); (4) methyl-hydrogen fallback HH3x -> 'H' (NME/ACE caps).
    cands = []
    if name == "H":
        cands.append("HN")
    cands.append(name)
    # ion atom names: 'Na+' -> prm 'NA', 'Cl-' -> 'CL'
    cands.append(name.upper().rstrip("+-"))
    stripped = name
    while stripped and stripped[-1].isdigit():
        stripped = stripped[:-1]
        cands.append(stripped)
    if name.startswith("H"):
        cands.append("H")
    for cand in cands:
        if cand and (cand, desc) in par.biotype:
            return par.biotype[(cand, desc)]
    raise KeyError(f"no biotype for atom {name!r} in {desc!r}")


# scale factors by bonded-path order (amoebabio18.prm header keywords)
MPOLE_SCALES = {1: 0.0, 2: 0.0, 3: 0.4, 4: 0.8}
POLAR_SCALES = {1: 0.0, 2: 0.0, 3: 1.0, 4: 1.0}
VDW_SCALES = {1: 0.0, 2: 0.0, 3: 1.0, 4: 1.0}


@dataclasses.dataclass
class AmoebaAssignment:
    """Host-side per-atom AMOEBA nonbonded parameterization.

    Scale information is stored SPARSELY (unique i<j pairs within 4 bonds
    + intra-polarization-group pairs) so solvated-box systems don't need
    [N,N] matrices; the dense matrices used by the small-system vacuum
    evaluator are built on demand via `mscale`/`pscale`/`dmask`/`vscale`.
    """

    n_atoms: int
    atype: np.ndarray        # [N] prm atom type
    q: np.ndarray            # [N] e
    dip_loc: np.ndarray      # [N,3] e*A (chirality flip baked in)
    quad_loc: np.ndarray     # [N,3,3] e*A^2
    frame_z: np.ndarray      # [N]
    frame_x: np.ndarray      # [N]
    frame_kind: np.ndarray   # [N] 0 z-then-x, 1 bisector (monatomic: self)
    alpha: np.ndarray        # [N] A^3
    thole: np.ndarray        # [N]
    group_id: np.ndarray     # [N] polarization group
    vdw_rmin: np.ndarray     # [N] A
    vdw_eps: np.ndarray      # [N] eV
    vdw_red: np.ndarray      # [N]
    heavy_of: np.ndarray     # [N]
    scale_pairs: np.ndarray  # [M,2] i<j pairs within 4 bonds
    scale_order: np.ndarray  # [M] bonded-path order 1..4
    group_pairs: np.ndarray  # [G,2] i<j pairs in the same polarization group
    bonds: np.ndarray        # [B,2]

    def _dense(self, table, default=1.0):
        n = self.n_atoms
        m = np.full((n, n), default)
        i, j = self.scale_pairs.T if len(self.scale_pairs) else ([], [])
        s = np.array([table[int(o)] for o in self.scale_order])
        if len(self.scale_pairs):
            m[i, j] = s
            m[j, i] = s
        m[np.eye(n, dtype=bool)] = 0.0
        return m

    @property
    def mscale(self):
        return self._dense(MPOLE_SCALES)

    @property
    def pscale(self):
        return self._dense(POLAR_SCALES)

    @property
    def vscale(self):
        return self._dense(VDW_SCALES)

    @property
    def dmask(self):
        return (self.group_id[:, None] != self.group_id[None, :]).astype(
            np.float64
        )


def _bond_path_pairs(n, bonds, max_order=4):
    """Sparse bonded-path orders: (pairs [M,2] i<j, order [M]) plus the
    adjacency list.  O(N * local-neighborhood), no [N,N] allocation."""
    adj = [[] for _ in range(n)]
    for i, j in bonds:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    pairs, orders = [], []
    for s in range(n):
        dist = {s: 0}
        frontier = [s]
        for depth in range(1, max_order + 1):
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v not in dist:
                        dist[v] = depth
                        nxt.append(v)
                        if v > s:
                            pairs.append((s, v))
                            orders.append(depth)
            frontier = nxt
    pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
    return pairs, np.asarray(orders, np.int8), adj


def assign_amoeba(atom_names, residue_names, positions, bonds) -> AmoebaAssignment:
    """Assign AMOEBA nonbonded parameters from names + connectivity.

    positions are only used to bake the chkpole chirality flips.
    """
    par = AmoebaParams.load()
    n = len(atom_names)
    P = np.asarray(positions, np.float64)
    scale_pairs, scale_order, adj = _bond_path_pairs(n, bonds)

    atype = np.array(
        [_biotype(par, str(r), str(a)) for a, r in zip(atom_names, residue_names)],
        np.int64,
    )

    q = np.zeros(n)
    dip = np.zeros((n, 3))
    quad = np.zeros((n, 3, 3))
    fz = np.arange(n)
    fx = np.arange(n)
    kind = np.zeros(n, np.int32)

    for i in range(n):
        recs = par.multipole.get(int(atype[i]))
        if recs is None:
            raise KeyError(f"no multipole records for type {atype[i]}")
        nbrs = adj[i]
        assigned = False
        for (frame, qq, d, Q) in recs:
            kz, kx, ky = (list(frame) + [0, 0, 0])[:3]
            if kz == 0:                           # monatomic ion
                q[i], dip[i], quad[i] = qq, 0.0, 0.0
                fz[i] = fx[i] = i
                kind[i] = 0
                assigned = True
                break
            z_cands = [j for j in nbrs if atype[j] == abs(kz)]
            if not z_cands:
                continue
            if kz < 0 and kx < 0:                 # bisector
                done = False
                for z in z_cands:
                    xs = [j for j in nbrs if j != z and atype[j] == abs(kx)]
                    if xs:
                        fz[i], fx[i], kind[i] = z, xs[0], 1
                        done = True
                        break
                if not done:
                    continue
            else:                                 # z-then-x (+ optional y)
                done = False
                for z in z_cands:
                    # x bonded to i first, then bonded to z (kmpole order)
                    xs = [j for j in nbrs if j != z and atype[j] == abs(kx)]
                    xs += [j for j in adj[z] if j != i and atype[j] == abs(kx)]
                    for x in xs:
                        if ky:
                            ys = [
                                j for j in nbrs + adj[z]
                                if j not in (i, z, x) and atype[j] == abs(ky)
                            ]
                            if not ys:
                                continue
                        fz[i], fx[i], kind[i] = z, x, 0
                        done = True
                        y_site = ys[0] if ky else None
                        break
                    if done:
                        break
                if not done:
                    continue
            q[i] = qq
            d_loc = np.asarray(d, np.float64) * BOHR
            Q_loc = np.asarray(Q, np.float64) * BOHR * BOHR
            if (kz > 0 or kx > 0) and ky and y_site is not None:
                # chkpole: if the y reference site sits on the -y side of
                # the right-handed (z, x) frame, the prm values describe
                # the mirror image — flip the y-sensitive components
                uz = P[fz[i]] - P[i]
                uz = uz / np.linalg.norm(uz)
                ux = P[fx[i]] - P[i]
                ux = ux - (ux @ uz) * uz
                ux = ux / np.linalg.norm(ux)
                uy = np.cross(uz, ux)
                if (P[y_site] - P[i]) @ uy < 0.0:
                    d_loc[1] *= -1.0
                    Q_loc[0, 1] *= -1.0
                    Q_loc[1, 0] *= -1.0
                    Q_loc[1, 2] *= -1.0
                    Q_loc[2, 1] *= -1.0
            dip[i] = d_loc
            quad[i] = Q_loc
            assigned = True
            break
        if not assigned:
            raise ValueError(
                f"no multipole frame of type {atype[i]} matches atom {i} "
                f"({atom_names[i]} {residue_names[i]}; neighbor types "
                f"{[int(atype[j]) for j in nbrs]})"
            )

    alpha = np.zeros(n)
    thole = np.zeros(n)
    group_types = {}
    for i in range(n):
        a, th, grp = par.polarize[int(atype[i])]
        alpha[i], thole[i] = a, th
        group_types[i] = set(grp)

    # polarization groups: connected components over in-group bonds
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in bonds:
        i, j = int(i), int(j)
        if atype[j] in group_types[i] or atype[i] in group_types[j]:
            parent[find(i)] = find(j)
    group_id = np.array([find(i) for i in range(n)], np.int64)

    vdw_rmin = np.zeros(n)
    vdw_eps = np.zeros(n)
    vdw_red = np.ones(n)
    heavy = np.arange(n)
    for i in range(n):
        r, e, red = par.vdw[par.type_to_class[int(atype[i])]]
        vdw_rmin[i], vdw_eps[i] = r, e * units.kcal_per_mol
        if red != 1.0 and len(adj[i]) == 1:
            vdw_red[i] = red
            heavy[i] = adj[i][0]

    # intra-polarization-group pairs (groups are small connected sets)
    members = collections.defaultdict(list)
    for i in range(n):
        members[int(group_id[i])].append(i)
    group_pairs = [
        (a, b)
        for mem in members.values()
        for ai, a in enumerate(mem)
        for b in mem[ai + 1:]
    ]
    group_pairs = np.asarray(group_pairs, np.int32).reshape(-1, 2)

    return AmoebaAssignment(
        n_atoms=n, atype=atype, q=q, dip_loc=dip, quad_loc=quad,
        frame_z=fz.astype(np.int32), frame_x=fx.astype(np.int32),
        frame_kind=kind, alpha=alpha, thole=thole, group_id=group_id,
        vdw_rmin=vdw_rmin, vdw_eps=vdw_eps, vdw_red=vdw_red,
        heavy_of=heavy.astype(np.int32),
        scale_pairs=scale_pairs, scale_order=scale_order,
        group_pairs=group_pairs,
        bonds=np.asarray(bonds, np.int32).reshape(-1, 2),
    )


@dataclasses.dataclass
class AmoebaVacuumSystem:
    """The nonbonded AMOEBA energy of one molecule in vacuum, dense masks
    (``amoeba_protein.py:357-473``): permanent multipoles scaled by the
    1-2 ... 1-5 mpole scales, SOR induction on the group-masked field with
    the energy on the p-scaled one, and vdW scaled by the vdW scales.
    ``device`` None means the card (raises without one)."""

    asg: AmoebaAssignment
    sor_iters: int = 40
    sor_omega: float = 0.7
    device: torch.device | str | None = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _t(self, name):
        a = np.asarray(getattr(self.asg, name))
        if a.dtype.kind in "iu":
            return torch.as_tensor(a.astype(np.int64), device=self.device)
        return torch.as_tensor(a.astype(np.float64), dtype=self.dtype, device=self.device)

    def lab_multipoles(self, P):
        mu, theta = rotate_multipoles(P, *(self._t(k) for k in (
            "frame_z", "frame_x", "frame_kind", "dip_loc", "quad_loc")))
        return self._t("q"), mu, theta          # monatomic sites rotate to zero

    def permanent_energy(self, P):
        q, mu, theta = self.lab_multipoles(P)
        ii, jj = np.triu_indices(self.asg.n_atoms, 1)
        mscale = self.asg.mscale[ii, jj]
        live = mscale > 0
        ii, jj = (torch.as_tensor(a[live], device=self.device) for a in (ii, jj))
        e = torch.func.vmap(pair_permanent_energy)(P[jj] - P[ii], q[ii], mu[ii], theta[ii],
                                                   q[jj], mu[jj], theta[jj])
        scale = torch.as_tensor(mscale[live], dtype=P.dtype, device=self.device)
        return units.COULOMB * (scale * e).sum()

    def _fields(self, P):
        """(E_d, E_p, r_i - r_j parked on the diagonal, the lambdas, off-diagonal
        mask): the damped permanent field masked by the polarization groups
        and scaled by the p-scales."""
        q, mu, theta = self.lab_multipoles(P)
        n = self.asg.n_atoms
        not_self = ~torch.eye(n, dtype=torch.bool, device=self.device)
        x = _parked(P[:, None, :] - P[None, :, :], not_self)
        alpha = self._t("alpha")
        lam = _damping(alpha ** (1.0 / 6.0), self._t("thole"), torch.sqrt((x * x).sum(-1)))
        t = lambda a: torch.as_tensor(a, dtype=P.dtype, device=self.device)
        E_d = _field_sum(x, q, mu, theta, lam, not_self, t(self.asg.dmask))
        E_p = _field_sum(x, q, mu, theta, lam, not_self, t(self.asg.pscale))
        return E_d, E_p, x, lam, not_self, alpha

    def induced_dipoles(self, P):
        """SCF on the group-masked field; (mu_ind, E_p)."""
        E_d, E_p, x, lam, not_self, alpha = self._fields(P)
        return _sor(E_d, x, lam, not_self, alpha, self.sor_iters, self.sor_omega), E_p

    def polarization_energy(self, P):
        mu_ind, E_p = self.induced_dipoles(P)
        return -0.5 * units.COULOMB * (mu_ind * E_p).sum()

    def vdw_energy(self, P):
        hv = self._t("heavy_of")
        sites = P[hv] + self._t("vdw_red")[:, None] * (P - P[hv])
        n = self.asg.n_atoms
        vs = torch.as_tensor(self.asg.vscale, dtype=P.dtype, device=self.device)
        live = torch.ones((n, n), dtype=torch.bool, device=self.device).triu(1) & (vs > 0)
        d = torch.where(live[..., None], sites[:, None, :] - sites[None, :, :],
                        torch.ones_like(sites[:, None, :] - sites[None, :, :]))
        e, _, _ = _halgren(torch.sqrt((d * d).sum(-1)), self._t("vdw_rmin"),
                           self._t("vdw_eps"))
        return torch.where(live, vs * e, torch.zeros_like(e)).sum()

    def energy(self, P):
        return self.permanent_energy(P) + self.polarization_energy(P) + self.vdw_energy(P)

    def energy_forces(self, P):
        return _value_and_forces(self.energy, P)

