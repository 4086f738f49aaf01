"""AMOEBA valence (bonded) terms.

Port of ``ai2bmd_tpu/physics/amoeba_valence.py``: the Tinker valence energy
the reference runs through Tinker9 for minimization and pure-AMOEBA dynamics
(src/utils/preprocess.py:184-244, pdbxyz8 + minimize9;
src/Calculators/tinker_async.py:127-145, the full-AMOEBA key file).  In the
subtractive QM/MM combiner these terms cancel (``physics/qmmm.py``), so only
pure-AMOEBA MD, minimization and AMOEBA preprocessing (``physics/
amoeba_md.py``) evaluate them.

Tinker's defaults with the amoebabio18.prm header overrides:

  bond       k dt^2 (1 + c3 dt + c4 dt^2), dt = r - r0 [A]
  angle      k dt^2 (1 + c3 dt + ... + c6 dt^4), dt in DEGREES, angleunit
             (pi/180)^2 (k in kcal/mol/rad^2)
  anglep     the same on the in-plane angle at a trigonal centre (the centre
             projected onto the plane of its three attachments)
  strbnd     (pi/180) (k1 dr1 + k2 dr2) dt_deg
  ureybrad   k (r13 - r0)^2 (water H...H)
  opbend     the Allinger out-of-plane angle chi (bond d-b against the a-c-d
             plane at the trigonal centre b), the angle's sextic expansion
  torsion    0.5 sum_m amp_m (1 + cos(m phi - phase_m)) (torsionunit)
  pitors     k (1 + cos(2 phi - pi)) over the pi-orbital torsion
  strtors    sum over the 3 bonds: dr_b sum_m v[b,m] (1 + cos(m phi - ph_m))
  angtors    (pi/180) sum over the 2 angles: dt_a_deg sum_m v[a,m] (...)
  tortors    a periodic bicubic spline over (phi1, phi2) in degrees, with
             Tinker's chirality sign at the central atom

JAX's ``_mimg`` is ``ops/neighbors._pbc_diff`` here, which takes a cell of
None too.  ``build`` assigns every term on the host (numpy) from the atom classes and
the connectivity, and raises ``KeyError`` naming the class tuple a bond,
angle or torsion has no parameters for.  ``energy`` is torch on the tables'
device, forces by autograd; the angle functions guard their inputs, so the
gradient has no NaN where a guard holds.  Energies in eV.

The float tables are float32, as JAX builds them under any precision; with
float64 positions every product that meets a position is float64, and the
unit constants multiply the float32 tables in float32, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.data import asset_path
from ai2bmd_torch.ops.neighbors import _pbc_diff
from ai2bmd_torch.physics.amoeba import AmoebaParams
from ai2bmd_torch.physics.mm import _dihedral_angle, _safe_norm, cmap_bicubic_coeffs
from ai2bmd_torch.utils.device import resolve_device

DEG = 180.0 / math.pi
ANGLE_UNIT = (math.pi / 180.0) ** 2     # Tinker angleunit default
STRBND_UNIT = math.pi / 180.0           # Tinker stbnunit default
ANGTOR_UNIT = math.pi / 180.0           # Tinker atorunit default

_raw_valence = None


def load_valence_tables() -> dict:
    """The converted amoebabio18.prm valence records (``amoeba_valence.npz``)."""
    global _raw_valence
    if _raw_valence is None:
        _raw_valence = dict(np.load(asset_path("amoeba_valence.npz")))
    return _raw_valence


@dataclasses.dataclass
class AmoebaValence:
    """Flat assigned term tables on the device and the scalar conventions
    (``amoeba_valence.py:73-101``)."""

    n_atoms: int
    bond_ij: torch.Tensor; bond_k: torch.Tensor; bond_r0: torch.Tensor
    ub_ik: torch.Tensor; ub_k: torch.Tensor; ub_r0: torch.Tensor
    ang_ijk: torch.Tensor; ang_k: torch.Tensor; ang_t0: torch.Tensor      # t0 in degrees
    angp_ijkd: torch.Tensor; angp_k: torch.Tensor; angp_t0: torch.Tensor  # i, j, k, 4th
    sb_ijk: torch.Tensor; sb_k1: torch.Tensor; sb_k2: torch.Tensor
    sb_r01: torch.Tensor; sb_r02: torch.Tensor; sb_t0: torch.Tensor
    opb_dbac: torch.Tensor; opb_k: torch.Tensor       # d out of plane, b trigonal centre
    tor_ijkl: torch.Tensor; tor_amp: torch.Tensor; tor_phase: torch.Tensor
    tor_n: torch.Tensor                               # [T,3] each
    pit_atoms: torch.Tensor; pit_k: torch.Tensor      # (b, c, a, d, e, f)
    st_ijkl: torch.Tensor; st_k: torch.Tensor; st_r0: torch.Tensor       # k [.,9], r0 [.,3]
    at_ijkl: torch.Tensor; at_k: torch.Tensor; at_t0: torch.Tensor       # k [.,6], t0 [.,2]
    tt_atoms: torch.Tensor; tt_type: torch.Tensor; tt_sign: torch.Tensor
    tt_coeffs: torch.Tensor                           # [G,R,R,4,4] eV
    tt_res: int
    scalars: dict

    @classmethod
    def build(cls, asg, par: AmoebaParams | None = None, device=None) -> "AmoebaValence":
        """Assign every term from classes and connectivity (``amoeba_valence.
        py:106-387``).  ``asg`` needs ``.atype``, ``.bonds`` and ``.n_atoms``
        (``physics.amoeba_protein.AmoebaAssignment``).  ``device`` None
        means the card (raises without one)."""
        device = resolve_device(device)
        par = par or AmoebaParams.load()
        val = load_valence_tables()
        raw = np.load(asset_path("amoeba_params.npz"))
        elem_of_type = {int(t): int(e) for t, e in zip(raw["atom_type"], raw["atom_elem"])}

        n = asg.n_atoms
        acls = np.array([par.type_to_class[int(t)] for t in asg.atype])
        elem = np.array([elem_of_type[int(t)] for t in asg.atype])
        adj: list[list[int]] = [[] for _ in range(n)]
        for i, j in asg.bonds:
            adj[int(i)].append(int(j))
            adj[int(j)].append(int(i))

        tabs = _lookup_tables(val)
        bond_tab, ang_tab, angp_tab, sb_tab, opb_tab, ub_tab = tabs[:6]
        tor_tab, pit_tab, st_tab, at_tab, tt_tab = tabs[6:]

        # bonds
        bond_ij, bond_k, bond_r0 = [], [], []
        bond_r0_of = {}
        for i, j in np.asarray(asg.bonds):
            i, j = int(i), int(j)
            key = tuple(sorted((acls[i], acls[j])))
            if key not in bond_tab:
                raise KeyError(f"no AMOEBA bond parameters for classes {key}")
            k, r0 = bond_tab[key]
            bond_ij.append((i, j)); bond_k.append(k); bond_r0.append(r0)
            bond_r0_of[(i, j)] = r0
            bond_r0_of[(j, i)] = r0

        # angles, in-plane angles, stretch-bends, Urey-Bradley
        ang_ijk, ang_k, ang_t0 = [], [], []
        angp_ijkd, angp_k, angp_t0 = [], [], []
        sb_ijk, sb_k1, sb_k2, sb_r01, sb_r02, sb_t0 = [], [], [], [], [], []
        ub_ik, ub_k, ub_r0 = [], [], []
        t0_of = {}
        for j in range(n):
            nbrs = sorted(adj[j])
            for a in range(len(nbrs)):
                for b in range(a + 1, len(nbrs)):
                    i, k = nbrs[a], nbrs[b]
                    ckey = (int(acls[i]), int(acls[j]), int(acls[k]))
                    if len(nbrs) == 3 and ckey in angp_tab:
                        inplane = True
                        kf, t0s = angp_tab[ckey]
                    elif ckey in ang_tab:
                        inplane = False
                        kf, t0s = ang_tab[ckey]
                    elif ckey in angp_tab:
                        # an anglep record at a non-trigonal centre: a regular
                        # angle (no projection plane exists)
                        inplane = False
                        kf, t0s = angp_tab[ckey]
                    else:
                        raise KeyError(f"no AMOEBA angle parameters for classes {ckey}")
                    # theta0 variant by the number of extra hydrogens on the centre
                    nh = sum(1 for m in nbrs if m not in (i, k) and elem[m] == 1)
                    t0 = t0s[nh] if nh <= 2 and t0s[min(nh, 2)] != 0.0 else t0s[0]
                    if inplane:
                        d = [m for m in nbrs if m not in (i, k)][0]
                        angp_ijkd.append((i, j, k, d)); angp_k.append(kf); angp_t0.append(t0)
                    else:
                        ang_ijk.append((i, j, k)); ang_k.append(kf); ang_t0.append(t0)
                    t0_of[(i, j, k)] = t0
                    t0_of[(k, j, i)] = t0
                    if ckey in sb_tab:
                        k1, k2 = sb_tab[ckey]
                        sb_ijk.append((i, j, k)); sb_k1.append(k1); sb_k2.append(k2)
                        sb_r01.append(bond_r0_of[(i, j)]); sb_r02.append(bond_r0_of[(k, j)])
                        sb_t0.append(t0)
                    if ckey in ub_tab:
                        ku, ru = ub_tab[ckey]
                        ub_ik.append((i, k)); ub_k.append(ku); ub_r0.append(ru)

        # out-of-plane bends at trigonal centres
        opb_dbac, opb_k = [], []
        for bcen in range(n):
            nbrs = sorted(adj[bcen])
            if len(nbrs) != 3:
                continue
            for d in nbrs:
                key = (acls[d], acls[bcen])
                if key in opb_tab:
                    a, c = [m for m in nbrs if m != d]
                    opb_dbac.append((d, bcen, a, c))
                    opb_k.append(opb_tab[key])

        # torsions and the terms coupled to them
        tor_ijkl, tor_amp, tor_phase, tor_n = [], [], [], []
        st_ijkl, st_k, st_r0 = [], [], []
        at_ijkl, at_k, at_t0 = [], [], []
        for j, k in np.asarray(asg.bonds):
            j, k = int(j), int(k)
            for i in adj[j]:
                if i == k:
                    continue
                for l in adj[k]:
                    if l == j or l == i:
                        continue
                    ckey = (acls[i], acls[j], acls[k], acls[l])
                    if ckey not in tor_tab:
                        raise KeyError(f"no AMOEBA torsion parameters for classes {ckey}")
                    amp, phase, per = tor_tab[ckey]
                    tor_ijkl.append((i, j, k, l))
                    tor_amp.append(amp)
                    tor_phase.append(np.asarray(phase) * math.pi / 180.0)
                    tor_n.append(per)
                    if ckey in st_tab:
                        st_ijkl.append((i, j, k, l))
                        st_k.append(st_tab[ckey])
                        st_r0.append((bond_r0_of[(i, j)], bond_r0_of[(j, k)],
                                      bond_r0_of[(k, l)]))
                    if ckey in at_tab:
                        at_ijkl.append((i, j, k, l))
                        at_k.append(at_tab[ckey])
                        at_t0.append((t0_of[(i, j, k)], t0_of[(j, k, l)]))

        # pi-orbital torsions across bonds of two trigonal atoms
        pit_atoms, pit_k = [], []
        for bb, cc in np.asarray(asg.bonds):
            bb, cc = int(bb), int(cc)
            if len(adj[bb]) != 3 or len(adj[cc]) != 3:
                continue
            key = tuple(sorted((acls[bb], acls[cc])))
            if key not in pit_tab:
                continue
            a, d = [m for m in adj[bb] if m != cc]
            e, f = [m for m in adj[cc] if m != bb]
            pit_atoms.append((bb, cc, a, d, e, f))
            pit_k.append(pit_tab[key])

        # torsion-torsions: 5-chains enumerated from the central atom, each
        # once (j < l); the chirality sign defaults to +1 (the L convention)
        # until resolve_chirality_signs sets it from a geometry
        tt_atoms, tt_type, tt_sign = [], [], []
        for k in range(n):
            for j in adj[k]:
                for l in adj[k]:
                    if l <= j:
                        continue
                    for i in adj[j]:
                        if i == k or i == l:
                            continue
                        for m in adj[l]:
                            if m in (k, j, i):
                                continue
                            ckey = (int(acls[i]), int(acls[j]), int(acls[k]), int(acls[l]),
                                    int(acls[m]))
                            if ckey not in tt_tab:
                                continue
                            g, rev = tt_tab[ckey]
                            tt_atoms.append((m, l, k, j, i) if rev else (i, j, k, l, m))
                            tt_type.append(g)
                            tt_sign.append(1.0)

        # the 25 x 25 grids repeat +180 as their last row and column; the
        # periodic spline drops it (R = 24, as the ff19SB CMAP)
        grids = val["tortors_grid"][:, :-1, :-1]
        tt_coeffs = cmap_bicubic_coeffs(grids) * units.kcal_per_mol
        scalars = {k: float(val[k]) for k in (
            "bond_cubic", "bond_quartic", "angle_cubic", "angle_quartic", "angle_pentic",
            "angle_sextic", "opbend_cubic", "opbend_quartic", "opbend_pentic", "opbend_sextic",
            "torsionunit")}

        f = lambda x, shape: torch.as_tensor(np.asarray(x, np.float64).reshape(shape),
                                             dtype=torch.float32, device=device)
        i = lambda x, shape: torch.as_tensor(np.asarray(x, np.int64).reshape(shape),
                                             device=device)
        return cls(
            n_atoms=n,
            bond_ij=i(bond_ij, (-1, 2)), bond_k=f(bond_k, (-1,)), bond_r0=f(bond_r0, (-1,)),
            ub_ik=i(ub_ik, (-1, 2)), ub_k=f(ub_k, (-1,)), ub_r0=f(ub_r0, (-1,)),
            ang_ijk=i(ang_ijk, (-1, 3)), ang_k=f(ang_k, (-1,)), ang_t0=f(ang_t0, (-1,)),
            angp_ijkd=i(angp_ijkd, (-1, 4)), angp_k=f(angp_k, (-1,)),
            angp_t0=f(angp_t0, (-1,)),
            sb_ijk=i(sb_ijk, (-1, 3)), sb_k1=f(sb_k1, (-1,)), sb_k2=f(sb_k2, (-1,)),
            sb_r01=f(sb_r01, (-1,)), sb_r02=f(sb_r02, (-1,)), sb_t0=f(sb_t0, (-1,)),
            opb_dbac=i(opb_dbac, (-1, 4)), opb_k=f(opb_k, (-1,)),
            tor_ijkl=i(tor_ijkl, (-1, 4)), tor_amp=f(tor_amp, (-1, 3)),
            tor_phase=f(tor_phase, (-1, 3)), tor_n=f(tor_n, (-1, 3)),
            pit_atoms=i(pit_atoms, (-1, 6)), pit_k=f(pit_k, (-1,)),
            st_ijkl=i(st_ijkl, (-1, 4)), st_k=f(st_k, (-1, 9)), st_r0=f(st_r0, (-1, 3)),
            at_ijkl=i(at_ijkl, (-1, 4)), at_k=f(at_k, (-1, 6)), at_t0=f(at_t0, (-1, 2)),
            tt_atoms=i(tt_atoms, (-1, 5)), tt_type=i(tt_type, (-1,)),
            tt_sign=f(tt_sign, (-1,)), tt_coeffs=f(tt_coeffs, tt_coeffs.shape),
            tt_res=int(grids.shape[1]) if grids.size else 24,
            scalars=scalars,
        )

    # ------------------------------------------------------------------
    def term_energies(self, P: torch.Tensor, cell=None) -> dict:
        """Each term's energy in eV, keyed by the table prefix (``bond``,
        ``ub``, ``ang``, ``angp``, ``sb``, ``opb``, ``tor``, ``pit``, ``st``,
        ``at``, ``tt``); a term with no entries is absent.  The sum is
        ``energy`` (``amoeba_valence.py:394-584``)."""
        s = self.scalars
        kcal = units.kcal_per_mol
        out = {}

        def diff(a, b):
            return _pbc_diff(P[a] - P[b], cell)

        def sextic(k, dt_deg, pre="angle"):
            d2 = dt_deg * dt_deg
            return ANGLE_UNIT * k * d2 * (
                1.0 + s[f"{pre}_cubic"] * dt_deg + s[f"{pre}_quartic"] * d2
                + s[f"{pre}_pentic"] * d2 * dt_deg + s[f"{pre}_sextic"] * d2 * d2)

        def angle_deg(v0, v1):
            y = _safe_norm(torch.linalg.cross(v0, v1, dim=-1))
            x = (v0 * v1).sum(-1)
            ok = (x * x + y * y) > 1e-12
            return torch.atan2(torch.where(ok, y, torch.zeros_like(y)),
                               torch.where(ok, x, torch.ones_like(x))) * DEG

        def plain_angle(ijk):
            return angle_deg(diff(ijk[:, 0], ijk[:, 1]), diff(ijk[:, 2], ijk[:, 1]))

        def dihedral(ijkl):
            return _dihedral_angle(P[ijkl[:, 0]], P[ijkl[:, 1]], P[ijkl[:, 2]], P[ijkl[:, 3]],
                                   cell)

        if self.bond_ij.shape[0]:
            dt = _safe_norm(diff(self.bond_ij[:, 0], self.bond_ij[:, 1])) - self.bond_r0
            out["bond"] = (self.bond_k * dt * dt * (
                1.0 + s["bond_cubic"] * dt + s["bond_quartic"] * dt * dt)).sum()
        if self.ub_ik.shape[0]:
            du = _safe_norm(diff(self.ub_ik[:, 0], self.ub_ik[:, 1])) - self.ub_r0
            out["ub"] = (self.ub_k * du * du).sum()
        if self.ang_ijk.shape[0]:
            out["ang"] = sextic(self.ang_k, plain_angle(self.ang_ijk) - self.ang_t0).sum()
        if self.angp_ijkd.shape[0]:
            # the centre projected onto the plane of its three attachments
            # (Tinker eangle's in-plane branch), then the angle i-proj-k
            pi_, pb, pk, pd = (P[self.angp_ijkd[:, c]] for c in range(4))
            ad, cd = _pbc_diff(pi_ - pd, cell), _pbc_diff(pk - pd, cell)
            bd = _pbc_diff(pb - pd, cell)
            t = torch.linalg.cross(ad, cd, dim=-1)
            rt2 = torch.clamp((t * t).sum(-1), min=1e-12)
            pip = pb + t * (-(t * bd).sum(-1) / rt2)[:, None]
            th = angle_deg(_pbc_diff(pi_ - pip, cell), _pbc_diff(pk - pip, cell))
            out["angp"] = sextic(self.angp_k, th - self.angp_t0).sum()
        if self.sb_ijk.shape[0]:
            th = plain_angle(self.sb_ijk)
            dr1 = _safe_norm(diff(self.sb_ijk[:, 0], self.sb_ijk[:, 1])) - self.sb_r01
            dr2 = _safe_norm(diff(self.sb_ijk[:, 2], self.sb_ijk[:, 1])) - self.sb_r02
            out["sb"] = STRBND_UNIT * ((self.sb_k1 * dr1 + self.sb_k2 * dr2)
                                       * (th - self.sb_t0)).sum()
        if self.opb_dbac.shape[0]:
            # Allinger chi: the angle between the bond b->d and the a-c-d plane
            pd, pb, pa, pc = (P[self.opb_dbac[:, c]] for c in range(4))
            ab, cb = _pbc_diff(pa - pb, cell), _pbc_diff(pc - pb, cell)
            db = _pbc_diff(pd - pb, cell)
            ad, cd = _pbc_diff(pa - pd, cell), _pbc_diff(pc - pd, cell)
            dot = (ad * cd).sum(-1)
            cc = torch.clamp((ad * ad).sum(-1) * (cd * cd).sum(-1) - dot * dot, min=1e-12)
            ee = (db * torch.linalg.cross(ab, cb, dim=-1)).sum(-1)
            rdb2 = torch.clamp((db * db).sum(-1), min=1e-12)
            # JAX clips sin^2 chi to [0, 1]; the open interval keeps sqrt and
            # arcsin differentiable at a planar or a perpendicular centre
            eps = torch.finfo(P.dtype).eps
            sin2 = torch.clamp(ee * ee / (cc * rdb2), min=torch.finfo(P.dtype).tiny, max=1.0 - eps)
            chi = torch.asin(torch.sqrt(sin2)) * DEG
            out["opb"] = sextic(self.opb_k, chi, "opbend").sum()
        if self.tor_ijkl.shape[0]:
            phi = dihedral(self.tor_ijkl)[:, None]
            out["tor"] = s["torsionunit"] * (
                self.tor_amp * (1.0 + torch.cos(self.tor_n * phi - self.tor_phase))).sum()
        if self.pit_atoms.shape[0]:
            # dummy points pb + the normal of (a - c, d - c) and pc + the
            # normal of (e - b, f - b), then the 2-fold torsion ip-b-c-iq
            # (Tinker epitors)
            pb, pc, pa, pd, pe, pf = (P[self.pit_atoms[:, c]] for c in range(6))
            ip = torch.linalg.cross(_pbc_diff(pa - pc, cell), _pbc_diff(pd - pc, cell), dim=-1) + pb
            iq = torch.linalg.cross(_pbc_diff(pe - pb, cell), _pbc_diff(pf - pb, cell), dim=-1) + pc
            phi = _dihedral_angle(ip, pb, pc, iq, None)
            out["pit"] = (self.pit_k * (1.0 - torch.cos(2.0 * phi))).sum()
        if self.st_ijkl.shape[0] or self.at_ijkl.shape[0]:
            # folds 1, 2, 3 with phases 0, pi, 0, made on the device (no host
            # copy, so the term runs inside a captured step)
            m = torch.arange(1, 4, dtype=P.dtype, device=P.device)
            ph = (m == 2.0).to(P.dtype) * math.pi
            fold = lambda ijkl: 1.0 + torch.cos(m * dihedral(ijkl)[:, None] - ph)      # [M,3]
        if self.st_ijkl.shape[0]:
            a = self.st_ijkl
            dr = torch.stack([_safe_norm(diff(a[:, c], a[:, c + 1])) for c in range(3)],
                             dim=-1) - self.st_r0                                       # [M,3]
            out["st"] = (dr * (self.st_k.reshape(-1, 3, 3) * fold(a)[:, None, :]).sum(-1)).sum()
        if self.at_ijkl.shape[0]:
            a = self.at_ijkl
            dth = torch.stack([plain_angle(a[:, 0:3]) - self.at_t0[:, 0],
                               plain_angle(a[:, 1:4]) - self.at_t0[:, 1]], dim=-1)    # [M,2]
            out["at"] = ANGTOR_UNIT * (
                dth * (self.at_k.reshape(-1, 2, 3) * fold(a)[:, None, :]).sum(-1)).sum()
        out = {k: v * kcal for k, v in out.items()}
        if self.tt_atoms.shape[0]:
            a = self.tt_atoms
            phi1 = dihedral(a[:, 0:4]) * self.tt_sign
            phi2 = dihedral(a[:, 1:5]) * self.tt_sign
            gi, t = _spline_cell(phi1, self.tt_res)
            gj, u = _spline_cell(phi2, self.tt_res)
            C = self.tt_coeffs[self.tt_type, gi, gj].to(P.dtype)                       # [M,4,4]
            tp = torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1)
            up = torch.stack([torch.ones_like(u), u, u * u, u * u * u], dim=-1)
            out["tt"] = torch.einsum("mij,mi,mj->", C, tp, up)           # coefficients in eV
        return out

    def energy(self, P: torch.Tensor, cell=None) -> torch.Tensor:
        """The total valence energy in eV; autograd gives the forces."""
        terms = self.term_energies(P, cell)
        return sum(terms.values(), P.new_zeros(()))

    def energy_forces(self, P: torch.Tensor, cell=None):
        """(E, F) by autograd."""
        with torch.enable_grad():
            p = P.detach().requires_grad_(True)
            e = self.energy(p, cell)
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g


def _spline_cell(angle: torch.Tensor, R: int):
    """(cell index, offset in [0, 1)) of an angle in (-pi, pi] on the R-cell
    periodic grid that starts at -180 degrees."""
    x = (angle + math.pi) * (R / (2.0 * math.pi))
    xi = torch.floor(x)
    return torch.remainder(xi.long(), R), x - xi


def _lookup_tables(val: dict):
    """The prm records as dicts keyed by class tuples, each in both chain
    directions where Tinker matches both (``amoeba_valence.py:126-184``)."""
    bond_tab = {tuple(sorted((int(a), int(b)))): (k, r0) for a, b, k, r0 in val["bond"]}
    ang_tab, angp_tab, ub_tab, sb_tab = {}, {}, {}, {}
    for tab, rows in ((ang_tab, val["angle"]), (angp_tab, val["anglep"])):
        for a, b, c, k, t0, t1, t2 in rows:
            tab[(int(a), int(b), int(c))] = (k, (t0, t1, t2))
            tab[(int(c), int(b), int(a))] = (k, (t0, t1, t2))
    for a, b, c, k1, k2 in val["strbnd"]:
        sb_tab[(int(a), int(b), int(c))] = (k1, k2)
        sb_tab.setdefault((int(c), int(b), int(a)), (k2, k1))
    opb_tab = {(int(d), int(b)): k for d, b, _, _, k in val["opbend"]}
    for a, b, c, k, r0 in val["ureybrad"]:
        ub_tab[(int(a), int(b), int(c))] = (k, r0)
        ub_tab[(int(c), int(b), int(a))] = (k, r0)
    tor_tab, st_tab, at_tab = {}, {}, {}
    for row in val["torsion"]:
        a, b, c, d = (int(v) for v in row[:4])
        rec = (row[4:7], row[7:10], row[10:13])          # amplitudes, phases, periods
        tor_tab[(a, b, c, d)] = rec
        tor_tab.setdefault((d, c, b, a), rec)
    pit_tab = {tuple(sorted((int(a), int(b)))): k for a, b, k in val["pitors"]}
    for row in val["strtors"]:
        a, b, c, d = (int(v) for v in row[:4])
        k9 = np.asarray(row[4:13])
        st_tab[(a, b, c, d)] = k9
        # the reversed chain swaps bond 1 and bond 3
        st_tab.setdefault((d, c, b, a), np.concatenate([k9[6:9], k9[3:6], k9[0:3]]))
    for row in val["angtors"]:
        a, b, c, d = (int(v) for v in row[:4])
        k6 = np.asarray(row[4:10])
        at_tab[(a, b, c, d)] = k6
        at_tab.setdefault((d, c, b, a), np.concatenate([k6[3:6], k6[0:3]]))
    tt_tab = {}
    for g, cls5 in enumerate(val["tortors_cls"]):
        cls5 = tuple(int(v) for v in cls5)
        tt_tab[cls5] = (g, False)
        tt_tab.setdefault(cls5[::-1], (g, True))
    return (bond_tab, ang_tab, angp_tab, sb_tab, opb_tab, ub_tab, tor_tab, pit_tab, st_tab,
            at_tab, tt_tab)


def resolve_chirality_signs(av: AmoebaValence, positions: np.ndarray, bonds: np.ndarray,
                            elem: np.ndarray | None = None) -> AmoebaValence:
    """``av`` with ``tt_sign`` set from a build geometry (Tinker chkttor,
    ``amoeba_valence.py:595-632``): for a chain i-j-k-l-m whose k has four
    attachments, the heavier of k's two off-chain attachments x (by atomic
    number, else the larger index) gives the signed volume (r_j - r_k) .
    [(r_l - r_k) x (r_x - r_k)]; a negative volume negates both spline
    angles.  L-amino-acid backbones give +1."""
    if av.tt_atoms.shape[0] == 0:
        return av
    n = int(np.max(bonds)) + 1 if len(bonds) else 0
    adj: list[list[int]] = [[] for _ in range(max(n, av.n_atoms))]
    for i, j in np.asarray(bonds):
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    signs = []
    P = np.asarray(positions)
    for chain in av.tt_atoms.cpu().numpy():
        i, j, k, l, m = (int(v) for v in chain)
        nbrs = [x for x in adj[k] if x not in (j, l)]
        if len(adj[k]) != 4 or len(nbrs) != 2:
            signs.append(1.0)
            continue
        if elem is not None:
            x = nbrs[0] if elem[nbrs[0]] >= elem[nbrs[1]] else nbrs[1]
        else:
            x = max(nbrs)
        vol = np.dot(P[j] - P[k], np.cross(P[l] - P[k], P[x] - P[k]))
        signs.append(1.0 if vol >= 0.0 else -1.0)
    return dataclasses.replace(av, tt_sign=torch.as_tensor(
        signs, dtype=av.tt_sign.dtype, device=av.tt_sign.device))
