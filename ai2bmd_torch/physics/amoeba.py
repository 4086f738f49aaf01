"""AMOEBA parameters, local multipole frames and Thole-damped fields.

Port of the parts of ``ai2bmd_tpu/physics/amoeba.py`` that the periodic
AMOEBA system (``physics/amoeba_system.py``) and the QM/MM backend use: the
converted AMOEBA-BIO-2018 asset (``amoeba_params.npz``; reference:
src/utils/amoebabio18.prm, passed to Tinker at
src/Calculators/tinker_async.py:130), the rotation of local-frame
multipoles to the lab frame, the point-multipole pair energy, the Thole
damping factors and the damped fields, the AMOEBA water geometry.

Units: positions A, energies eV (parameters converted from kcal/mol); prm
dipoles are e*bohr and quadrupoles e*bohr^2 (Tinker's convention), converted
here.  The quadrupole is the traceless Cartesian moment Theta_ab = sum_k q_k
(3 x_a x_b - r^2 delta_ab) / 2.

The test-scale engines (``amoeba.py:209-607``), dense [N, N] and sized for
validation: ``AmoebaWaterSystem`` (W waters in vacuum: intermolecular
multipole pairs by ``torch.func``, Thole-damped SOR induction, buffered 14-7
with the hydrogens' reduction sites, the water bond and angle),
``AmoebaWaterBox`` (the same under periodic boundaries: the multipole SPME
of ``amoeba_pme.py`` with the intramolecular erf adjustment, real-space
Thole induction and vdW within cutoffs, minimum image) and
``molecular_dipole_debye``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.data import asset_path
from ai2bmd_torch.physics import amoeba_pme as MP
from ai2bmd_torch.utils.device import resolve_device

BOHR = 0.52917720859
KCAL = units.kcal_per_mol
# AMOEBA water internal geometry (amoebabio18.prm: bond 90-91, angle 91-90-91)
WATER_R_OH = 0.9572
WATER_THETA_DEG = 108.50
WATER_O_TYPE = 349
WATER_H_TYPE = 350


class AmoebaParams:
    """Host-side lookup tables from the converted amoebabio18.prm
    (``amoeba.py:57-101``)."""

    _cached = None

    def __init__(self, raw):
        self.type_to_class = {int(t): int(c) for t, c in zip(raw["atom_type"], raw["atom_class"])}
        self.vdw = {
            int(c): (float(r), float(e), float(red))
            for c, r, e, red in zip(raw["vdw_class"], raw["vdw_rmin"], raw["vdw_eps"],
                                    raw["vdw_red"])
        }
        # multipole records keyed by type, each (frame tuple, q, dipole, quadrupole)
        self.multipole: dict[int, list] = {}
        for t, fr, q, d, Q in zip(raw["mp_type"], raw["mp_frame"], raw["mp_q"], raw["mp_dip"],
                                  raw["mp_quad"]):
            self.multipole.setdefault(int(t), []).append(
                (tuple(int(v) for v in fr), float(q), np.array(d), np.array(Q)))
        self.polarize = {
            int(t): (float(a), float(th), tuple(int(g) for g in grp if g))
            for t, a, th, grp in zip(raw["pol_type"], raw["pol_alpha"], raw["pol_thole"],
                                     raw["pol_group"])
        }
        self.biotype = {(str(n), str(r)): int(t)
                        for n, r, t in zip(raw["bio_name"], raw["bio_res"], raw["bio_type"])}

    @classmethod
    def load(cls) -> "AmoebaParams":
        if cls._cached is None:
            cls._cached = cls(np.load(asset_path("amoeba_params.npz")))
        return cls._cached


def _unit(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def rotate_multipoles(P, frame_z, frame_x, frame_kind, dip_loc, quad_loc):
    """Local-frame multipoles to the lab frame at positions P
    (``amoeba.py:111-135``).  frame_z / frame_x [N]: the frame-defining
    sites; frame_kind [N]: 0 Z-then-X, 1 bisector (z along the bisector of
    the z and x neighbours).  dip_loc [N,3] e*A, quad_loc [N,3,3] e*A^2.
    Returns (mu [N,3], theta [N,3,3]); a monatomic site (frame_z == itself)
    rotates to zero."""
    u_z = _unit(P[frame_z] - P)
    u_x = _unit(P[frame_x] - P)
    z_dir = torch.where((frame_kind == 1)[:, None], _unit(u_z + u_x), u_z)
    x_dir = _unit(u_x - (u_x * z_dir).sum(-1, keepdim=True) * z_dir)
    y_dir = torch.linalg.cross(z_dir, x_dir, dim=-1)
    R = torch.stack([x_dir, y_dir, z_dir], dim=-1)           # columns = axes
    mu = torch.einsum("nab,nb->na", R, dip_loc)
    theta = torch.einsum("nab,nbc,ndc->nad", R, quad_loc, R)
    return mu, theta


def _phi(x, q, mu, theta):
    """Potential at displacement x [3] from a point multipole: q/r +
    mu.x/r^3 + x.Theta.x/r^5 (``amoeba.py:143-154``)."""
    r2 = (x * x).sum()
    r = torch.sqrt(r2)
    return q / r + (mu @ x) / (r2 * r) + (x @ theta @ x) / (r2 * r2 * r)


def pair_permanent_energy(x, qi, mui, ti, qj, muj, tj):
    """Interaction of two multipole sites at x = r_j - r_i, in e^2/A
    (``amoeba.py:157-164``): qj phi + muj.grad phi + Theta_j : hess phi / 3,
    by ``torch.func`` (JAX takes ``grad`` and ``hessian``)."""
    phi = lambda y: _phi(y, qi, mui, ti)
    return (qj * phi(x) + muj @ torch.func.grad(phi)(x)
            + torch.trace(tj @ torch.func.hessian(phi)(x)) / 3.0)


def _thole_lambdas(r, pdamp_ij, gamma_ij):
    """(lambda3, lambda5, lambda7) Thole damping factors (``amoeba.py:
    172-181``)."""
    u = r / torch.clamp(pdamp_ij, min=1e-6)
    au3 = gamma_ij * u ** 3
    ex = torch.exp(-torch.clamp(au3, max=50.0))
    return 1.0 - ex, 1.0 - (1.0 + au3) * ex, 1.0 - (1.0 + au3 + 0.6 * au3 * au3) * ex


def field_from_permanent(x, q, mu, theta, l3, l5, l7):
    """Damped field at displacement x from a permanent multipole
    (``amoeba.py:184-199``); the damping factors carry a trailing axis of 1."""
    r2 = (x * x).sum(-1, keepdim=True)
    r = torch.sqrt(r2)
    r3, r5, r7 = r2 * r, r2 * r2 * r, r2 * r2 * r2 * r
    tx = torch.einsum("...ab,...b->...a", theta, x)
    xtx = (x * tx).sum(-1, keepdim=True)
    mux = (mu * x).sum(-1, keepdim=True)
    term3 = q[..., None] * x / r3 - mu / r3
    term5 = 3.0 * mux * x / r5 - 2.0 * tx / r5
    term7 = 5.0 * xtx * x / r7
    return l3 * term3 + l5 * term5 + l7 * term7


def field_from_dipole(x, p, l3, l5):
    """Damped field at displacement x from a point dipole p
    (``amoeba.py:202-208``)."""
    r2 = (x * x).sum(-1, keepdim=True)
    r = torch.sqrt(r2)
    px = (p * x).sum(-1, keepdim=True)
    return l5 * 3.0 * px * x / (r2 * r2 * r) - l3 * p / (r2 * r)


def _parked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [..., 3] with the masked-out rows at (10, 0, 0), a finite distance."""
    far = torch.tensor([10.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
    return torch.where(mask[..., None], x, far)


def _damping(pdamp, thole, r):
    """Thole lambdas [N,N] of every site pair at distances r."""
    return _thole_lambdas(r, pdamp[:, None] * pdamp[None, :],
                          torch.minimum(thole[:, None], thole[None, :]))


def _field_sum(x, q, mu, theta, lam, live, weight=None):
    """sum_j of the damped fields of the sites' permanents at x [N,N,3] =
    r_i - r_j, over the live pairs, each times weight [N,N] when given."""
    n = x.shape[0]
    E = field_from_permanent(x, q[None, :].expand(n, n), mu[None].expand(n, n, 3),
                             theta[None].expand(n, n, 3, 3), *(v[..., None] for v in lam))
    E = torch.where(live[..., None], E, torch.zeros_like(E))
    return (E if weight is None else E * weight[..., None]).sum(1)


def _sor(E_d, x, lam, live, alpha, iters: int, omega: float):
    """Mutual induction by ``iters`` SOR sweeps from alpha E_d over the live
    pairs (``amoeba.py:352-377``)."""
    al = alpha[:, None]
    l3, l5 = lam[0][..., None], lam[1][..., None]
    mu_ind = al * E_d
    for _ in range(iters):
        Em = field_from_dipole(x, mu_ind[None, :, :], l3, l5)
        Em = torch.where(live[..., None], Em, torch.zeros_like(Em)).sum(1)
        mu_ind = mu_ind + omega * (al * (E_d + Em) - mu_ind)
    return mu_ind


def _halgren(r, rmin, eps):
    """Buffered 14-7 energies [N,N] at distances r: cubic-mean R-min and HHG
    epsilon combining (``amoeba.py:383-402``)."""
    ri, rj = rmin[:, None], rmin[None, :]
    r0 = (ri ** 3 + rj ** 3) / (ri ** 2 + rj ** 2)
    ei, ej = eps[:, None], eps[None, :]
    se = torch.sqrt(ei) + torch.sqrt(ej)
    e = 4.0 * ei * ej / torch.clamp(se * se, min=1e-12)
    rho = r / r0
    return e * (1.07 / (rho + 0.07)) ** 7 * (1.12 / (rho ** 7 + 0.12) - 2.0), r0, e


def _value_and_forces(fn, P):
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = fn(p)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


@dataclasses.dataclass
class AmoebaWaterSystem:
    """W AMOEBA waters as one differentiable potential in vacuum, sites
    ordered [O, H, H] x W (``amoeba.py:209-435``)."""

    n_sites: int
    mol_id: torch.Tensor      # [N]
    frame_z: torch.Tensor
    frame_x: torch.Tensor
    frame_kind: torch.Tensor  # 0 z-then-x, 1 bisector
    q: torch.Tensor           # e
    dip_loc: torch.Tensor     # e A
    quad_loc: torch.Tensor    # e A^2
    alpha: torch.Tensor       # A^3
    pdamp: torch.Tensor
    thole: torch.Tensor
    vdw_rmin: torch.Tensor    # A
    vdw_eps: torch.Tensor     # eV
    vdw_red: torch.Tensor     # reduction toward the heavy site
    heavy_of: torch.Tensor    # heavy site of each H (itself otherwise)
    bond_k: float             # eV/A^2
    bond_r0: float
    angle_k: float            # eV/rad^2
    angle_t0: float
    sor_iters: int = 40
    sor_omega: float = 0.7

    @classmethod
    def build(cls, n_waters: int, sor_iters: int = 40, device=None,
              dtype=torch.float32) -> "AmoebaWaterSystem":
        """The amoebabio18 water tables (``amoeba.py:237-299``); ``device``
        None means the card (raises without one)."""
        device = resolve_device(device)
        par = AmoebaParams.load()
        N = 3 * n_waters
        o = np.arange(n_waters) * 3
        h1, h2 = o + 1, o + 2
        frame_z, frame_x, kind = np.zeros(N, np.int64), np.zeros(N, np.int64), np.zeros(N, np.int64)
        # O: the bisector of its two H; H: z toward O, x toward the other H
        frame_z[o], frame_x[o], kind[o] = h1, h2, 1
        frame_z[h1], frame_x[h1] = o, h2
        frame_z[h2], frame_x[h2] = o, h1

        def mp(t):
            (_, q, d, Q), = par.multipole[t]
            return q, d * BOHR, Q * BOHR * BOHR

        q, dip, quad = np.zeros(N), np.zeros((N, 3)), np.zeros((N, 3, 3))
        alpha, thole = np.zeros(N), np.zeros(N)
        rmin, eps, red, heavy = np.zeros(N), np.zeros(N), np.ones(N), np.arange(N)
        for t, sites in ((WATER_O_TYPE, [o]), (WATER_H_TYPE, [h1, h2])):
            qt, dt, Qt = mp(t)
            at, tht, _ = par.polarize[t]
            rt, et, redt = par.vdw[par.type_to_class[t]]
            for s in sites:
                q[s], dip[s], quad[s], alpha[s], thole[s] = qt, dt, Qt, at, tht
                rmin[s], eps[s] = rt, et * KCAL
                if t == WATER_H_TYPE:
                    red[s], heavy[s] = redt, o
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        return cls(
            n_sites=N, mol_id=i(np.repeat(np.arange(n_waters), 3)), frame_z=i(frame_z),
            frame_x=i(frame_x), frame_kind=i(kind), q=f(q), dip_loc=f(dip), quad_loc=f(quad),
            alpha=f(alpha), pdamp=f(alpha ** (1.0 / 6.0)), thole=f(thole), vdw_rmin=f(rmin),
            vdw_eps=f(eps), vdw_red=f(red), heavy_of=i(heavy),
            bond_k=556.85 * KCAL, bond_r0=WATER_R_OH, angle_k=48.70 * KCAL,
            angle_t0=float(np.deg2rad(WATER_THETA_DEG)), sor_iters=sor_iters)

    def lab_multipoles(self, P):
        mu, theta = rotate_multipoles(P, self.frame_z, self.frame_x, self.frame_kind,
                                      self.dip_loc, self.quad_loc)
        return self.q, mu, theta

    def _pair_masks(self):
        """(different molecules [N,N], strict upper triangle [N,N])."""
        n = self.n_sites
        iu = torch.ones((n, n), dtype=torch.bool, device=self.q.device).triu(1)
        return self.mol_id[:, None] != self.mol_id[None, :], iu

    def permanent_energy(self, P):
        """Intermolecular permanent multipole electrostatics, eV."""
        q, mu, theta = self.lab_multipoles(P)
        diff_mol, iu = self._pair_masks()
        ii, jj = torch.nonzero(diff_mol & iu, as_tuple=True)
        e = torch.func.vmap(pair_permanent_energy)(P[jj] - P[ii], q[ii], mu[ii], theta[ii],
                                                   q[jj], mu[jj], theta[jj])
        return units.COULOMB * e.sum()

    def _permanent_field(self, P):
        """The damped field of the other molecules' permanents at every site
        [N,3] (a molecule's own permanents do not polarize it)."""
        q, mu, theta = self.lab_multipoles(P)
        diff_mol, _ = self._pair_masks()
        x = _parked(P[:, None, :] - P[None, :, :], diff_mol)       # r_i - r_j
        lam = _damping(self.pdamp, self.thole, torch.sqrt((x * x).sum(-1)))
        return _field_sum(x, q, mu, theta, lam, diff_mol)

    def induced_dipoles(self, P):
        """Mutual induction by ``sor_iters`` SOR sweeps over every other
        site; (mu_ind, E0)."""
        E0 = self._permanent_field(P)
        not_self = ~torch.eye(self.n_sites, dtype=torch.bool, device=P.device)
        x = _parked(P[:, None, :] - P[None, :, :], not_self)
        lam = _damping(self.pdamp, self.thole, torch.sqrt((x * x).sum(-1)))
        return _sor(E0, x, lam, not_self, self.alpha, self.sor_iters, self.sor_omega), E0

    def polarization_energy(self, P):
        mu_ind, E0 = self.induced_dipoles(P)
        return -0.5 * units.COULOMB * (mu_ind * E0).sum()

    def _sites(self, P):
        """The vdW sites: each H moved toward its heavy atom by its reduction."""
        red = self.vdw_red[:, None]
        return P[self.heavy_of] + red * (P - P[self.heavy_of])

    def vdw_energy(self, P):
        """Buffered 14-7 between molecules, eV."""
        sites = self._sites(P)
        diff_mol, iu = self._pair_masks()
        mask = diff_mol & iu
        d = _parked(sites[:, None, :] - sites[None, :, :], mask)
        e, _, _ = _halgren(torch.sqrt((d * d).sum(-1)), self.vdw_rmin, self.vdw_eps)
        return torch.where(mask, e, torch.zeros_like(e)).sum()

    def bonded_energy(self, P):
        """The water bond and angle, harmonic part (the cubic and quartic
        corrections are under 1% at thermal amplitudes)."""
        o = torch.arange(0, self.n_sites, 3, device=P.device)
        e = P.new_zeros(())
        for h in (o + 1, o + 2):
            d = torch.sqrt(((P[h] - P[o]) ** 2).sum(-1))
            e = e + (self.bond_k * (d - self.bond_r0) ** 2).sum()
        v1, v2 = P[o + 1] - P[o], P[o + 2] - P[o]
        th = torch.atan2(torch.sqrt((torch.linalg.cross(v1, v2, dim=-1) ** 2).sum(-1)),
                         (v1 * v2).sum(-1))
        return e + (self.angle_k * (th - self.angle_t0) ** 2).sum()

    def energy(self, P, include_bonded: bool = True):
        e = self.permanent_energy(P) + self.polarization_energy(P) + self.vdw_energy(P)
        return e + self.bonded_energy(P) if include_bonded else e

    def energy_forces(self, P, include_bonded: bool = True):
        return _value_and_forces(lambda p: self.energy(p, include_bonded), P)


@dataclasses.dataclass
class AmoebaWaterBox:
    """Periodic AMOEBA water (``amoeba.py:438-596``): the multipole SPME
    (real space within ``cutoff``, mesh, self term, the intramolecular
    pairs' erf part removed), real-space Thole induction within ``cutoff``
    (the reference's Tinker also meshes the induced field), buffered 14-7
    shifted to zero at ``vdw_cutoff``; minimum image, dense pair masks."""

    base: AmoebaWaterSystem
    cell: torch.Tensor            # [3]
    pme: MP.MultipoleEwaldParams
    cutoff: float = 9.0
    vdw_cutoff: float = 9.0

    @classmethod
    def build(cls, n_waters: int, cell, cutoff: float = 9.0, vdw_cutoff: float = 9.0,
              sor_iters: int = 40, grid_spacing: float = 0.8, beta: float = 0.4, device=None,
              dtype=torch.float32) -> "AmoebaWaterBox":
        device = resolve_device(device)
        base = AmoebaWaterSystem.build(n_waters, sor_iters=sor_iters, device=device, dtype=dtype)
        pme = MP.MultipoleEwaldParams.build(np.asarray(cell, np.float64), beta=beta,
                                            grid_spacing=grid_spacing, device=device, dtype=dtype)
        return cls(base=base, cell=torch.as_tensor(np.asarray(cell, np.float64), dtype=dtype,
                                                   device=device),
                   pme=pme, cutoff=cutoff, vdw_cutoff=vdw_cutoff)

    def _image(self, x):
        return x - self.cell * torch.round(x / self.cell)

    def permanent_energy(self, P):
        """``MP.multipole_ewald_energy`` over the intermolecular pairs, the
        intramolecular ones excluded, eV (``amoeba.py:486-497``)."""
        q, mu, theta = self.base.lab_multipoles(P)
        n = self.base.n_sites
        ii, jj = np.triu_indices(n, 1)
        mol = np.repeat(np.arange(n // 3), 3)
        inter = torch.as_tensor(mol[ii] != mol[jj], device=P.device)
        ii, jj = (torch.as_tensor(a, device=P.device) for a in (ii, jj))
        x = self._image(P[jj] - P[ii])
        live = inter & ((x * x).sum(-1) < self.cutoff * self.cutoff)
        args = (q[ii], mu[ii], theta[ii], q[jj], mu[jj], theta[jj])
        e_real = _kernel_pairs(_parked(x, live), args, MP.make_kernel_erfc(self.pme.beta), live)
        e_adj = -_kernel_pairs(_parked(x, ~inter), args, make_kernel_erf(self.pme.beta), ~inter)
        e = (e_real + MP.reciprocal_energy(self.pme, P, q, mu, theta)
             + MP.self_energy(q, mu, theta, self.pme.beta) + e_adj)
        return units.COULOMB * e

    def _live(self, P, mask, cutoff):
        """(minimum-image r_i - r_j parked where dead, r, the pairs of
        ``mask`` within ``cutoff``)."""
        x = self._image(P[:, None, :] - P[None, :, :])
        r = torch.sqrt((_parked(x, mask) ** 2).sum(-1))
        live = mask & (r < cutoff)
        return _parked(x, live), torch.where(live, r, torch.full_like(r, 10.0)), live

    def _permanent_field(self, P):
        b = self.base
        q, mu, theta = b.lab_multipoles(P)
        x, r, live = self._live(P, b._pair_masks()[0], self.cutoff)
        return _field_sum(x, q, mu, theta, _damping(b.pdamp, b.thole, r), live)

    def induced_dipoles(self, P):
        b = self.base
        E0 = self._permanent_field(P)
        not_self = ~torch.eye(b.n_sites, dtype=torch.bool, device=P.device)
        x, r, live = self._live(P, not_self, self.cutoff)
        return _sor(E0, x, _damping(b.pdamp, b.thole, r), live, b.alpha, b.sor_iters,
                    b.sor_omega), E0

    def polarization_energy(self, P):
        mu_ind, E0 = self.induced_dipoles(P)
        return -0.5 * units.COULOMB * (mu_ind * E0).sum()

    def vdw_energy(self, P):
        """Buffered 14-7 within ``vdw_cutoff``, shifted to zero there."""
        b = self.base
        diff_mol, iu = b._pair_masks()
        x, r, live = self._live(b._sites(P), diff_mol & iu, self.vdw_cutoff)
        r = torch.where(live, r, torch.full_like(r, self.vdw_cutoff))
        e, r0, eps = _halgren(r, b.vdw_rmin, b.vdw_eps)
        rho_c = self.vdw_cutoff / r0
        e_cut = eps * (1.07 / (rho_c + 0.07)) ** 7 * (1.12 / (rho_c ** 7 + 0.12) - 2.0)
        return torch.where(live, e - e_cut, torch.zeros_like(e)).sum()

    def energy(self, P, include_bonded: bool = True):
        e = self.permanent_energy(P) + self.polarization_energy(P) + self.vdw_energy(P)
        return e + self.base.bonded_energy(P) if include_bonded else e

    def energy_forces(self, P, include_bonded: bool = True):
        return _value_and_forces(lambda p: self.energy(p, include_bonded), P)


def _erf_over_r_scaled(u):
    """sqrt(pi)/2 erf(sqrt u)/sqrt u, analytic in u with value 1 at 0: a
    series below u = 0.04 (``amoeba_pme.py:51-63``)."""
    small = u < 0.04
    us = torch.where(small, u, torch.zeros_like(u))
    series = 1.0 - us / 3.0 + us ** 2 / 10.0 - us ** 3 / 42.0 + us ** 4 / 216.0 - us ** 5 / 1320.0
    ub = torch.where(small, torch.ones_like(u), u)
    exact = MP.SQRT_PI / 2.0 * torch.special.erf(torch.sqrt(ub)) / torch.sqrt(ub)
    return torch.where(small, series, exact)


def make_kernel_erf(beta):
    """g(y) = erf(beta r) / r, smooth at r = 0 (``amoeba_pme.py:70-77``)."""
    return lambda y: 2.0 * beta / MP.SQRT_PI * _erf_over_r_scaled(beta * beta * (y * y).sum())


def _kernel_pairs(x, args, kernel, live):
    """sum over the live pairs of ``MP.pair_energy_kernel`` at x = r_j - r_i."""
    e = torch.func.vmap(lambda xx, *a: MP.pair_energy_kernel(xx, *a, kernel))(x, *args)
    return torch.where(live, e, torch.zeros_like(e)).sum()


def molecular_dipole_debye(sys: AmoebaWaterSystem, P, mol: int = 0):
    """The permanent dipole of one water, Debye (``amoeba.py:599-607``)."""
    q, mu, _ = sys.lab_multipoles(P)
    sel = (sys.mol_id == mol)[:, None]
    com = torch.where(sel, P, torch.zeros_like(P)).mean(0)     # origin-free: the net charge is 0
    d = torch.where(sel, q[:, None] * (P - com) + mu, torch.zeros_like(P)).sum(0)
    return torch.sqrt((d * d).sum()) / 0.2081943                # e A -> Debye


def ideal_water(origin=(0.0, 0.0, 0.0), rot=None) -> np.ndarray:
    """One AMOEBA-geometry water [3,3]: O at the origin, H in the xz plane
    (``amoeba.py:610-621``)."""
    th = np.deg2rad(WATER_THETA_DEG)
    r = WATER_R_OH
    pos = np.array([
        [0.0, 0.0, 0.0],
        [r * np.sin(th / 2), 0.0, r * np.cos(th / 2)],
        [-r * np.sin(th / 2), 0.0, r * np.cos(th / 2)],
    ])
    if rot is not None:
        pos = pos @ np.asarray(rot).T
    return pos + np.asarray(origin)
