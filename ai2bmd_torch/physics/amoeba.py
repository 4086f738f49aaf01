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

Not ported yet (ROADMAP.md, Queue 1 item 15): the test-scale classes
``AmoebaWaterSystem``, ``AmoebaWaterBox`` and ``molecular_dipole_debye``.
"""

from __future__ import annotations

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.data import asset_path

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
