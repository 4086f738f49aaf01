"""Multipole Ewald / SPME for periodic AMOEBA electrostatics.

Port of ``ai2bmd_tpu/physics/amoeba_pme.py``: the charge-only SPME of
``physics/pme.py`` extended to the point-multipole set of AMOEBA (monopole,
dipole, traceless quadrupole), the electrostatics Tinker9 evaluates for the
reference's solvated systems (src/Calculators/tinker_async.py:127-145).

  * Reciprocal space: order-6 cardinal B-spline SPME.  Each site spreads
    q M M M, its dipole with one spline derivative and its quadrupole with
    two, so the mesh sees the structure factor lambda(m) = q + 2 pi i mu.m -
    (2 pi)^2 (m.Theta.m) / 3.  The spreading is one ``index_add`` of 6^3
    stencil weights a site, as ``physics/pme.py``'s ``spread``; JAX spreads
    by a dense chunked product (``_spread_multipoles_dense``), a TPU idiom.
    ``reciprocal_dipole_gradient`` is the mesh energy's gradient in the
    dipoles, the mesh potential gathered back through the stencils'
    derivatives (JAX takes ``jax.grad`` of the energy).
  * Real space: the closed form of the pair energy in the radial functions
    B_0 = g(r), B_{n+1} = -(1/r) dB_n/dr (``multipole_pair_energy_soa``,
    with the erfc and Coulomb chains), exact for traceless quadrupoles; every
    quantity a flat component array ([N,K] planes on the neighbour list).
  * ``self_energy``: JAX evaluates the erf-kernel pair energy at x = 0 by
    nested autodiff; its closed form there is B_0 q^2 + B_1 |mu|^2 + B_2
    (2/9) Theta:Theta with B_n(0) of erf(beta r)/r, which is what this port
    computes (with the terms of a quadrupole's trace, which float32 tables
    leave).
  * ``ewald_multipole_direct``: an O(N^2 K^3) k-space reference sum in
    numpy (the tests' check of the mesh), with ``pair_energy_kernel``, the
    kernel-generic pair energy by ``torch.func``.

Units: e, A; energies in e^2/A (multiply by units.COULOMB for eV).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ai2bmd_torch.physics.gridutil import smooth_grid

SPLINE_ORDER = 6
SQRT_PI = math.sqrt(math.pi)


# ---------------------------------------------------------------------------
# the kernel-generic pair energy (the direct sum's reference) and the self term
# ---------------------------------------------------------------------------

def make_kernel_erfc(beta):
    def g(y):
        r = torch.sqrt((y * y).sum())
        return torch.special.erfc(beta * r) / r
    return g


def pair_energy_kernel(x, qi, mui, ti, qj, muj, tj, kernel):
    """Energy of two point multipoles at x = r_j - r_i for a radial kernel g
    (``amoeba_pme.py:82-101``): phi_i = q g - mu.grad g + Theta : hess g / 3,
    E = qj phi + muj.grad phi + Theta_j : hess phi / 3, by ``torch.func``."""
    G, H = torch.func.grad(kernel), torch.func.hessian(kernel)
    phi = lambda y: qi * kernel(y) - mui @ G(y) + (ti * H(y)).sum() / 3.0
    return (qj * phi(x) + muj @ torch.func.grad(phi)(x)
            + (tj * torch.func.hessian(phi)(x)).sum() / 3.0)


def self_energy(q, mu, theta, beta: float):
    """Ewald self term -1/2 sum_i E_ii with the erf kernel at x = 0, in
    closed form (``amoeba_pme.py:104-110``): E_ii = B0 q^2 + B1 |mu|^2 -
    2/3 B1 q tr(Theta) + B2 (tr(Theta)^2 + 2 Theta:Theta) / 9 with B_n(0) of
    erf(beta r) / r.  The trace terms are what a quadrupole rounded off its
    tracelessness (float32 tables) adds, as JAX's autodiff of the kernel
    adds them."""
    b0 = 2.0 * beta / SQRT_PI
    b1 = 4.0 * beta ** 3 / (3.0 * SQRT_PI)
    b2 = 8.0 * beta ** 5 / (5.0 * SQRT_PI)
    tr = theta[:, 0, 0] + theta[:, 1, 1] + theta[:, 2, 2]
    return -0.5 * (b0 * (q * q).sum() + b1 * (mu * mu).sum() - 2.0 / 3.0 * b1 * (q * tr).sum()
                   + b2 / 9.0 * ((tr * tr).sum() + 2.0 * (theta * theta).sum()))


# ---------------------------------------------------------------------------
# order-6 B-splines
# ---------------------------------------------------------------------------

def _bspline(n: int, x):
    """Cardinal B-spline M_n on [0, n) by the Cox-de Boor recursion."""
    if n == 1:
        return ((x >= 0.0) & (x < 1.0)).to(x.dtype)
    return (x * _bspline(n - 1, x) + (n - x) * _bspline(n - 1, x - 1.0)) / (n - 1.0)


def _bspline_d1(n: int, x):
    return _bspline(n - 1, x) - _bspline(n - 1, x - 1.0)


def _bspline_d2(n: int, x):
    return _bspline(n - 2, x) - 2.0 * _bspline(n - 2, x - 1.0) + _bspline(n - 2, x - 2.0)


def _euler_spline_mod2(K: int, order: int = SPLINE_ORDER) -> np.ndarray:
    """1 / |sum_k M_n(k+1) e^{2 pi i m k / K}|^2 over m = 0..K-1."""
    m = np.arange(K)
    k = np.arange(order - 1)
    nodes = _bspline(order, torch.as_tensor(k + 1.0, dtype=torch.float64)).numpy()
    denom = (nodes[None, :] * np.exp(2j * np.pi * m[:, None] * k[None, :] / K)).sum(1)
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-14)


# ---------------------------------------------------------------------------
# multipole SPME
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultipoleEwaldParams:
    beta: float
    cell: torch.Tensor        # [3]
    grid: tuple
    influence: torch.Tensor   # [Kx,Ky,Kz]

    @classmethod
    def build(cls, cell, beta: float = 0.4, grid_spacing: float = 0.8, device=None,
              dtype=torch.float64) -> "MultipoleEwaldParams":
        """``amoeba_pme.py:168-195``: the 2/3/5-smooth mesh of at least
        ceil(L / grid_spacing) and 12 points an axis, and the influence
        function, in float64 on the host."""
        cell = np.asarray(cell, np.float64)
        grid = smooth_grid(max(int(np.ceil(c / grid_spacing)), 2 * SPLINE_ORDER) for c in cell)
        ms = [np.fft.fftfreq(K) * K / L for K, L in zip(grid, cell)]
        MX, MY, MZ = np.meshgrid(*ms, indexing="ij")
        m2 = MX ** 2 + MY ** 2 + MZ ** 2
        b2 = (_euler_spline_mod2(grid[0])[:, None, None]
              * _euler_spline_mod2(grid[1])[None, :, None]
              * _euler_spline_mod2(grid[2])[None, None, :])
        with np.errstate(divide="ignore", invalid="ignore"):
            infl = np.exp(-np.pi ** 2 * m2 / beta ** 2) / m2 * b2
        infl.flat[0] = 0.0
        infl = infl / (2.0 * np.pi * float(np.prod(cell)))
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(beta=beta, cell=f(cell), grid=grid, influence=f(infl))


def _stencils(pme: MultipoleEwaldParams, P):
    """Per axis (W0, W1, W2, idx), each [N, 6]: the window's value and its
    first and second derivatives in length units at the 6 grid points it
    covers, and those points' indices (``amoeba_pme.py:212-227``).  The mesh
    sizes are Python ints, so nothing is copied from the host."""
    n = SPLINE_ORDER
    offs = torch.arange(n, device=P.device)
    out = []
    for a, K in enumerate(pme.grid):
        h = pme.cell[a] / K
        u = P[:, a] / pme.cell[a] * K
        i0 = torch.floor(u)
        arg = (u - i0)[:, None] + (n - 1.0) - offs.to(P.dtype)
        out.append((_bspline(n, arg), _bspline_d1(n, arg) / h, _bspline_d2(n, arg) / (h * h),
                    (i0.long()[:, None] - (n - 1) + offs) % K))
    return out


def _outer(a, b, c):
    return a[:, :, None, None] * b[:, None, :, None] * c[:, None, None, :]


def _mesh_index(pme: MultipoleEwaldParams, st):
    _, Ky, Kz = pme.grid
    ix, iy, iz = st[0][3], st[1][3], st[2][3]
    return (ix[:, :, None, None] * (Ky * Kz) + iy[:, None, :, None] * Kz
            + iz[:, None, None, :]).reshape(-1)


def spread_multipoles(pme: MultipoleEwaldParams, P, q, mu, theta, st=None):
    """q, mu, Theta on the mesh [Kx,Ky,Kz] (``amoeba_pme.py:198-259``): the
    density q d(r - ri) + mu.grad d + Theta : grad grad d / 3 convolved with
    the window, by one ``index_add``; differentiable in everything."""
    st = _stencils(pme, P) if st is None else st
    (x0, x1, x2, _), (y0, y1, y2, _), (z0, z1, z2, _) = st
    w = lambda c: c[:, None, None, None]
    contrib = (w(q) * _outer(x0, y0, z0)
               + w(mu[:, 0]) * _outer(x1, y0, z0) + w(mu[:, 1]) * _outer(x0, y1, z0)
               + w(mu[:, 2]) * _outer(x0, y0, z1))
    if theta is not None:
        th = theta
        contrib = contrib + (1.0 / 3.0) * (
            w(th[:, 0, 0]) * _outer(x2, y0, z0) + w(th[:, 1, 1]) * _outer(x0, y2, z0)
            + w(th[:, 2, 2]) * _outer(x0, y0, z2)
            + 2.0 * w(th[:, 0, 1]) * _outer(x1, y1, z0)
            + 2.0 * w(th[:, 0, 2]) * _outer(x1, y0, z1)
            + 2.0 * w(th[:, 1, 2]) * _outer(x0, y1, z1))
    Kx, Ky, Kz = pme.grid
    rho = torch.zeros(Kx * Ky * Kz, dtype=P.dtype, device=P.device)
    return rho.index_add(0, _mesh_index(pme, st), contrib.reshape(-1)).reshape(Kx, Ky, Kz)


def reciprocal_energy(pme: MultipoleEwaldParams, P, q, mu, theta):
    """sum(influence * |FFT(rho)|^2) of the multipoles' mesh density, e^2/A
    (``amoeba_pme.py:355-362``)."""
    rho_k = torch.fft.fftn(spread_multipoles(pme, P, q, mu, theta))
    return (pme.influence * (rho_k.real ** 2 + rho_k.imag ** 2)).sum()


def reciprocal_dipole_gradient(pme: MultipoleEwaldParams, P, m, st=None):
    """d/dm of ``reciprocal_energy(pme, P, 0, m, 0)`` for dipoles m [N,3,R]
    (R right-hand sides at once): dE/drho = 2 Kx Ky Kz Re(ifft(influence *
    fft(rho))), gathered back through each dipole channel's stencil.
    Explicit tensor algebra, so it is differentiable in P by plain autograd;
    JAX takes ``jax.grad`` of the energy."""
    st = _stencils(pme, P) if st is None else st
    (x0, x1, _, _), (y0, y1, _, _), (z0, z1, _, _) = st
    lin = _mesh_index(pme, st)
    Kx, Ky, Kz = pme.grid
    chans = (_outer(x1, y0, z0), _outer(x0, y1, z0), _outer(x0, y0, z1))     # [N,6,6,6]
    n = P.shape[0]
    cols = []
    for r in range(m.shape[-1]):
        contrib = sum(m[:, a, r, None, None, None] * chans[a] for a in range(3))
        rho = torch.zeros(Kx * Ky * Kz, dtype=P.dtype, device=P.device).index_add(
            0, lin, contrib.reshape(-1)).reshape(Kx, Ky, Kz)
        pot = torch.fft.ifftn(pme.influence * torch.fft.fftn(rho)).real * (2.0 * Kx * Ky * Kz)
        g = pot.reshape(-1)[lin].reshape(n, -1)                               # [N,216]
        cols.append(torch.stack([(g * c.reshape(n, -1)).sum(-1) for c in chans], dim=-1))
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# direct k-space reference (tests)
# ---------------------------------------------------------------------------

def ewald_multipole_direct(P, q, mu, theta, cell, beta, kmax=8):
    """O(N^2 K^3) multipole Ewald reference in float64 (``amoeba_pme.py:
    370-429``): (e_real, e_rec, e_self) in e^2/A.  The structure factor per
    site is q + 2 pi i mu.m - (2 pi)^2 (m.Theta.m) / 3."""
    P, q, mu, theta, cell = (np.asarray(a, np.float64) for a in (P, q, mu, theta, cell))
    n = len(q)
    V = float(np.prod(cell))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    g = make_kernel_erfc(beta)
    e_real = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            d = P[j] - P[i]
            d = d - cell * np.round(d / cell)
            e_real += float(pair_energy_kernel(t(d), t(q[i]), t(mu[i]), t(theta[i]), t(q[j]),
                                               t(mu[j]), t(theta[j]), g))
    e_rec = 0.0
    for mx in range(-kmax, kmax + 1):
        for my in range(-kmax, kmax + 1):
            for mz in range(-kmax, kmax + 1):
                if mx == my == mz == 0:
                    continue
                mvec = np.array([mx, my, mz]) / cell
                m2 = float(mvec @ mvec)
                lam = (q + 2j * np.pi * (mu @ mvec)
                       - (2 * np.pi) ** 2 / 3.0 * np.einsum("i,nij,j->n", mvec, theta, mvec))
                s = np.sum(lam * np.exp(2j * np.pi * (P @ mvec)))
                e_rec += np.exp(-np.pi ** 2 * m2 / beta ** 2) / m2 * abs(s) ** 2
    e_rec /= 2.0 * np.pi * V
    e_self = float(self_energy(t(q), t(mu), t(theta), beta))
    return e_real, e_rec, e_self


# ---------------------------------------------------------------------------
# closed-form pair energies and fields on flat component arrays
#
#   E = B0 (qi qj)
#     + B1 (qj mir - qi mjr + mimj)
#     + B2 (-mir mjr + qi Qrj/3 + qj Qri/3 - 2 miTjr/3 + 2 mjTir/3 + 2 TiTj/9)
#     + B3 (mir Qrj/3 - mjr Qri/3 - 4 TirTjr/9)
#     + B4 (Qri Qrj / 9)
#
# with R = r_j - r_i, mir = mu_i.R, Qri = R.Theta_i.R, TiTj = Theta:Theta,
# TirTjr = (Theta_i R).(Theta_j R) (``amoeba_pme.py:470-486``).
# ---------------------------------------------------------------------------

def bn_chain_erfc(r2, beta: float, n: int = 5):
    """B_0..B_{n-1} for g = erfc(beta r) / r."""
    r = torch.sqrt(r2)
    bs = [torch.special.erfc(beta * r) / r]
    expt = torch.exp(-beta * beta * r2) / (beta * SQRT_PI)
    pw = 2.0 * beta * beta
    for k in range(n - 1):
        bs.append(((2 * k + 1) * bs[-1] + pw * expt) / r2)
        pw = pw * 2.0 * beta * beta
    return bs


def bn_chain_coulomb(r2, n: int = 5):
    bs = [1.0 / torch.sqrt(r2)]
    for k in range(n - 1):
        bs.append((2 * k + 1) * bs[-1] / r2)
    return bs


def _mp_contractions(x, y, z, qi, qj, mi, mj, ti, tj):
    """Scalar contractions; mi / mj = (x, y, z) components, ti / tj = (xx,
    xy, xz, yy, yz, zz) components (traceless)."""
    mix, miy, miz = mi
    mjx, mjy, mjz = mj
    tixx, tixy, tixz, tiyy, tiyz, tizz = ti
    tjxx, tjxy, tjxz, tjyy, tjyz, tjzz = tj
    mir = mix * x + miy * y + miz * z
    mjr = mjx * x + mjy * y + mjz * z
    mimj = mix * mjx + miy * mjy + miz * mjz
    tirx = tixx * x + tixy * y + tixz * z
    tiry = tixy * x + tiyy * y + tiyz * z
    tirz = tixz * x + tiyz * y + tizz * z
    tjrx = tjxx * x + tjxy * y + tjxz * z
    tjry = tjxy * x + tjyy * y + tjyz * z
    tjrz = tjxz * x + tjyz * y + tjzz * z
    qri = x * tirx + y * tiry + z * tirz
    qrj = x * tjrx + y * tjry + z * tjrz
    titj = (tixx * tjxx + tiyy * tjyy + tizz * tjzz
            + 2.0 * (tixy * tjxy + tixz * tjxz + tiyz * tjyz))
    tirtjr = tirx * tjrx + tiry * tjry + tirz * tjrz
    mitjr = mix * tjrx + miy * tjry + miz * tjrz
    mjtir = mjx * tirx + mjy * tiry + mjz * tirz
    return mir, mjr, mimj, qri, qrj, titj, tirtjr, mitjr, mjtir


def multipole_pair_energy_soa(x, y, z, qi, qj, mi, mj, ti, tj, bns):
    """Pair energies from component arrays and a B_n chain (>= 5 long);
    (x, y, z) = r_j - r_i (``amoeba_pme.py:528-545``)."""
    mir, mjr, mimj, qri, qrj, titj, tirtjr, mitjr, mjtir = _mp_contractions(
        x, y, z, qi, qj, mi, mj, ti, tj)
    b0, b1, b2, b3, b4 = bns[:5]
    g0 = qi * qj
    g1 = qj * mir - qi * mjr + mimj
    g2 = (-mir * mjr + (qi * qrj + qj * qri) / 3.0
          - 2.0 / 3.0 * mitjr + 2.0 / 3.0 * mjtir + 2.0 / 9.0 * titj)
    g3 = (mir * qrj - mjr * qri) / 3.0 - 4.0 / 9.0 * tirtjr
    g4 = qri * qrj / 9.0
    return b0 * g0 + b1 * g1 + b2 * g2 + b3 * g3 + b4 * g4


def field_soa(x, y, z, q, mu, theta, l3, l5, l7):
    """Damped field components at the field point, (x, y, z) = r_point -
    r_source (``amoeba_pme.py:548-577``); returns (Ex, Ey, Ez)."""
    mx, my, mz = mu
    txx, txy, txz, tyy, tyz, tzz = theta
    r2 = x * x + y * y + z * z
    r = torch.sqrt(r2)
    r3 = r2 * r
    r5 = r2 * r3
    r7 = r2 * r5
    trx = txx * x + txy * y + txz * z
    try_ = txy * x + tyy * y + tyz * z
    trz = txz * x + tyz * y + tzz * z
    xtx = x * trx + y * try_ + z * trz
    mux = mx * x + my * y + mz * z
    r3s = torch.where(r3 == 0, torch.ones_like(r3), r3)
    ex = l3 * (q * x - mx) / r3s
    ey = l3 * (q * y - my) / r3s
    ez = l3 * (q * z - mz) / r3s
    ex = ex + l5 * (3.0 * mux * x - 2.0 * trx) / r5 + l7 * 5.0 * xtx * x / r7
    ey = ey + l5 * (3.0 * mux * y - 2.0 * try_) / r5 + l7 * 5.0 * xtx * y / r7
    ez = ez + l5 * (3.0 * mux * z - 2.0 * trz) / r5 + l7 * 5.0 * xtx * z / r7
    return ex, ey, ez


def dipole_field_soa(x, y, z, p, l3, l5):
    """Damped field of point dipoles p = (px, py, pz) (``amoeba_pme.py:
    580-591``)."""
    px, py, pz = p
    r2 = x * x + y * y + z * z
    r = torch.sqrt(r2)
    r3 = r2 * r
    r5 = r2 * r3
    pr = px * x + py * y + pz * z
    return (l5 * 3.0 * pr * x / r5 - l3 * px / r3, l5 * 3.0 * pr * y / r5 - l3 * py / r3,
            l5 * 3.0 * pr * z / r5 - l3 * pz / r3)
