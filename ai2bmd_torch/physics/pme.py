"""Smooth particle-mesh Ewald, differentiable, on tensors.

Port of ``ai2bmd_tpu/physics/pme.py``: order-4 cardinal B-spline charge
spreading (``index_add``), the reciprocal sum through ``torch.fft.fftn`` with
the Euler-spline influence function, and the reference's direct, self,
adjusted-exclusion and neutralizing terms (reference src/Calculators/
pme.py:77-110, 155-214, term for term):

    E = E_dir + E_rec + E_self + E_adj + E_neutral + E_LJ(excl-complement)

Forces are exact gradients of the whole PME energy by autograd (JAX takes
``jax.grad``); the reference's forces leave the reciprocal term out.  In
fragment mode the pair terms are dense [N,N] masks over the protein, with no
neighbour list (ROADMAP item 12).  ``spread`` and ``influence_function`` are
shared with the MM engine (``physics/mm.py``).

``index_add`` sums on CUDA in no fixed order, so two evaluations on the card
agree within float32 rounding, not bitwise.

Units: q in e, lengths in A; energies in eV (COULOMB = 1/(4 pi eps0)).
"""

from __future__ import annotations

import dataclasses
from math import erfc

import numpy as np
import torch

from ai2bmd_torch.host import Protein, units
from ai2bmd_torch.physics.gridutil import smooth_grid
from ai2bmd_torch.utils.device import resolve_device

SPLINE_ORDER = 4


def bspline4(x: torch.Tensor) -> torch.Tensor:
    """Cardinal B-spline M4 on [0, 4), 0 elsewhere."""
    zero = torch.zeros_like(x)
    return torch.where(
        x < 1.0, x ** 3 / 6.0,
        torch.where(
            x < 2.0, (-3 * x ** 3 + 12 * x ** 2 - 12 * x + 4) / 6.0,
            torch.where(
                x < 3.0, (3 * x ** 3 - 24 * x ** 2 + 60 * x - 44) / 6.0,
                torch.where(x < 4.0, (4 - x) ** 3 / 6.0, zero))))


def euler_spline_mod2(K: int) -> np.ndarray:
    """|b(m)|^2 for order-4 splines on a K-point grid (SPME influence)."""
    m = np.arange(K)
    k = np.arange(SPLINE_ORDER - 1)
    M = np.array([1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0])   # M4 at the integer nodes 1, 2, 3
    denom = (M[None, :] * np.exp(2j * np.pi * m[:, None] * k[None, :] / K)).sum(1)
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-14)


def mesh_grid(cell: np.ndarray, grid_spacing: float) -> tuple:
    """The 2/3/5-smooth mesh of at least 2 * SPLINE_ORDER points an axis."""
    return smooth_grid(max(int(c / grid_spacing), 2 * SPLINE_ORDER) for c in cell)


def influence_function(cell: np.ndarray, grid: tuple, beta: float) -> np.ndarray:
    """float64 [Kx,Ky,Kz]: exp(-pi^2 m^2 / beta^2) / m^2 * B(m) / (2 pi V),
    0 at m = 0 (``pme.py:100-116``)."""
    ms = [np.fft.fftfreq(K) * K / L for K, L in zip(grid, cell)]
    MX, MY, MZ = np.meshgrid(*ms, indexing="ij")
    m2 = MX ** 2 + MY ** 2 + MZ ** 2
    b2 = (euler_spline_mod2(grid[0])[:, None, None]
          * euler_spline_mod2(grid[1])[None, :, None]
          * euler_spline_mod2(grid[2])[None, None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        infl = np.exp(-np.pi ** 2 * m2 / beta ** 2) / m2 * b2
    infl.flat[0] = 0.0
    return infl / (2.0 * np.pi * float(np.prod(cell)))


def spread(charge: torch.Tensor, P: torch.Tensor, cell: torch.Tensor, grid: tuple):
    """Order-4 B-spline charge assignment to the mesh, [Kx,Ky,Kz]
    (``pme.py:143-171``): 64 (grid point, weight) pairs an atom, summed with
    one ``index_add``; differentiable in P."""
    Kx, Ky, Kz = grid
    offs = torch.arange(SPLINE_ORDER, device=P.device)
    w, idx = [], []
    for a, K in enumerate(grid):       # per axis, with the mesh size a Python int (no copy
        u = P[:, a] / cell[a] * K      # to the card inside a captured step)
        i0 = torch.floor(u)
        # offsets j = 0..3 -> grid point i0 - 3 + j, weight M4(t + 3 - j)
        w.append(bspline4((u - i0)[:, None] + 3.0 - offs.to(P.dtype)))      # [N,4]
        idx.append((i0.long()[:, None] - 3 + offs) % K)                       # [N,4]
    W = w[0][:, :, None, None] * w[1][:, None, :, None] * w[2][:, None, None, :]
    lin = (idx[0][:, :, None, None] * (Ky * Kz) + idx[1][:, None, :, None] * Kz
           + idx[2][:, None, None, :])
    contrib = (charge[:, None, None, None] * W).reshape(-1)
    rho = torch.zeros(Kx * Ky * Kz, dtype=P.dtype, device=P.device)
    return rho.index_add(0, lin.reshape(-1), contrib).reshape(Kx, Ky, Kz)


def mesh_energy(influence: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """sum(influence * |FFT(rho)|^2), in e^2/A."""
    rho_k = torch.fft.fftn(rho)
    return (influence * (rho_k.real ** 2 + rho_k.imag ** 2)).sum()


@dataclasses.dataclass
class PMEParams:
    beta: float
    cutoff: float
    cell: torch.Tensor        # [3] box lengths
    grid: tuple               # (Kx, Ky, Kz)
    influence: torch.Tensor   # [Kx,Ky,Kz] (0 at k = 0)
    charge: torch.Tensor      # [N]
    sigma: torch.Tensor       # [N] A
    eps: torch.Tensor         # [N] eV
    pair_mask: torch.Tensor   # [N,N] i != j
    excl_mask: torch.Tensor   # [N,N] excluded pairs (symmetric)
    e_self: float
    e_neutral: float

    @classmethod
    def build(cls, prot: Protein, exclusion_pairs: np.ndarray, beta: float = 0.3,
              cutoff: float = 9.0, grid_spacing: float = 1.0, device=None,
              dtype=torch.float32) -> "PMEParams":
        """``pme.py:79-140``: the influence function, self and neutralizing
        terms in float64 on the host, then cast to ``dtype``.  ``device`` None
        means the card (raises without one)."""
        if prot.cell is None:
            raise ValueError("PME requires a periodic cell (CRYST1 record)")
        device = resolve_device(device)
        cell = np.asarray(prot.cell, np.float64)
        grid = mesh_grid(cell, grid_spacing)
        volume = float(np.prod(cell))
        q = prot.charges.astype(np.float64)
        n = len(prot)
        excl_mask = np.zeros((n, n), dtype=bool)
        if len(exclusion_pairs):
            i, j = np.asarray(exclusion_pairs).T
            excl_mask[i, j] = True
            excl_mask[j, i] = True
        # values rounded through float32 like the JAX package's tables
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
        b = lambda a: torch.as_tensor(a, device=device)
        return cls(
            beta=beta, cutoff=cutoff, cell=f(cell), grid=grid,
            influence=f(influence_function(cell, grid, beta)),
            charge=f(prot.charges), sigma=f(prot.sigmas),
            eps=f(prot.epsilons * units.kcal_per_mol),
            pair_mask=b(~np.eye(n, dtype=bool)), excl_mask=b(excl_mask),
            e_self=-beta / np.sqrt(np.pi) * float(np.sum(q * q)),
            e_neutral=-np.pi / (2.0 * beta ** 2 * volume) * float(np.sum(q)) ** 2,
        )


def reciprocal_energy(pme: PMEParams, P: torch.Tensor) -> torch.Tensor:
    return mesh_energy(pme.influence, spread(pme.charge, P, pme.cell, pme.grid))


def _minimum_image(vec, cell):
    return vec - cell * torch.round(vec / cell)


def pme_energy(pme: PMEParams, P: torch.Tensor) -> torch.Tensor:
    """Full PME + LJ energy in eV (``pme.py:182-214``)."""
    vec = _minimum_image(P[None, :, :] - P[:, None, :], pme.cell)
    d2 = (vec * vec).sum(-1)
    one = torch.ones((), dtype=P.dtype, device=P.device)
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    d2s = torch.where(pme.pair_mask, d2, one)
    d = torch.sqrt(d2s)
    within = pme.pair_mask & (d2 < pme.cutoff ** 2)
    qq = pme.charge[:, None] * pme.charge[None, :]

    # direct space (erfc) over the exclusion complement within the cutoff
    coul_mask = within & ~pme.excl_mask
    e_dir = 0.5 * torch.where(coul_mask, qq * torch.special.erfc(pme.beta * d) / d, zero).sum()
    # adjusted exclusion (erf over the excluded pairs, no cutoff)
    e_adj = -0.5 * torch.where(pme.excl_mask, qq * torch.erf(pme.beta * d) / d, zero).sum()
    e_rec = reciprocal_energy(pme, P)
    e_coulomb = (e_dir + e_adj + e_rec + pme.e_self + pme.e_neutral) * units.COULOMB

    # LJ over the exclusion complement within the cutoff
    sig = 0.5 * (pme.sigma[:, None] + pme.sigma[None, :])
    eps = torch.sqrt(pme.eps[:, None] * pme.eps[None, :])
    c6 = (sig * sig / d2s) ** 3
    e_lj = 0.5 * torch.where(coul_mask, 4.0 * eps * (c6 * c6 - c6), zero).sum()
    return e_coulomb + e_lj


def pme_energy_forces(pme: PMEParams, P: torch.Tensor):
    """(E, F = -dE/dP) by autograd."""
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = pme_energy(pme, p)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


# ---------------------------------------------------------------------------
# reference checker: direct Ewald sum (O(N^2 * K^3), tests only)
# ---------------------------------------------------------------------------

def ewald_direct_sum(q, P, cell, beta, kmax=8):
    """Textbook Ewald summation (real + reciprocal + self + background), to
    check the mesh on small systems (``pme.py:221-258``).  Returns the
    Coulomb energy in e^2/A (times units.COULOMB for eV)."""
    q = np.asarray(q, np.float64)
    P = np.asarray(P, np.float64)
    cell = np.asarray(cell, np.float64)
    n = len(q)
    V = float(np.prod(cell))

    e_real = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            d = P[i] - P[j]
            d = d - cell * np.round(d / cell)
            r = np.linalg.norm(d)
            e_real += q[i] * q[j] * erfc(beta * r) / r

    e_rec = 0.0
    for mx in range(-kmax, kmax + 1):
        for my in range(-kmax, kmax + 1):
            for mz in range(-kmax, kmax + 1):
                if mx == my == mz == 0:
                    continue
                mvec = np.array([mx, my, mz]) / cell
                m2 = float(mvec @ mvec)
                s = np.sum(q * np.exp(2j * np.pi * (P @ mvec)))
                e_rec += np.exp(-np.pi ** 2 * m2 / beta ** 2) / m2 * abs(s) ** 2
    e_rec /= 2.0 * np.pi * V

    e_self = -beta / np.sqrt(np.pi) * np.sum(q * q)
    e_neutral = -np.pi / (2.0 * beta ** 2 * V) * np.sum(q) ** 2
    return e_real + e_rec + e_self + e_neutral
