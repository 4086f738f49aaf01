"""Fixed-charge classical MM engine (ff19SB protein + TIP3P water + ions, PME).

Port of ``ai2bmd_tpu/physics/mm.py``, the in-framework replacement for the
Tinker9 co-process the reference drives over sockets every step
(src/Calculators/tinker_async.py:127-200): bonded terms with ff19SB CMAP,
erfc-Coulomb + LJ pairs within a cutoff, reciprocal-space PME, AMBER 1-2/1-3
exclusions and scaled 1-4 pairs as explicit pair-list corrections, and the
analytic LJ tail.

Two routes for the direct-space pairs, as in JAX:
  * ``dense_pair_energy_forces`` / ``mm_energy_forces_dense``: every pair in
    [tile, N] blocks with analytic pair forces (each atom sums its own row);
    the bonded, reciprocal and exclusion terms through autograd.  The
    cell-bucket route (``physics/cellpair.py``) evaluates the same pairs
    block by block;
  * ``mm_energy`` / ``mm_energy_forces``: an [N, K] neighbour list
    (``ops/neighbors.py``): the pairs with analytic forces over the list's
    planes (``nl_pair_energy_forces``), the rest through autograd; the
    energy alone (``mm_energy``, for ``mm_pressure``) through autograd.

Every energy takes an optional ``cell`` (a [3] tensor): the box of a
dynamic-cell NPT step, whose PME mesh keeps its size while the influence
function and the volume terms follow the cell (``dynamic_influence``);
``cell=None`` is the static box of ``MMSystem.build``, on the code path the
NVT runs take.  ``mm_pressure_dense`` and ``mm_pressure`` give the
instantaneous isotropic pressure by the strain derivative.

``MMSystem.polarization`` (a ``physics/polarization.PolarizationParams``)
adds the induced-dipole hybrid on the ``nl`` route (``mm_energy``); the
dense route refuses it, as JAX's does.

Units: positions A, energy eV, forces eV/A.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ai2bmd_torch.data.protein_topology import SystemTopology
from ai2bmd_torch.host import units
from ai2bmd_torch.ops.neighbors import NeighborList, _pbc_diff, gather_rows
from ai2bmd_torch.physics.polarization import (PolarizationParams, polarization_energy,
                                                polarization_energy_forces)
from ai2bmd_torch.physics.pme import (euler_spline_mod2, influence_function, mesh_energy,
                                      mesh_grid, spread)
from ai2bmd_torch.utils.device import resolve_device

KCAL = units.kcal_per_mol


@dataclasses.dataclass
class MMSystem:
    """Device-side MM tables for one (sub)system."""

    n_atoms: int
    cell: torch.Tensor        # [3] A
    cutoff: float
    beta: float
    grid: tuple
    influence: torch.Tensor   # [Kx,Ky,Kz]
    charge: torch.Tensor      # [N] e
    sigma: torch.Tensor       # [N] A
    eps: torch.Tensor         # [N] eV
    bonds: torch.Tensor
    bond_k: torch.Tensor      # eV/A^2
    bond_r0: torch.Tensor
    angles: torch.Tensor
    angle_k: torch.Tensor
    angle_t0: torch.Tensor
    dihedrals: torch.Tensor
    dih_k: torch.Tensor
    dih_n: torch.Tensor
    dih_phase: torch.Tensor
    excl_pairs: torch.Tensor
    pairs14: torch.Tensor
    scee: float
    scnb: float
    e_self: float             # eV
    e_neutral: float          # eV
    # ff19SB CMAP cross-terms (None when the topology carries none)
    cmap_atoms: torch.Tensor | None = None    # [M,5]: C(-1) N CA C N(+1)
    cmap_type: torch.Tensor | None = None     # [M]
    cmap_coeffs: torch.Tensor | None = None   # [T,R,R,4,4] bicubic coefficients, eV
    # analytic LJ dispersion tail beyond the cutoff: U_tail = lj_tail_a / V
    lj_tail_a: float = 0.0    # eV * A^3
    # |b(m)|^2 of the mesh's B-splines, [Kx,Ky,Kz]: the cell-free factor of
    # the influence function, kept on the device for dynamic_influence
    spline_mod2: torch.Tensor | None = None
    # the induced-dipole hybrid (physics/polarization.py), nl route only
    polarization: PolarizationParams | None = None

    @classmethod
    def build(cls, top: SystemTopology, cell: np.ndarray, cutoff: float = 9.0,
              beta: float = 0.35, grid_spacing: float = 1.0, scee: float = 1.2,
              scnb: float = 2.0, polarization: PolarizationParams | None = None, device=None,
              dtype=torch.float32) -> "MMSystem":
        """``mm.py:73-165``: host tables in float64, rounded through float32
        like the JAX package's, then cast to ``dtype``.  ``device`` None
        means the card (raises without one)."""
        device = resolve_device(device)
        cell = np.asarray(cell, np.float64)
        grid = mesh_grid(cell, grid_spacing)
        volume = float(np.prod(cell))
        q = top.charges
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        cmap = {}
        if top.cmap_atoms is not None and len(top.cmap_atoms):
            cmap = dict(cmap_atoms=i(top.cmap_atoms), cmap_type=i(top.cmap_type),
                        cmap_coeffs=f(cmap_bicubic_coeffs(top.cmap_grids) * KCAL))
        return cls(
            n_atoms=top.n_atoms, cell=f(cell), cutoff=cutoff, beta=beta, grid=grid,
            influence=f(influence_function(cell, grid, beta)),
            charge=f(q), sigma=f(top.sigmas), eps=f(top.epsilons * KCAL),
            bonds=i(top.bonds), bond_k=f(top.bond_k * KCAL), bond_r0=f(top.bond_r0),
            angles=i(top.angles), angle_k=f(top.angle_k * KCAL), angle_t0=f(top.angle_t0),
            dihedrals=i(top.dihedrals), dih_k=f(top.dih_k * KCAL), dih_n=f(top.dih_n),
            dih_phase=f(top.dih_phase), excl_pairs=i(top.excl_pairs), pairs14=i(top.pairs14),
            scee=scee, scnb=scnb,
            e_self=-beta / np.sqrt(np.pi) * float(np.sum(q * q)) * units.COULOMB,
            e_neutral=-np.pi / (2.0 * beta ** 2 * volume) * float(np.sum(q)) ** 2 * units.COULOMB,
            lj_tail_a=_lj_tail_coefficient(np.asarray(top.sigmas, np.float64),
                                           np.asarray(top.epsilons, np.float64) * KCAL, cutoff),
            spline_mod2=f(euler_spline_mod2(grid[0])[:, None, None]
                          * euler_spline_mod2(grid[1])[None, :, None]
                          * euler_spline_mod2(grid[2])[None, None, :]),
            polarization=polarization, **cmap,
        )


def _lj_tail_coefficient(sigma: np.ndarray, eps: np.ndarray, cutoff: float) -> float:
    """A such that U_tail = A / V (eV): the analytic correction for
    truncating 4 eps ((s/r)^12 - (s/r)^6) at rc with g(r) = 1, Lorentz-
    Berthelot mixing, summed over unique (sigma, eps) types
    (``mm.py:168-193``)."""
    types, counts = np.unique(np.stack([sigma, eps], axis=1), axis=0, return_counts=True)
    s_t, e_t = types[:, 0], types[:, 1]
    n_t = counts.astype(np.float64)
    sij = 0.5 * (s_t[:, None] + s_t[None, :])
    eij = np.sqrt(e_t[:, None] * e_t[None, :])
    per_pair = 4.0 * eij * (sij ** 12 / (9.0 * cutoff ** 9) - sij ** 6 / (3.0 * cutoff ** 3))
    pair_count = n_t[:, None] * n_t[None, :]
    # remove the i == j self terms from the diagonal type blocks
    total = np.sum(pair_count * per_pair) - np.sum(n_t * np.diag(per_pair))
    return float(2.0 * np.pi * total)


def cmap_bicubic_coeffs(grids: np.ndarray) -> np.ndarray:
    """Periodic bicubic (Hermite) coefficients [T,R,R,4,4] of CMAP grids
    [T,R,R] (kcal/mol, phi-major, grid point g at -180 + g * 360 / R deg),
    node derivatives from centred differences (``mm.py:196-247``): cell
    (i, j) evaluates E(t, u) = sum_{m,n} C[i,j,m,n] t^m u^n."""
    grids = np.asarray(grids, np.float64)
    if grids.size == 0:
        return np.zeros((0, 0, 0, 4, 4))
    f = grids
    fp = (np.roll(f, -1, axis=1) - np.roll(f, 1, axis=1)) / 2.0      # d/dphi
    fs = (np.roll(f, -1, axis=2) - np.roll(f, 1, axis=2)) / 2.0      # d/dpsi
    fps = (np.roll(fp, -1, axis=2) - np.roll(fp, 1, axis=2)) / 2.0   # cross

    def corners(a):
        a10 = np.roll(a, -1, axis=1)
        a01 = np.roll(a, -1, axis=2)
        return a, a10, a01, np.roll(a10, -1, axis=2)

    f00, f10, f01, f11 = corners(f)
    p00, p10, p01, p11 = corners(fp)
    s00, s10, s01, s11 = corners(fs)
    x00, x10, x01, x11 = corners(fps)
    F = np.stack([
        np.stack([f00, f01, s00, s01], axis=-1),
        np.stack([f10, f11, s10, s11], axis=-1),
        np.stack([p00, p01, x00, x01], axis=-1),
        np.stack([p10, p11, x10, x11], axis=-1),
    ], axis=-2)                                                       # [T,R,R,4,4]
    B = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [-3, 3, -2, -1], [2, -2, 1, 1]], np.float64)
    return np.einsum("mi,tpqij,nj->tpqmn", B, F, B)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _safe_norm(v, eps=1e-12):
    d2 = (v * v).sum(-1)
    nz = d2 > eps
    return torch.where(nz, torch.sqrt(torch.where(nz, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def _safe_unit(v, eps=1e-12):
    d2 = (v * v).sum(-1, keepdim=True)
    nz = d2 > eps
    return v * torch.where(nz, torch.rsqrt(torch.where(nz, d2, torch.ones_like(d2))),
                           torch.zeros_like(d2))


def _dihedral_angle(p0, p1, p2, p3, cell):
    """Signed dihedral in (-pi, pi] (the convention of ``bonded_energy``)."""
    v0 = _pbc_diff(p1 - p2, cell)
    v1 = _pbc_diff(p1 - p0, cell)
    v2 = _pbc_diff(p3 - p2, cell)
    n1 = _safe_unit(_cross(v1, v0))
    n2 = _safe_unit(_cross(v0, v2))
    m1 = _cross(n1, _safe_unit(v0))
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    ok = (x * x + y * y) > 1e-12
    return torch.atan2(torch.where(ok, y, torch.zeros_like(y)),
                       torch.where(ok, x, torch.ones_like(x)))


def cmap_energy(mm: MMSystem, P: torch.Tensor, cell=None) -> torch.Tensor:
    """ff19SB CMAP: bicubic-interpolated E(phi, psi) per term (``mm.py:
    266-293``); the spline is C1, so forces are continuous across cells."""
    cell = mm.cell if cell is None else cell
    a = mm.cmap_atoms
    R = mm.cmap_coeffs.shape[1]
    phi = _dihedral_angle(P[a[:, 0]], P[a[:, 1]], P[a[:, 2]], P[a[:, 3]], cell)
    psi = _dihedral_angle(P[a[:, 1]], P[a[:, 2]], P[a[:, 3]], P[a[:, 4]], cell)

    def locate(angle):
        x = (angle + math.pi) * (R / (2.0 * math.pi))
        xi = torch.floor(x)
        return torch.remainder(xi.long(), R), x - xi

    gi, t = locate(phi)
    gj, u = locate(psi)
    C = mm.cmap_coeffs[mm.cmap_type, gi, gj]                 # [M,4,4]
    tp = torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1)
    up = torch.stack([torch.ones_like(u), u, u * u, u * u * u], dim=-1)
    return torch.einsum("mij,mi,mj->", C, tp, up)


def bonded_energy(mm: MMSystem, P: torch.Tensor, cell=None) -> torch.Tensor:
    """Bonds, angles, dihedrals (proper and improper) and CMAP (``mm.py:
    309-338``)."""
    cell = mm.cell if cell is None else cell
    e = torch.zeros((), dtype=P.dtype, device=P.device)
    if mm.bonds.shape[0]:
        d = _safe_norm(_pbc_diff(P[mm.bonds[:, 0]] - P[mm.bonds[:, 1]], cell))
        e = e + (mm.bond_k * (d - mm.bond_r0) ** 2).sum()
    if mm.angles.shape[0]:
        v0 = _pbc_diff(P[mm.angles[:, 0]] - P[mm.angles[:, 1]], cell)
        v1 = _pbc_diff(P[mm.angles[:, 2]] - P[mm.angles[:, 1]], cell)
        theta = torch.atan2(_safe_norm(_cross(v0, v1)), (v0 * v1).sum(-1))
        e = e + (mm.angle_k * (theta - mm.angle_t0) ** 2).sum()
    if mm.dihedrals.shape[0]:
        d = mm.dihedrals
        phi = _dihedral_angle(P[d[:, 0]], P[d[:, 1]], P[d[:, 2]], P[d[:, 3]], cell)
        e = e + (mm.dih_k * (1.0 + torch.cos(mm.dih_n * phi - mm.dih_phase))).sum()
    if mm.cmap_atoms is not None and mm.cmap_atoms.shape[0]:
        e = e + cmap_energy(mm, P, cell)
    return e


def _pair_terms(mm: MMSystem, P: torch.Tensor, pairs: torch.Tensor, cell=None):
    """(qq/r Coulomb, LJ) of an explicit pair list, minimum image."""
    cell = mm.cell if cell is None else cell
    i, j = pairs[:, 0], pairs[:, 1]
    d = torch.clamp(_safe_norm(_pbc_diff(P[i] - P[j], cell)), min=1e-3)
    coul = units.COULOMB * mm.charge[i] * mm.charge[j] / d
    sig = 0.5 * (mm.sigma[i] + mm.sigma[j])
    eps = torch.sqrt(mm.eps[i] * mm.eps[j])
    c6 = (sig / d) ** 6
    return coul, 4.0 * eps * (c6 * c6 - c6)


def dynamic_influence(mm: MMSystem, cell: torch.Tensor):
    """(influence [Kx,Ky,Kz], neutralizing energy) of the fixed mesh in a
    dynamic cell (NPT; ``mm.py:338-357``), on the device: the mesh sizes are
    Python ints and the splines' moduli ``mm.spline_mod2``, so nothing is
    copied from the host."""
    ms = [torch.fft.fftfreq(K, dtype=cell.dtype, device=cell.device) * K / cell[d]
          for d, K in enumerate(mm.grid)]
    MX, MY, MZ = torch.meshgrid(*ms, indexing="ij")
    m2 = MX ** 2 + MY ** 2 + MZ ** 2
    volume = cell[0] * cell[1] * cell[2]
    m2_safe = torch.where(m2 > 0, m2, torch.ones_like(m2))
    infl = torch.where(m2 > 0, torch.exp(-math.pi ** 2 * m2_safe / mm.beta ** 2) / m2_safe
                       * mm.spline_mod2, torch.zeros_like(m2)) / (2.0 * math.pi * volume)
    e_neutral = (-math.pi / (2.0 * mm.beta ** 2 * volume) * mm.charge.sum() ** 2
                 * units.COULOMB)
    return infl, e_neutral


def _recip_excl_energy(mm: MMSystem, P: torch.Tensor, cell=None) -> torch.Tensor:
    """PME reciprocal + self / neutral + LJ tail + exclusion and 1-4
    corrections (``mm.py:569-591``); ``cell`` None is the static box."""
    if cell is None:
        cell, influence, e_neutral = mm.cell, mm.influence, mm.e_neutral
    else:
        influence, e_neutral = dynamic_influence(mm, cell)
    e = (mesh_energy(influence, spread(mm.charge, P, cell, mm.grid)) * units.COULOMB
         + mm.e_self + e_neutral + mm.lj_tail_a / (cell[0] * cell[1] * cell[2]))
    if mm.excl_pairs.shape[0]:
        coul, lj = _pair_terms(mm, P, mm.excl_pairs, cell)
        e = e - coul.sum() - lj.sum()
    if mm.pairs14.shape[0]:
        coul, lj = _pair_terms(mm, P, mm.pairs14, cell)
        e = e - coul.sum() * (1.0 - 1.0 / mm.scee) - lj.sum() * (1.0 - 1.0 / mm.scnb)
    return e


def smooth_energy_forces(mm: MMSystem, P: torch.Tensor, cell=None):
    """(E, F) of the bonded, reciprocal and exclusion terms by autograd."""
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = bonded_energy(mm, p, cell) + _recip_excl_energy(mm, p, cell)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


def smooth_strain_derivative(mm: MMSystem, P: torch.Tensor, cell: torch.Tensor):
    """dU/ds at s = 1 of the bonded, reciprocal and exclusion terms with the
    positions and the cell scaled by s (the strain derivative of
    ``mm_pressure_dense``, by autograd in s)."""
    with torch.enable_grad():
        s = torch.ones((), dtype=P.dtype, device=P.device, requires_grad=True)
        Ps, cs = P.detach() * s, cell * s
        e = bonded_energy(mm, Ps, cs) + _recip_excl_energy(mm, Ps, cs)
        (g,) = torch.autograd.grad(e, s)
    return g


def pair_block(d: list, m: torch.Tensor, qi, qj, si, sj, ei, ej, beta: float, cutoff: float):
    """erfc-Coulomb + LJ of one block of pairs with analytic forces
    (``mm.py:497-528``; the cell-bucket path shares it).

    ``d`` = [dx, dy, dz], each [..., I, J]: minimum-image P_j - P_i; ``m``
    [..., I, J] marks the real pairs (both atoms present, i != j); the
    per-atom parameters broadcast against it (i side [..., I, 1], j side
    [..., 1, J]).  Returns (E summed over the block, F_i [..., I, 3] =
    sum_j phi'(r)/r (P_j - P_i), sum of phi'(r) r over the block)."""
    dx, dy, dz = d
    d2 = dx * dx + dy * dy + dz * dz
    m = m & (d2 < cutoff * cutoff)
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    d2s = torch.where(m, d2, torch.ones((), dtype=d2.dtype, device=d2.device))
    inv2 = 1.0 / d2s
    r = torch.sqrt(d2s)
    inv_r = r * inv2
    qq = units.COULOMB * qi * qj
    erfc = torch.special.erfc(beta * r)
    eps = 4.0 * torch.sqrt(ei * ej)
    sig = 0.5 * (si + sj)
    c6 = (sig * sig * inv2) ** 3
    e = torch.where(m, qq * erfc * inv_r + eps * (c6 * c6 - c6), zero).sum()
    two_beta_rpi = 2.0 * beta / math.sqrt(math.pi)
    dphi = (qq * (-erfc * inv2 - two_beta_rpi * torch.exp(-beta * beta * d2s) * inv_r)
            + eps * (6.0 * c6 - 12.0 * c6 * c6) * inv_r)
    C = torch.where(m, dphi * inv_r, zero)                 # phi'(r) / r
    f = torch.stack([(C * dx).sum(-1), (C * dy).sum(-1), (C * dz).sum(-1)], dim=-1)
    return e, f, (C * d2s).sum()


def dense_pair_energy_forces(mm: MMSystem, P: torch.Tensor, cell=None, tile: int = 512):
    """erfc-Coulomb + LJ over ALL pairs in [tile, N] blocks (``mm.py:
    473-531``): no neighbour list; each atom sums its own row of the full
    symmetric pair matrix, so no scatter.  Returns (E, F, W) with E and W
    half-sums over the full pair matrix (W = sum of phi'(r) r, the pair
    virial).  ``tile`` bounds the intermediates (a dozen [tile, N] tensors
    live at once); JAX takes 2048."""
    cell = mm.cell if cell is None else cell
    n = P.shape[0]
    cols = torch.arange(n, device=P.device)
    es, fs, ws = [], [], []
    with torch.no_grad():
        for start in range(0, n, tile):
            stop = min(start + tile, n)
            d = [_pbc_diff(P[None, :, a] - P[start:stop, a, None], cell[a]) for a in range(3)]
            rows = torch.arange(start, stop, device=P.device)
            e, f, w = pair_block(d, cols[None, :] != rows[:, None],
                                 mm.charge[start:stop, None], mm.charge[None, :],
                                 mm.sigma[start:stop, None], mm.sigma[None, :],
                                 mm.eps[start:stop, None], mm.eps[None, :], mm.beta, mm.cutoff)
            es.append(e)
            fs.append(f)
            ws.append(w)
    return 0.5 * torch.stack(es).sum(), torch.cat(fs), 0.5 * torch.stack(ws).sum()


def mm_energy_forces_dense(mm: MMSystem, P: torch.Tensor, cell=None, tile: int = 512):
    """(E, F) with the dense direct-space path (``mm.py:534-558``): bonded,
    PME reciprocal and exclusion corrections by autograd, the pairs
    analytic."""
    e, f, _ = mm_energy_forces_virial_dense(mm, P, cell, tile)
    return e, f


def mm_energy_forces_virial_dense(mm: MMSystem, P: torch.Tensor, cell=None, tile: int = 512):
    """(E, F, W): ``mm_energy_forces_dense`` and the pair virial W of its
    pair pass, which ``pressure`` takes, so that an NPT step needs no second
    pair pass (``mm_pressure_dense`` re-evaluates the pairs at the same
    positions and cell: the same W)."""
    if mm.polarization is not None:
        raise ValueError("dense path does not support the legacy polarization hybrid; use "
                         "mm_backend='amoeba' for polarizable MM")
    e_s, f_s = smooth_energy_forces(mm, P, cell)
    e_p, f_p, w = dense_pair_energy_forces(mm, P, cell, tile)
    return e_s + e_p, f_p + f_s, w


def pressure(mm: MMSystem, P: torch.Tensor, cell: torch.Tensor, kinetic_energy, w_pair):
    """Instantaneous isotropic pressure (eV/A^3), (2 K - dU_smooth/ds - W) /
    (3 V), from the dense pair pass's virial ``w_pair`` at (P, cell)."""
    du_smooth = smooth_strain_derivative(mm, P, cell)
    return (2.0 * kinetic_energy - du_smooth - w_pair) / (3.0 * cell[0] * cell[1] * cell[2])


def mm_pressure_dense(mm: MMSystem, P: torch.Tensor, cell: torch.Tensor, kinetic_energy,
                      tile: int = 512):
    """Instantaneous pressure on the dense path (``mm.py:561-574``): the pair
    virial sum(phi'(r) r) from the tiled pairs, the bonded and reciprocal
    terms through the strain derivative."""
    _, _, w_pair = dense_pair_energy_forces(mm, P, cell, tile)
    return pressure(mm, P, cell, kinetic_energy, w_pair)


def nonbonded_nl_energy(mm: MMSystem, P: torch.Tensor, nl: NeighborList,
                        cell=None) -> torch.Tensor:
    """Neighbour-list LJ + erfc-Coulomb (each pair twice, halved) + PME
    reciprocal and exclusion terms (``mm.py:351-393``)."""
    pad = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    vec = _pbc_diff(gather_rows(pad(P), nl.idx) - P[:, None, :], mm.cell if cell is None else cell)
    d2 = (vec * vec).sum(-1)
    valid = nl.valid & (d2 < mm.cutoff ** 2)
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    d2 = torch.where(valid, d2, torch.ones_like(d2))
    d = torch.sqrt(d2)
    qq = mm.charge[:, None] * pad(mm.charge)[nl.idx]
    e_coul = 0.5 * torch.where(
        valid, units.COULOMB * qq * torch.special.erfc(mm.beta * d) / d, zero).sum()
    sig = 0.5 * (mm.sigma[:, None] + pad(mm.sigma)[nl.idx])
    eps = torch.sqrt(mm.eps[:, None] * pad(mm.eps)[nl.idx])
    c6 = (sig * sig / d2) ** 3
    e_lj = 0.5 * torch.where(valid, 4.0 * eps * (c6 * c6 - c6), zero).sum()
    return e_coul + e_lj + _recip_excl_energy(mm, P, cell)


def mm_energy(mm: MMSystem, P: torch.Tensor, nl: NeighborList, cell=None) -> torch.Tensor:
    """Bonded + nonbonded over the list, + the polarization hybrid when
    ``mm.polarization`` is set (``mm.py:600-608``)."""
    e = bonded_energy(mm, P, cell) + nonbonded_nl_energy(mm, P, nl, cell)
    if mm.polarization is not None:
        e = e + polarization_energy(mm.polarization, P, nl, mm.cell if cell is None else cell)
    return e


def nl_pair_energy_forces(mm: MMSystem, P: torch.Tensor, nl: NeighborList, cell=None):
    """erfc-Coulomb + LJ over the list with analytic pair forces
    (``pair_block`` on [N, K] planes): the list is full, so every atom sums
    its own row, in a fixed order, and E is half the sum.  Returns (E, F)."""
    cell = mm.cell if cell is None else cell
    pad = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    with torch.no_grad():
        Pj = gather_rows(pad(P), nl.idx)
        d = [_pbc_diff(Pj[..., a] - P[:, a, None], cell[a]) for a in range(3)]
        j = lambda a: gather_rows(pad(a), nl.idx)
        e, f, _ = pair_block(d, nl.valid, mm.charge[:, None], j(mm.charge), mm.sigma[:, None],
                             j(mm.sigma), mm.eps[:, None], j(mm.eps), mm.beta, mm.cutoff)
    return 0.5 * e, f


def mm_energy_forces(mm: MMSystem, P: torch.Tensor, nl: NeighborList, cell=None):
    """(E, F) of ``mm_energy`` (the ``nl`` route): the pairs analytic
    (``nl_pair_energy_forces``), the bonded, reciprocal and exclusion terms
    and the polarization hybrid by autograd.  JAX differentiates the whole
    energy (``mm.py:611-613``); the gradient is the same, and a gather's
    backward would scatter over the list in no fixed order on CUDA."""
    e_s, f_s = smooth_energy_forces(mm, P, cell)
    e_p, f_p = nl_pair_energy_forces(mm, P, nl, cell)
    e, f = e_s + e_p, f_s + f_p
    if mm.polarization is not None:
        e_pol, f_pol = polarization_energy_forces(mm.polarization, P, nl,
                                                  mm.cell if cell is None else cell)
        e, f = e + e_pol, f + f_pol
    return e, f


def mm_pressure(mm: MMSystem, P: torch.Tensor, nl: NeighborList, cell: torch.Tensor,
                kinetic_energy):
    """Instantaneous isotropic pressure on the ``nl`` route (``mm.py:
    616-625``): P = (2 K - dU/d(ln s)) /
    (3 V), s the uniform scale of positions and cell, by autograd in s."""
    with torch.enable_grad():
        s = torch.ones((), dtype=P.dtype, device=P.device, requires_grad=True)
        (du,) = torch.autograd.grad(mm_energy(mm, P.detach() * s, nl, cell * s), s)
    return (2.0 * kinetic_energy - du) / (3.0 * cell[0] * cell[1] * cell[2])
