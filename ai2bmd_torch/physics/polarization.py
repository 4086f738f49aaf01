"""Induced point-dipole polarization on fixed charges (the hybrid).

Port of ``ai2bmd_tpu/physics/polarization.py``: an optional term on top of
the fixed-charge MM engine, on its ``nl`` pair route (``physics/mm.py``
``mm_energy``), for the reference's solvent with mutual dipole polarization
(src/Calculators/tinker_async.py:127-145: ``polarization mutual``):

  * isotropic polarizabilities by element (Thole / AMOEBA values);
  * the permanent field of the point charges with Thole damping over the
    [N, K] list, the 1-2 / 1-3 pairs taken out;
  * mutual induction by a fixed number of SOR sweeps (``n_iter``), so the
    step has a fixed shape;
  * the energy of the variational functional U[mu] = 1/2 mu a^-1 mu - mu.E0
    - 1/2 mu.T.mu at the converged dipoles held fixed (computed without a
    graph): at the fixed point dU/dmu = 0, so the gradient in the positions
    at fixed mu is the force up to the residual.

Units: positions A, energy eV.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.ops.neighbors import NeighborList, _pbc_diff, gather_rows
from ai2bmd_torch.utils.device import resolve_device

# Thole / AMOEBA isotropic polarizabilities (A^3) by atomic number
POLARIZABILITY = {1: 0.496, 6: 1.334, 7: 1.073, 8: 0.837, 11: 0.120, 15: 1.828, 16: 2.800,
                  17: 4.000}
THOLE_A = 0.39  # AMOEBA damping coefficient


@dataclasses.dataclass
class PolarizationParams:
    alpha: torch.Tensor            # [N] A^3
    charge: torch.Tensor           # [N] e
    excl_mask_pairs: torch.Tensor  # [M,2] 1-2 / 1-3 pairs masked from the permanent field
    n_iter: int = 4
    sor: float = 0.7
    cutoff: float = 9.0

    @classmethod
    def build(cls, numbers: np.ndarray, charges: np.ndarray, excl_pairs: np.ndarray,
              cutoff: float = 9.0, n_iter: int = 4, device=None,
              dtype=torch.float32) -> "PolarizationParams":
        """``polarization.py:62-74``; the tables rounded through float32 as
        JAX's are, then held in ``dtype``.  ``device`` None means the card."""
        device = resolve_device(device)
        alpha = np.array([POLARIZABILITY.get(int(z), 1.0) for z in numbers])
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
        return cls(alpha=f(alpha), charge=f(charges),
                   excl_mask_pairs=torch.as_tensor(np.asarray(excl_pairs, np.int64).reshape(-1, 2),
                                                   device=device),
                   n_iter=n_iter, cutoff=cutoff)


def _thole_factors(r, alpha_i, alpha_j):
    """Thole damping (lambda3, lambda5) of the damped T tensors."""
    aa = (alpha_i * alpha_j) ** (1.0 / 6.0)
    u = r / torch.clamp(aa, min=1e-6)
    expu = torch.exp(-THOLE_A * u ** 3)
    return 1.0 - expu, 1.0 - (1.0 + THOLE_A * u ** 3) * expu


def _pad(a):
    return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])


def _pair_geometry(pol: PolarizationParams, P, nl: NeighborList, cell):
    vec = _pbc_diff(gather_rows(_pad(P), nl.idx) - P[:, None, :], cell)      # r_j - r_i
    d2 = (vec * vec).sum(-1)
    valid = nl.valid & (d2 < pol.cutoff ** 2)
    d2 = torch.where(valid, d2, torch.ones_like(d2))
    inv_r3 = torch.rsqrt(d2) / d2
    aj = torch.cat([pol.alpha, pol.alpha.new_ones(1)])[nl.idx]
    lam3, lam5 = _thole_factors(torch.sqrt(d2), pol.alpha[:, None], aj)
    return vec, d2, inv_r3, valid, lam3, lam5


def permanent_field(pol: PolarizationParams, P, nl: NeighborList, cell):
    """Damped field at each atom from all point charges, eV/(e A), the 1-2 /
    1-3 pairs removed (``polarization.py:100-121``)."""
    vec, _, inv_r3, valid, lam3, _ = _pair_geometry(pol, P, nl, cell)
    qj = _pad(pol.charge)[nl.idx]
    contrib = -(qj * lam3 * inv_r3)[..., None] * vec               # E_i = -sum_j q_j vec / r^3
    contrib = torch.where(valid[..., None], contrib, torch.zeros_like(contrib))
    E0 = units.COULOMB * contrib.sum(1)
    if pol.excl_mask_pairs.shape[0]:
        i, j = pol.excl_mask_pairs[:, 0], pol.excl_mask_pairs[:, 1]
        v = _pbc_diff(P[j] - P[i], cell)
        d2e = torch.clamp((v * v).sum(-1), min=1e-6)
        inv3 = d2e ** -1.5
        lam3e, _ = _thole_factors(torch.sqrt(d2e), pol.alpha[i], pol.alpha[j])
        corr_i = -(pol.charge[j] * lam3e * inv3)[:, None] * v
        corr_j = (pol.charge[i] * lam3e * inv3)[:, None] * v
        E0 = E0.index_add(0, i, -units.COULOMB * corr_i).index_add(0, j, -units.COULOMB * corr_j)
    return E0


def dipole_field(pol: PolarizationParams, P, mu, nl: NeighborList, cell):
    """Thole-damped field at each atom from all induced dipoles
    (``polarization.py:124-135``)."""
    vec, d2, inv_r3, valid, lam3, lam5 = _pair_geometry(pol, P, nl, cell)
    muj = gather_rows(_pad(mu), nl.idx)
    mu_dot_r = (muj * vec).sum(-1)
    contrib = ((3.0 * lam5 * mu_dot_r / d2)[..., None] * vec * inv_r3[..., None]
               - (lam3 * inv_r3)[..., None] * muj)
    contrib = torch.where(valid[..., None], contrib, torch.zeros_like(contrib))
    return units.COULOMB * contrib.sum(1)


def induce_dipoles(pol: PolarizationParams, P, nl: NeighborList, cell):
    """Fixed-iteration SOR mutual induction; (mu [N,3], E0)
    (``polarization.py:138-152``)."""
    E0 = permanent_field(pol, P, nl, cell)
    alpha = pol.alpha[:, None] / units.COULOMB
    mu = alpha * E0
    for _ in range(pol.n_iter):
        mu_new = alpha * (E0 + dipole_field(pol, P, mu, nl, cell))
        mu = (1.0 - pol.sor) * mu + pol.sor * mu_new
    return mu, E0


def polarization_energy(pol: PolarizationParams, P, nl: NeighborList, cell):
    """The variational energy at the converged dipoles, held fixed
    (``polarization.py:155-164``; JAX's ``stop_gradient``): the SOR sweeps
    run without a graph, the permanent and dipole fields with one."""
    with torch.no_grad():
        mu, _ = induce_dipoles(pol, P.detach(), nl, cell)
    E0 = permanent_field(pol, P, nl, cell)
    alpha = pol.alpha[:, None] / units.COULOMB
    self_e = 0.5 * (mu * mu / torch.clamp(alpha, min=1e-9)).sum()
    return self_e - (mu * E0).sum() - 0.5 * (mu * dipole_field(pol, P, mu, nl, cell)).sum()


def polarization_energy_forces(pol: PolarizationParams, P, nl: NeighborList, cell):
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = polarization_energy(pol, p, nl, cell)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g
