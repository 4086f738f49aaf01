"""Intra-protein long-range nonbonded terms (fragment "mm" mode).

Port of ``ai2bmd_tpu/physics/nonbonded.py:26-66``: LJ + bare Coulomb over the
exclusion complement (all pairs except same-dipeptide pairs) as one dense
masked [N,N] tensor program, forces by autograd of the energy.

Units: positions A, charges e, sigma A, epsilon eV; energy eV.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.host import Protein, units
from ai2bmd_torch.utils.device import resolve_device


@dataclasses.dataclass
class NonbondedParams:
    sigma: torch.Tensor    # [N] A
    eps: torch.Tensor      # [N] eV
    charge: torch.Tensor   # [N] e
    mask: torch.Tensor     # [N,N] bool: i != j and not same-dipeptide

    @classmethod
    def build(cls, prot: Protein, exclusion_mask: np.ndarray, device=None,
              dtype=torch.float32) -> "NonbondedParams":
        """``device`` None means the card (raises without one)."""
        device = resolve_device(device)
        n = len(prot)
        pair = ~np.eye(n, dtype=bool) & ~exclusion_mask
        # rounded through float32 like the reference's tables
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
        return cls(
            sigma=f(prot.sigmas),
            eps=f(prot.epsilons * units.kcal_per_mol),
            charge=f(prot.charges),
            mask=torch.as_tensor(pair, device=device),
        )


def nonbonded_energy(nb: NonbondedParams, P: torch.Tensor) -> torch.Tensor:
    """0.5 * sum over ordered pairs of LJ + Coulomb (eV); P [N,3] -> scalar,
    or [Rl,N,3] -> [Rl] for a leading replica axis."""
    vec = P[..., None, :, :] - P[..., :, None, :]
    d2 = torch.where(nb.mask, (vec * vec).sum(-1), torch.ones((), dtype=P.dtype, device=P.device))
    sig = 0.5 * (nb.sigma[:, None] + nb.sigma[None, :])
    eps = torch.sqrt(nb.eps[:, None] * nb.eps[None, :])
    c6 = (sig * sig / d2) ** 3
    e_lj = 4.0 * eps * (c6 * c6 - c6)
    e_coul = units.COULOMB * nb.charge[:, None] * nb.charge[None, :] * torch.rsqrt(d2)
    return 0.5 * torch.where(nb.mask, e_lj + e_coul, torch.zeros_like(d2)).sum((-2, -1))


def nonbonded_energy_forces(nb: NonbondedParams, P: torch.Tensor):
    """(E, F) for P [N,3] or [Rl,N,3] (E [Rl], F [Rl,N,3])."""
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = nonbonded_energy(nb, p)
        (g,) = torch.autograd.grad(e.sum(), p)
    return e.detach(), -g
