"""Restraint force terms (the reference's ASE Hookean constraints) as torch
functions.

Port of ``ai2bmd_tpu/md/constraints.py``.  The reference uses ASE Hookean
constraints two ways (simulator.py:139-180):
  * pre-equilibration ladder: per-atom tethers to reference positions with
    spring constants [10, 5, 1, 0.5, 0.1] kcal/mol/A^2 (rt = 0):
    ``TetherRestraint`` (the ``Simulator`` keeps its own tether, buffers that
    one captured step reads, and does not call it);
  * hydrogen-bond restraints: pairwise springs engaging beyond a threshold
    length (k = 15 eV/A^2, rt = covalent length + 0.2 A, reference
    utils.py:201-221): ``BondRestraint``, an additive term of the stepped
    potential.
Forces come from autograd (``restraint_energy_forces``); ``with_restraints``
adds any of them to a potential.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ai2bmd_torch.utils.device import resolve_device


@dataclasses.dataclass
class TetherRestraint:
    """E = 0.5 k sum_i |x_i - x0_i|^2 over selected atoms."""

    reference: torch.Tensor   # [N,3]
    k: torch.Tensor | float   # scalar eV/A^2
    weight: torch.Tensor      # [N,1] selection mask

    def energy(self, P: torch.Tensor) -> torch.Tensor:
        d = (P - self.reference) * self.weight
        return 0.5 * self.k * (d * d).sum()


@dataclasses.dataclass
class BondRestraint:
    """Pairwise one-sided springs: E = 0.5 k (|d| - rt)^2 for |d| > rt."""

    pairs: torch.Tensor   # [M,2] int64
    rt: torch.Tensor      # [M]
    k: torch.Tensor       # [M]

    @classmethod
    def find_hydrogen_bonds(cls, atoms, k: float = 15.0, slack: float = 0.2,
                            device=None) -> "BondRestraint":
        """Covalent-radius-based H-bond finder (reference utils.py:169-221):
        each hydrogen is paired with every atom within r_cov(H) + r_cov(X) +
        slack.  ``device`` None means the card (raises without one)."""
        device = resolve_device(device)
        radii = {1: 0.31, 6: 0.76, 7: 0.71, 8: 0.66, 15: 1.07, 16: 1.05}
        pos = atoms.positions
        z = atoms.numbers
        h_idx = np.flatnonzero(z == 1)
        pairs, rts = [], []
        for i in h_idx:
            for j in range(len(z)):
                if i == j:
                    continue
                ideal = radii.get(1, 0) + radii.get(int(z[j]), 0)
                if np.linalg.norm(pos[i] - pos[j]) <= ideal + slack:
                    pairs.append((i, j))
                    rts.append(ideal + slack)
        if len(pairs) != len(h_idx):
            raise AssertionError(
                f"hydrogen constraint mismatch: {len(h_idx)} hydrogens vs "
                f"{len(pairs)} covalent bonds found"
            )
        return cls(
            pairs=torch.as_tensor(np.array(pairs, dtype=np.int64), device=device),
            rt=torch.as_tensor(np.array(rts, dtype=np.float32), device=device),
            k=torch.full((len(pairs),), k, dtype=torch.float32, device=device),
        )

    def energy(self, P: torch.Tensor) -> torch.Tensor:
        d = P[self.pairs[:, 0]] - P[self.pairs[:, 1]]
        dist = torch.sqrt((d * d).sum(-1) + 1e-12)
        over = torch.clamp(dist - self.rt, min=0.0)
        return 0.5 * (self.k * over * over).sum()


def restraint_energy_forces(restraint, P: torch.Tensor):
    """(E, F) of one restraint at P, F = -dE/dP by autograd."""
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = restraint.energy(p)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


def with_restraints(potential, restraints):
    """Wrap a potential ``P -> (E, F)`` with additive restraint terms, each
    restraint's forces by autograd."""
    if not restraints:
        return potential

    def wrapped(P):
        e, f = potential(P)
        for r in restraints:
            er, fr = restraint_energy_forces(r, P)
            e = e + er
            f = f + fr
        return e, f

    return wrapped
