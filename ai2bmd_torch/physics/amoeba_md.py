"""Pure-AMOEBA periodic MD and minimization.

Port of ``ai2bmd_tpu/physics/amoeba_md.py``: the in-framework counterpart of
the reference's Tinker runs with the whole AMOEBA force field
(src/utils/preprocess.py:184-244, pdbxyz8 + minimize9;
src/Calculators/tinker_async.py:127-145, ``parameters amoebabio18.prm``).
One differentiable potential of a periodic protein + water system:

    E = E_nonbonded (physics/amoeba_system.py: permanent SPME multipoles,
        mutual induction, buffered 14-7)
      + E_valence   (physics/amoeba_valence.py)

The induction is the unrolled full-Ewald PCG (``induction="ewald"``, its
gradient through the iterations) or real-space SOR (``"sor"``).  The [N, K]
list within cutoff + skin is the potential's carry, rebuilt on every call
(``ops/neighbors.rebuild``, its overflow flag sticky), where JAX rebuilds it
under ``lax.cond`` once an atom has moved half the skin: the pair set within
the cutoff is the same, and a captured step needs no branch on device data.

Drivers: ``minimize``, steepest descent with backtracking, one cycle (two
evaluations) a captured step on the card (``md/graphed.GraphedStep``) with
nothing read back inside a chunk; ``make_step_fn``, Langevin steps as
replays of one captured step (``GraphedLangevin``), the port's idiom for
JAX's ``lax.scan``; ``initial_state`` draws the velocities from an explicit
``torch.Generator``, JAX's PRNG key.  On the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.data.protein_topology import build_topology
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.md.graphed import GraphedLangevin, stepper
from ai2bmd_torch.ops import neighbors as NL
from ai2bmd_torch.physics.amoeba_protein import assign_amoeba
from ai2bmd_torch.physics.amoeba_system import AmoebaPeriodicSystem
from ai2bmd_torch.physics.amoeba_valence import AmoebaValence, resolve_chirality_signs
from ai2bmd_torch.utils.device import resolve_device
from ai2bmd_torch.utils.tree import tree_copy_


@dataclasses.dataclass
class AmoebaMD:
    """The whole AMOEBA potential of one periodic system (protein + water),
    ``amoeba_md.py:41-183``."""

    sys: AmoebaPeriodicSystem
    val: AmoebaValence
    cell: torch.Tensor
    cutoff: float
    skin: float
    k_max: int
    cg_iters: int
    induction: str            # "ewald" | "sor"
    masses: np.ndarray
    nl_grid: tuple | None = None          # (nc, max_occ) of the cell build, or None (dense)
    nbr_cells: torch.Tensor | None = None
    _descent: tuple | None = None         # the minimizer's (buffers, step) once built

    @classmethod
    def build(cls, atoms: PDBAtoms, cutoff: float = 9.0, skin: float = 1.0,
              induction: str = "ewald", cg_iters: int = 12, sor_iters: int = 8,
              grid_spacing: float = 0.9, beta: float | None = None, device=None,
              dtype=torch.float32, table_dtype=np.float32) -> "AmoebaMD":
        """Assign the AMOEBA terms from names and bonds.  beta defaults to
        3.6 / cutoff, so that erfc(beta r) at the cutoff (3.6e-7) makes every
        cutoff crossing negligible.  The nonbonded tables are rounded through
        ``table_dtype`` and held in ``dtype`` (``AmoebaPeriodicSystem.
        build``); the valence tables are float32.  ``device`` None means the
        card (raises without one)."""
        if atoms.cell is None:
            raise ValueError("pure-AMOEBA MD needs a periodic cell (CRYST1)")
        if induction not in ("ewald", "sor"):
            raise ValueError(f"unknown induction {induction!r}")
        device = resolve_device(device)
        if beta is None:
            beta = 3.6 / cutoff
        top = build_topology(atoms)
        asg = assign_amoeba(atoms.atom_names, atoms.residue_names, atoms.positions, top.bonds)
        sys_ = AmoebaPeriodicSystem.build(asg, atoms.cell, cutoff=cutoff, sor_iters=sor_iters,
                                          grid_spacing=grid_spacing, beta=beta, device=device,
                                          dtype=dtype, table_dtype=table_dtype)
        val = resolve_chirality_signs(AmoebaValence.build(asg, device=device), atoms.positions,
                                      asg.bonds)
        nl_grid, nbr_cells = NL.cell_plan(atoms.cell, atoms.positions, cutoff + skin, device)
        return cls(sys=sys_, val=val,
                   cell=torch.as_tensor(np.asarray(atoms.cell, np.float32), dtype=dtype,
                                        device=device),
                   cutoff=cutoff, skin=skin, k_max=_k_for(cutoff + skin), cg_iters=cg_iters,
                   induction=induction, masses=np.asarray(top.masses, np.float64),
                   nl_grid=nl_grid, nbr_cells=nbr_cells)

    # -- the potential, its carry the neighbour list --------------------------
    def build_list(self, P: torch.Tensor) -> NL.NeighborList:
        """The [N, K] list within cutoff + skin (``NL.build_list``: the cell
        build where the box holds 3 cells an axis and the input's cells fit,
        else the tiled dense build, JAX's)."""
        return NL.build_list(P, self.cutoff + self.skin, self.k_max, self.cell, self.nl_grid,
                             self.nbr_cells)

    def init_aux(self, P: torch.Tensor) -> NL.NeighborList:
        """The list at P; raises on overflow (a host read, outside any
        capture)."""
        nl = self.build_list(P)
        _check_overflow(nl, self.k_max)
        return nl

    def energy(self, P: torch.Tensor, nl: NL.NeighborList) -> torch.Tensor:
        """E in eV at a fixed list."""
        if self.induction == "ewald":
            e_nb = self.sys.energy_ewald_induction(P, nl, self.cg_iters)
        else:
            e_nb = self.sys.energy(P, nl)
        return e_nb + self.val.energy(P, self.cell)

    def energy_forces(self, P: torch.Tensor, nl: NL.NeighborList):
        """(E, F) at a fixed list, F by autograd."""
        with torch.enable_grad():
            p = P.detach().requires_grad_(True)
            e = self.energy(p, nl)
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g

    def __call__(self, P: torch.Tensor, nl: NL.NeighborList):
        """(E, F, the list rebuilt at P with its overflow flag kept): the
        stateful protocol of ``md/langevin.langevin_step``."""
        nl = NL.rebuild(nl, P, self.build_list)
        return (*self.energy_forces(P, nl), nl)

    # -- drivers ----------------------------------------------------------------
    def descent_cycle(self, b) -> None:
        """One steepest-descent cycle on the buffer tuple b = (positions, step
        size, energy at the cycle's start, list), rewritten in place: E, F at
        P; P2 = P + min(s, 0.2 / max|F|) F; accept P2 when E(P2) < E, then s
        x 1.2, else s x 0.5 (``amoeba_md.py:134-147``).  The list carried is
        the one rebuilt at P2, so its overflow flag covers both
        evaluations."""
        P, s, e_start, nl = b
        e, f, nl1 = self(P, nl)
        fmax = torch.clamp(f.abs().max(), min=1e-9)
        P2 = P + torch.minimum(s, 0.2 / fmax) * f
        e2, _, nl2 = self(P2, nl1)
        ok = e2 < e
        e_start.copy_(e)
        P.copy_(torch.where(ok, P2, P))
        s.copy_(torch.where(ok, s * 1.2, s * 0.5))
        tree_copy_(nl, nl2)

    def minimize(self, positions, steps: int = 200, lr: float = 1e-3, chunk: int = 50):
        """Steepest descent with backtracking (``amoeba_md.py:123-156``):
        ``max(1, steps // chunk)`` chunks of ``chunk`` cycles, the step size
        starting at ``lr`` on every call.  On the card each cycle replays one
        captured step (captured at the first call), and nothing is read back
        inside a chunk.  Returns (positions [N,3] numpy, each cycle's energy
        at its start); raises when the list overflowed during a chunk."""
        P = torch.as_tensor(np.asarray(positions), dtype=self.sys.q.dtype,
                            device=self.cell.device)
        nl = self.init_aux(P)
        if self._descent is None:
            b = (P.clone(), torch.tensor(lr, dtype=P.dtype, device=P.device), P.new_zeros(()),
                 nl)
            self._descent = (b, stepper(self.descent_cycle, b))
        b, cycle = self._descent
        b[0].copy_(P)
        b[1].fill_(lr)
        tree_copy_(b[3], nl)
        energies = []
        for _ in range(max(1, steps // chunk)):
            es = P.new_zeros(chunk)
            for i in range(chunk):
                cycle()
                es[i].copy_(b[2])
            _check_overflow(b[3], self.k_max)
            energies.extend(es.tolist())
        return b[0].cpu().numpy(), energies

    def make_step_fn(self, state: L.MDState, generator: torch.Generator,
                     timestep_fs: float = 1.0, temp_K: float = 300.0,
                     friction_per_fs: float = 0.001) -> GraphedLangevin:
        """Langevin steps of this potential from ``state`` as replays of one
        captured step, the noise drawn from ``generator``
        (``amoeba_md.py:158-170``, where JAX scans the steps); ``run(n)``
        takes n steps.  Needs the card."""
        coeffs = L.LangevinCoeffs.build(self.masses, timestep_fs, temp_K, friction_per_fs,
                                        device=self.cell.device, dtype=self.cell.dtype)
        masses = torch.as_tensor(self.masses, dtype=self.cell.dtype, device=self.cell.device)
        return GraphedLangevin(self, coeffs, masses, state, generator)

    def initial_state(self, positions, generator: torch.Generator,
                      temp_K: float = 300.0) -> L.MDState:
        """Maxwell-Boltzmann velocities from ``generator`` at ``temp_K``, and
        the energy, forces and list at the positions (``amoeba_md.py:
        172-179``)."""
        P = torch.as_tensor(np.asarray(positions), dtype=self.cell.dtype,
                            device=self.cell.device)
        nl = self.init_aux(P)
        vel = L.maxwell_boltzmann_velocities(generator, self.masses, temp_K,
                                             dtype=self.cell.dtype)
        e, f, nl = self(P, nl)
        return L.MDState(P, vel, f, e, aux=nl)


def _check_overflow(nl: NL.NeighborList, k_max: int) -> None:
    if bool(nl.overflow):
        raise ValueError(f"AMOEBA neighbor list overflow at k_max={k_max}")


def _k_for(cutoff: float) -> int:
    """[N,K] slots at ~1.3x liquid-water density within ``cutoff``."""
    return int(np.ceil(0.13 * 4.19 * cutoff ** 3 / 64.0)) * 64
