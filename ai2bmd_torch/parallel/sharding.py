"""n independent Langevin trajectories of one protein on one card.

Port of ``ReplicaEnsemble`` (``ai2bmd_tpu/parallel/sharding.py:342-480``):
the force evaluation batches across replicas
(``frag.runtime.ensemble_fragment_energy_forces_warm``: per-replica caps,
replica and row axes folded into one ViSNet batch per bucket, replicas in
chunks so that peak memory is one chunk's) and the integrator is
``md.langevin.langevin_step_batched``.  Each replica draws its noise from a
generator of its own, so it follows the trajectory it would follow alone.

And of ``SolvatedReplicaEnsemble`` (``sharding.py:609-755``): replicas of a
solvated box, each stepped alone through the lone solvated step (on the card
one captured CUDA graph that every replica's state is loaded into in turn).

Not ported yet: the ``mesh`` (replicas over several cards, ROADMAP Queue 1
item 17) and ``EnsembleSimulation`` (item 17).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ai2bmd_torch.frag import runtime as RT
from ai2bmd_torch.host import FragmentIndex, Protein
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.md.graphed import GraphedLangevin
from ai2bmd_torch.md.simulation import overflow_flags
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig, resolve_config
from ai2bmd_torch.physics.nonbonded import NonbondedParams, nonbonded_energy_forces
from ai2bmd_torch.physics.qmmm import QMMMPotential
from ai2bmd_torch.potentials import FragmentPotential
from ai2bmd_torch.utils.device import resolve_device
from ai2bmd_torch.utils.tree import tree_clone, tree_copy_, tree_map

log = logging.getLogger(__name__)
MESH_REFUSED = ("a replica mesh over several cards is not ported yet (ROADMAP.md, Queue 1 "
                "item 17); {} runs on one card")


def replica_generators(seed: int, n: int, device) -> list[torch.Generator]:
    """One generator per replica, seeded from ``seed`` by numpy's
    ``SeedSequence.spawn`` (independent streams)."""
    seeds = [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


@dataclasses.dataclass
class ReplicaEnsemble:
    """``n_replicas`` Langevin trajectories with a replica-batched force
    evaluation (BASELINE config 5: 64 Chignolin replicas on one card).
    ``ViSNetConfig(remat=True)`` keeps its memory to one chunk's edge rows."""

    n_replicas: int
    steps_per_call: int
    warm_iters: int
    replica_chunk: int
    params: dict
    cfg: ViSNetConfig
    rt: RT.FragmentRuntime
    nb: NonbondedParams
    coeffs: L.LangevinCoeffs
    masses: torch.Tensor
    device: torch.device
    generators: list | None = None

    @classmethod
    def build(cls, prot: Protein, fi: FragmentIndex, params: dict, cfg: ViSNetConfig,
              n_replicas: int, timestep_fs: float = 1.0, temp_K: float = 300.0,
              friction_per_fs: float = 0.001, steps_per_call: int = 1, warm_iters: int = 1,
              replica_chunk: int = 8, device=None, mesh=None) -> "ReplicaEnsemble":
        """``params`` is the ViSNet parameter tree (the JAX layout, as
        ``models.params`` makes it), moved to the device as float32.
        ``device`` None means the card (raises without one).  ``mesh`` is
        refused: this ensemble runs on one card."""
        if mesh is not None:
            raise NotImplementedError(MESH_REFUSED.format("ReplicaEnsemble"))
        device = resolve_device(device)
        module = ViSNet(cfg, params).to(device, torch.float32)
        cfg = resolve_config(cfg, device)
        return cls(
            n_replicas=n_replicas, steps_per_call=steps_per_call, warm_iters=warm_iters,
            replica_chunk=replica_chunk, params=module.params(), cfg=cfg,
            rt=RT.FragmentRuntime.build(fi, device=device),
            nb=NonbondedParams.build(prot, fi.exclusion_mask(), device),
            coeffs=L.LangevinCoeffs.build(prot.masses, timestep_fs, temp_K, friction_per_fs,
                                          device=device),
            masses=torch.as_tensor(np.asarray(prot.masses), dtype=torch.float32, device=device),
            device=device,
        )

    def potential(self, Ps: torch.Tensor, deltas: torch.Tensor):
        """(Ps [Rl,N,3], cap offsets [Rl,R,S,3]) -> (E [Rl], F [Rl,N,3], offsets)."""
        e_b, f_b, deltas = RT.ensemble_fragment_energy_forces_warm(
            self.params, self.rt, Ps, self.cfg, deltas, warm_iters=self.warm_iters,
            replica_chunk=self.replica_chunk)
        e_nb, f_nb = nonbonded_energy_forces(self.nb, Ps)
        return e_b + e_nb, f_b + f_nb, deltas

    def initial_state(self, positions, temp_K: float = 300.0, seed: int = 0,
                      opt_iters: int = 10) -> L.MDState:
        """Every replica at ``positions`` [N,3] with Maxwell-Boltzmann
        velocities from its own generator (``replica_generators(seed)``,
        which then drive its noise), cold caps (``opt_iters`` L-BFGS
        iterations per replica) and real first forces from a warm step."""
        n = self.n_replicas
        self.generators = replica_generators(seed, n, self.device)
        masses = self.masses.cpu().numpy()
        vel = torch.stack([L.maxwell_boltzmann_velocities(g, masses, temp_K)
                           for g in self.generators])
        P = torch.as_tensor(np.asarray(positions), dtype=torch.float32, device=self.device)
        pos = P.expand(n, *P.shape).contiguous()
        deltas = RT.initial_cap_delta_batched(self.rt, pos, n_iter=opt_iters)
        # real first forces: zeros would give every replica a zero-force
        # first half-kick
        energy, forces, deltas = self.potential(pos, deltas)
        return L.MDState(positions=pos, velocities=vel, forces=forces, energy=energy,
                         aux=deltas)

    def run(self, state: L.MDState, n_calls: int) -> L.MDState:
        """``n_calls`` × ``steps_per_call`` batched Langevin steps."""
        if self.generators is None:
            raise ValueError("run needs the generators initial_state makes")
        for _ in range(n_calls * self.steps_per_call):
            state = L.langevin_step_batched(self.potential, self.coeffs, self.masses, state,
                                            generators=self.generators)
        return state


@dataclasses.dataclass
class SolvatedReplicaEnsemble:
    """``n_replicas`` independent solvated QM/MM Langevin trajectories of one
    box on one card (the reference samples on the solvated box,
    src/AIMD/simulator.py:119-137).  One solvated step fills the card, so the
    replicas step one after another, as JAX's ``lax.map`` runs them.

    The pair route is ``QMMMPotential.build``'s ``auto``, chosen once and
    logged: the cell buckets on a liquid box, since their assignment runs
    inside every step and each replica carries its own (JAX hard-codes
    ``dense``, sharding.py:662, because a per-replica list rebuild cannot
    stay static under its ``lax.map``); the pair set inside the cutoff is
    the same, the summation order differs.  The state holds every replica's
    tensors on a leading axis, the carry (cell buckets with their sticky
    overflow flag, cap offsets) too."""

    n_replicas: int
    steps_per_call: int
    qmmm: QMMMPotential
    coeffs: L.LangevinCoeffs
    masses: torch.Tensor
    device: torch.device
    qm_idx: np.ndarray            # protein atom indices (the QM region)
    generators: list | None = None
    graph: GraphedLangevin | None = None

    @classmethod
    def build(cls, atoms: PDBAtoms, params: dict, cfg: ViSNetConfig, n_replicas: int,
              mesh=None, timestep_fs: float = 1.0, temp_K: float = 300.0,
              friction_per_fs: float = 0.001, steps_per_call: int = 1, warm_iters: int = 1,
              mm_backend: str = "ff19sb", device=None) -> "SolvatedReplicaEnsemble":
        """``atoms``: the solvated box (normalized atom order).  The QM side is
        the lone route's ``FragmentPotential`` with warm caps (``warm_iters``
        L-BFGS iterations a step), the MM side ``QMMMPotential``.  ``device``
        None means the card (raises without one); ``mesh`` is refused."""
        if mesh is not None:
            raise NotImplementedError(MESH_REFUSED.format("SolvatedReplicaEnsemble"))
        full = Protein.from_atoms(atoms)
        qm_idx = full.protein_indices()
        if len(qm_idx) == len(full):
            raise ValueError("input box has no solvent; use ReplicaEnsemble for vacuum "
                             "fragment-mode ensembles")
        device = resolve_device(device)
        prot = full.select(qm_idx)
        pot = FragmentPotential.build(prot, ViSNet(cfg, params).to(device, torch.float32), cfg,
                                      longrange="mm", device=device)
        P_prot = torch.as_tensor(prot.positions, dtype=torch.float32, device=device)
        qmmm = QMMMPotential.build(
            atoms, qm_stateful=lambda Pq, qa: pot.stateful_energy_forces(
                Pq, qa, warm_iters=warm_iters),
            qm_init_aux=pot.init_cap_delta(P_prot), mm_backend=mm_backend, device=device)
        log.info("SolvatedReplicaEnsemble: %d replicas of %d atoms (%d in the QM region), "
                 "%s pair route", n_replicas, len(full), len(qm_idx), qmmm.backend)
        return cls(
            n_replicas=n_replicas, steps_per_call=steps_per_call, qmmm=qmmm,
            coeffs=L.LangevinCoeffs.build(full.masses, timestep_fs, temp_K, friction_per_fs,
                                          device=device),
            masses=torch.as_tensor(np.asarray(full.masses), dtype=torch.float32, device=device),
            device=device, qm_idx=qm_idx)

    def initial_state(self, positions, temp_K: float = 300.0, seed: int = 0) -> L.MDState:
        """Every replica at ``positions`` [N,3]: Maxwell-Boltzmann velocities
        from its own generator (``replica_generators(seed)``, which then
        drive its noise), and one identical start: the cold caps and first
        forces of one evaluation, broadcast."""
        n = self.n_replicas
        self.generators = replica_generators(seed, n, self.device)
        masses = self.masses.cpu().numpy()
        vel = torch.stack([L.maxwell_boltzmann_velocities(g, masses, temp_K)
                           for g in self.generators])
        P = torch.as_tensor(np.asarray(positions), dtype=torch.float32, device=self.device)
        energy, forces, aux = self.qmmm(P, self.qmmm.init_aux(P))
        rep = lambda t: t.expand(n, *t.shape).clone()
        return L.MDState(positions=rep(P), velocities=vel, forces=rep(forces),
                         energy=rep(energy), aux=tree_map(rep, aux))

    def replica(self, state: L.MDState, r: int) -> L.MDState:
        """Replica r's lone state (views into ``state``)."""
        return L.MDState(state.positions[r], state.velocities[r], state.forces[r],
                         state.energy[r], step=state.step,
                         aux=tree_map(lambda t: t[r], state.aux))

    def run(self, state: L.MDState, n_calls: int) -> L.MDState:
        """``n_calls`` x ``steps_per_call`` Langevin steps of every replica,
        each drawing its noise from its own generator in the lone step's
        order; ``state`` is left as it was.  On the card each replica's state
        is loaded into one captured step (captured at the first call) and
        replayed; on the CPU the steps run eagerly.  Raises when a replica's
        cell assignment overflowed (it drops pairs)."""
        if self.generators is None:
            raise ValueError("run needs the generators initial_state makes")
        out = L.MDState(state.positions.clone(), state.velocities.clone(),
                        state.forces.clone(), state.energy.clone(), step=state.step,
                        aux=tree_clone(state.aux))
        for _ in range(n_calls):
            for r, g in enumerate(self.generators):
                lone = self.replica(out, r)
                stepped = self._advance(lone, g, self.steps_per_call)
                for name in ("positions", "velocities", "forces", "energy"):
                    getattr(lone, name).copy_(getattr(stepped, name))
                tree_copy_(lone.aux, stepped.aux)
            out.step += self.steps_per_call
        for kind, flag in overflow_flags(out.aux):
            if bool(flag.any()):
                raise RuntimeError(f"{kind} overflow by step {out.step}: some replica's atoms "
                                   f"are missing from the pair sum")
        return out

    def _advance(self, lone: L.MDState, generator: torch.Generator, n_steps: int) -> L.MDState:
        if self.device.type != "cuda":
            for _ in range(n_steps):
                lone = L.langevin_step(self.qmmm, self.coeffs, self.masses, lone,
                                       generator=generator)
            return lone
        if self.graph is None:
            self.graph = GraphedLangevin(self.qmmm, self.coeffs, self.masses, lone, generator)
        self.graph.load(lone, generator)
        return self.graph.run(n_steps)
