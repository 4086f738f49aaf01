"""n independent Langevin trajectories of one protein on one card.

Port of ``ReplicaEnsemble`` (``ai2bmd_tpu/parallel/sharding.py:342-480``):
the force evaluation batches across replicas
(``frag.runtime.ensemble_fragment_energy_forces_warm``: per-replica caps,
replica and row axes folded into one ViSNet batch per bucket, replicas in
chunks so that peak memory is one chunk's) and the integrator is
``md.langevin.langevin_step_batched``.  Each replica draws its noise from a
generator of its own, so it follows the trajectory it would follow alone.

Not ported yet: the ``mesh`` (replicas over several cards, ROADMAP Queue 1
item 17), ``EnsembleSimulation`` (item 17) and ``SolvatedReplicaEnsemble``
(item 13).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.frag import runtime as RT
from ai2bmd_torch.host import FragmentIndex, Protein
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig, resolve_config
from ai2bmd_torch.physics.nonbonded import NonbondedParams, nonbonded_energy_forces
from ai2bmd_torch.utils.device import resolve_device


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
            raise NotImplementedError(
                "a replica mesh over several cards is not ported yet (ROADMAP.md, Queue 1 "
                "item 17); ReplicaEnsemble runs on one card")
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
