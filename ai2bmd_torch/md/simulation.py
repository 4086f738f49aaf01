"""MD driver: pre-equilibration ladder, production run, records, restart.

Port of ``ai2bmd_tpu/md/simulation.py:41-323`` (``SimulationConfig``,
``TemperatureRunawayError``, ``Simulator``), which replaces the reference's
BaseSimulator / ASE Langevin / MDObserver stack (src/AIMD/simulator.py:
34-223, src/utils/utils.py:114-166).

One program serves every stage, as in JAX (:97-123): ``full_potential``
reads the tether reference [N,3] and spring constant (0-d) from buffers that
a stage overwrites in place, and production sets the constant to 0.  On the
card the MD loop is replays of one captured Langevin step
(``md.graphed.GraphedLangevin``, the counterpart of JAX's jitted
``lax.scan``), captured at the first stage and reused for the whole ladder
and the production run; a failed capture raises, and there is no eager
stand-in.  On the CPU the same loop runs eager ``langevin_step`` calls that
draw their noise from the same generator in the same order (xi, then eta).

Feature parity:
  * Maxwell-Boltzmann init from ``cfg.seed``, drawn before the first forces
    (simulator.py:96)
  * the tether ladder [10, 5, 1, 0.5, 0.1] kcal/mol/A^2 x preeq_steps
    (simulator.py:139-166)
  * optional hydrogen-bond restraints (simulator.py:168-180), their forces
    by autograd inside the captured step
  * non-finite and temperature-runaway guards (runaway_factor x T) at every
    record interval (utils.py:154-155)
  * XYZ / DCD trajectories, each unless ``write_xyz`` / ``write_dcd`` is
    False (the DCD with the periodic ``cell`` when there is one;
    ``record_subset`` writes only those atoms, e.g. the protein of a
    solvated box), through the native background writer (``runtime``) when
    it builds and opens, else the Python writers of ``io/trajectory.py``, as
    JAX chooses (ai2bmd_tpu/md/simulation.py:207-236); ``run`` logs which.
    A metrics CSV and a restart file per record interval, whatever the
    flags; restart from it with the generator's state (simulator.py:86-96,
    118-133)
  * an optional ``constraint`` (SETTLE rigid water, ``md/settle.py``):
    waters snapped onto the rigid geometry and velocities projected at the
    start, the constraint applied inside every step
  * the overflow guard at every record interval (``_check_overflow``): a
    neighbour list or a cell-bucket assignment in the carry that overflowed
    raises, since it drops interactions (the QM/MM potential keeps the flag
    sticky between records).  JAX's guard reads neighbour lists only
    (ai2bmd_tpu/md/simulation.py:310-322)
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from ai2bmd_torch import runtime, units
from ai2bmd_torch.io import trajectory as traj_io
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.md.constraints import BondRestraint, restraint_energy_forces
from ai2bmd_torch.md.graphed import GraphedLangevin
from ai2bmd_torch.ops.neighbors import NeighborList
from ai2bmd_torch.physics.cellpair import CellState
from ai2bmd_torch.utils.device import resolve_device
from ai2bmd_torch.utils.logging_utils import MetricsLog
from ai2bmd_torch.utils.tree import tree_clone, tree_leaves, tree_map, tree_unflatten


class TemperatureRunawayError(RuntimeError):
    def __init__(self, temp: float):
        self.temp = temp
        super().__init__(f"temperature runaway: {temp:.1f} K")


@dataclasses.dataclass
class SimulationConfig:
    timestep_fs: float = 1.0
    temp_K: float = 300.0
    friction_per_fs: float = 0.001
    record_per_steps: int = 100
    seed: int = 0
    preeq_steps: int = 200
    preeq_restraints_kcal: tuple = (10.0, 5.0, 1.0, 0.5, 0.1)
    hydrogen_constraints: bool = False
    write_xyz: bool = True
    write_dcd: bool = True
    runaway_factor: float = 1.5


def _clone(state: L.MDState) -> L.MDState:
    return L.MDState(state.positions.clone(), state.velocities.clone(), state.forces.clone(),
                     state.energy.clone(), step=state.step, aux=tree_clone(state.aux))


def overflow_flags(aux):
    """(kind, 0-d bool tensor) of every neighbour list and cell assignment
    in a carry."""
    if isinstance(aux, NeighborList):
        return [("neighbor list", aux.overflow)]
    if isinstance(aux, CellState):
        return [("cell-bucket assignment", aux.overflow)]
    if isinstance(aux, (tuple, list)):
        return [flag for part in aux for flag in overflow_flags(part)]
    return []


class Simulator:
    """Drives a potential over a protein state.

    ``potential`` is P -> (E, F), or (P, aux) -> (E, F, aux) with
    ``stateful`` (``init_aux`` is then the carry the first forces start
    from, e.g. cold cap offsets, or a tuple of tensors).  ``cell`` (box
    lengths) goes into the DCD; ``constraint`` (SETTLE) acts inside every
    step.  ``device`` None means the card (raises without one); the
    potential must run on the same device."""

    def __init__(self, potential: Callable, masses: np.ndarray, numbers: np.ndarray,
                 cfg: SimulationConfig, log_dir: str, prot_name: str,
                 hbond_restraint: BondRestraint | None = None, stateful: bool = False,
                 init_aux=None, device=None, cell: np.ndarray | None = None,
                 constraint=None):
        self.device = resolve_device(device)
        self.cell = None if cell is None or not np.any(cell) else np.asarray(cell)
        self.constraint = constraint
        self.cfg = cfg
        self.masses_np = np.asarray(masses, np.float64)
        self.masses = torch.as_tensor(self.masses_np, dtype=torch.float32, device=self.device)
        self.numbers = np.asarray(numbers)
        self.log_dir = log_dir
        self.prot_name = prot_name
        os.makedirs(log_dir, exist_ok=True)

        self.coeffs = L.LangevinCoeffs.build(self.masses_np, cfg.timestep_fs, cfg.temp_K,
                                             cfg.friction_per_fs, device=self.device)
        self._base_potential = potential if stateful else L.lift_potential(potential)
        self._init_aux = init_aux
        self.hbond = hbond_restraint
        # the pre-equilibration tether, read by every step: a stage writes
        # its reference and spring constant here in place (k = 0 disables)
        n = len(self.masses_np)
        self.tether_ref = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        self.tether_k = torch.zeros((), dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.graph: GraphedLangevin | None = None

    def full_potential(self, P: torch.Tensor, aux):
        """The stepped potential: the base potential, the tether and the
        H-bond restraint."""
        e, f, aux = self._base_potential(P, aux)
        d = P - self.tether_ref
        e = e + 0.5 * self.tether_k * (d * d).sum()
        f = f - self.tether_k * d
        if self.hbond is not None:
            er, fr = restraint_energy_forces(self.hbond, P)
            e, f = e + er, f + fr
        return e, f, aux

    # ------------------------------------------------------------------
    def initial_state(self, positions: np.ndarray, restart: str | None = None,
                      log=print) -> L.MDState:
        """The state at step 0 (velocities from ``cfg.seed``, then the first
        forces), or the state of a restart file with its generator state."""
        if restart:
            n_leaves = max(1, len(tree_leaves(self._init_aux)))
            pos, vel, step, rng_state, extras = traj_io.load_restart(restart, n_leaves)
            P = self._tensor(pos)
            if rng_state is not None:
                self.generator.set_state(rng_state)
            else:
                self.generator.manual_seed(self.cfg.seed)
                log(f"{restart} holds no generator state (a JAX package checkpoint): the "
                    f"noise stream starts anew from seed {self.cfg.seed}")
            has_aux = "aux" in extras or self._init_aux is None
            if "forces" in extras and has_aux:
                # a continuous restart: the checkpointed forces, energy and
                # carry resume the trajectory where it stopped
                aux = self._carry(extras["aux"]) if "aux" in extras else None
                forces = self._tensor(extras["forces"])
                energy = self._tensor(extras.get("energy", 0.0))
            else:
                # an older checkpoint: forces from a fresh carry
                energy, forces, aux = self._base_potential(P, self._init_aux)
            return L.MDState(P, self._tensor(vel), forces, energy, step=step, aux=aux)
        self.generator.manual_seed(self.cfg.seed)
        vel = L.maxwell_boltzmann_velocities(self.generator, self.masses_np, self.cfg.temp_K)
        P = self._tensor(positions)
        if self.constraint is not None:
            # waters onto the rigid geometry, and the thermal velocities
            # projected so that d/dt(constraints) = 0 from the first step
            P = self.constraint.snap(P)
            vel = self.constraint.velocities(P, vel)
        energy, forces, aux = self._base_potential(P, self._init_aux)
        return L.MDState(P, vel, forces, energy, step=0, aux=aux)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    def _carry(self, saved):
        """A restart file's aux leaves in the structure and dtypes of
        ``init_aux``."""
        if self._init_aux is None or isinstance(self._init_aux, torch.Tensor):
            return self._tensor(saved)
        leaves = saved if isinstance(saved, list) else [saved]
        return tree_map(lambda tmpl, a: torch.as_tensor(np.asarray(a), dtype=tmpl.dtype,
                                                        device=self.device),
                        self._init_aux, tree_unflatten(self._init_aux, leaves))

    # ------------------------------------------------------------------
    def advance(self, state: L.MDState, n_steps: int) -> L.MDState:
        """``n_steps`` Langevin steps of ``full_potential`` at the current
        tether.  On the card: replays of the captured step (captured at the
        first call); on the CPU: eager steps.
        Returns a copy that later steps do not change."""
        if self.device.type != "cuda":
            for _ in range(n_steps):
                state = L.langevin_step(self.full_potential, self.coeffs, self.masses, state,
                                        generator=self.generator, constraint=self.constraint)
            return state
        if self.graph is None:
            self.graph = GraphedLangevin(self.full_potential, self.coeffs, self.masses, state,
                                         self.generator, self.constraint)
        else:
            self.graph.load(state)
        return _clone(self.graph.run(n_steps))

    def _set_tether(self, reference: torch.Tensor, k_eV: float) -> None:
        self.tether_ref.copy_(reference)
        self.tether_k.fill_(k_eV)

    # ------------------------------------------------------------------
    def pre_equilibrate(self, state: L.MDState, log=print) -> L.MDState:
        if self.cfg.preeq_steps == 0:
            return state
        log("Start pre-equilibration")
        for k_kcal in self.cfg.preeq_restraints_kcal:
            log(f"Pre-equilibration with {k_kcal} kcal/mol/A^2 for "
                f"{self.cfg.preeq_steps} steps")
            self._set_tether(state.positions, k_kcal * units.kcal_per_mol)
            state = self.advance(state, self.cfg.preeq_steps)
            self._check_runaway(state)
        log("Pre-equilibration finished!")
        return state

    # ------------------------------------------------------------------
    def _open_writers(self, traj_suffix: str, numbers: np.ndarray, log) -> list:
        """The writers of the files ``write_xyz`` / ``write_dcd`` select: the
        native writer, or the Python writers when it cannot be built or
        opened.  Logs which."""
        cfg = self.cfg
        stem = os.path.join(self.log_dir, f"{self.prot_name}-traj{traj_suffix}")
        xyz = f"{stem}.xyz" if cfg.write_xyz else None
        dcd = f"{stem}.dcd" if cfg.write_dcd else None
        if xyz is None and dcd is None:
            return []
        kinds = ", ".join(k for k, p in (("XYZ", xyz), ("DCD", dcd)) if p)
        try:
            writer = runtime.AsyncTrajectoryWriter(dcd, xyz, numbers, cfg.timestep_fs,
                                                   cfg.record_per_steps, cell=self.cell)
        except (RuntimeError, OSError) as e:
            log(f"trajectory: Python writers ({kinds}; {e})")
        else:
            log(f"trajectory: native writer ({kinds})")
            return [writer]
        writers = []
        if xyz:
            writers.append(traj_io.XYZTrajectory(xyz, numbers))
        if dcd:
            writers.append(traj_io.DCDTrajectory(dcd, len(numbers), cfg.timestep_fs,
                                                 cfg.record_per_steps, cell=self.cell))
        return writers

    def run(self, state: L.MDState, n_steps: int, log=print, record_subset=None,
            traj_suffix: str = "") -> L.MDState:
        """Production run, recording every ``record_per_steps`` steps (only
        the atoms of ``record_subset`` when given)."""
        cfg = self.cfg
        numbers = self.numbers if record_subset is None else self.numbers[record_subset]
        writers = self._open_writers(traj_suffix, numbers, log)
        metrics = MetricsLog(os.path.join(self.log_dir, f"{self.prot_name}-metrics.csv"))
        restart_path = os.path.join(self.log_dir, f"{self.prot_name}-restart.npz")
        self._set_tether(state.positions, 0.0)
        remaining = n_steps
        t_start = time.perf_counter()
        t_last = t_start
        try:
            while remaining > 0:
                n = min(cfg.record_per_steps, remaining)
                state = self.advance(state, n)
                remaining -= n
                # host readback of the recorded frame
                epot = float(state.energy)
                ekin = float(L.kinetic_energy(self.masses, state.velocities))
                if not np.isfinite(epot) or not np.isfinite(ekin):
                    raise FloatingPointError(
                        f"non-finite energy at step {state.step} (Epot={epot}, Ekin={ekin}); "
                        f"restart from the last checkpoint with a smaller timestep")
                self._check_overflow(state)
                temp = self._check_runaway(state)
                now = time.perf_counter()
                ms_per_step = 1e3 * (now - t_last) / n
                t_last = now
                log(f"Step {state.step}: Epot = {epot:.3f}eV Ekin = {ekin:.3f}eV "
                    f"Etot = {epot + ekin:.3f}eV T = {temp:.1f}K")
                metrics.write(state.step, epot, ekin, temp, ms_per_step)
                pos = state.positions.cpu().numpy()
                if record_subset is not None:
                    pos = pos[record_subset]
                for w in writers:
                    w.write(pos, energy=epot, step=state.step)
                traj_io.save_restart(restart_path, state.positions, state.velocities,
                                     state.step, self.generator.get_state(),
                                     forces=state.forces, energy=state.energy, aux=state.aux)
        finally:
            metrics.close()
            for w in writers:
                w.close()
        dt_wall = time.perf_counter() - t_start
        if n_steps:
            log(f"{n_steps} steps in {dt_wall:.2f}s: {1e3 * dt_wall / n_steps:.2f} ms/step, "
                f"{86.4 * cfg.timestep_fs * n_steps / max(dt_wall, 1e-9) / 1e3:.3f} ns/day")
        return state

    def _check_overflow(self, state: L.MDState) -> None:
        """Raise on an overflowed neighbour list or cell assignment in the
        carry: it silently drops interactions."""
        for kind, flag in overflow_flags(state.aux):
            if bool(flag):
                raise RuntimeError(
                    f"{kind} overflow at step {state.step}: some atoms are missing from the "
                    f"pair sum (a neighbour list needs a larger k_neighbors; a cell bucket "
                    f"a liquid-like density)")

    def _check_runaway(self, state: L.MDState) -> float:
        temp = float(L.temperature(self.masses, state.velocities))
        if temp > self.cfg.runaway_factor * self.cfg.temp_K:
            raise TemperatureRunawayError(temp)
        return temp
