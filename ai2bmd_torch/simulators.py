"""High-level simulation assembly: the reference simulator API.

Port of ``ai2bmd_tpu/simulators.py:86-259``: the reference's
NoSolventSimulator (src/AIMD/simulator.py:295-313), fragment-mode MD of the
capped protein with the "mm" or "pme" long range, warm-started caps (or,
with ``warm_caps=False``, a cold cap solve every step) and an optional
H-bond restraint; whole-molecule mode (``mode="visnet"``,
simulator.py:74-79), the molecule straight through ViSNet with a stateless
potential; and the SolventSimulator (simulator.py:226-292): a solvated input
(waters or ions; ``solvent=None`` detects them) runs subtractive QM/MM over
the whole periodic box (``physics/qmmm.py``, the ff19SB engine), the QM
side being the same protein potential, with optional rigid TIP3P water
(``rigid_water``, SETTLE) and a trajectory of the protein only
(``write_solvent=False``).  ``solvent=False`` runs a solvated input's
protein alone in vacuum, as the JAX package does.  On the card unless the
caller passes ``device="cpu"``; the weights come from a checkpoint
(``load_model``) or a random initialization.

Not ported: the benchmark stabilizers of ``ai2bmd_tpu/simulators.py:41-83``
(``AI2BMD_RANDOM_HEAD_SCALE``, ``AI2BMD_BENCH_PROT_MM``); ``bench_torch.py
--solvated`` applies them in the script.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ai2bmd_torch.host import Protein, load_protein
from ai2bmd_torch.md.constraints import BondRestraint
from ai2bmd_torch.md.settle import SettleConstraint
from ai2bmd_torch.md.simulation import SimulationConfig, Simulator
from ai2bmd_torch.models.checkpoint import load_checkpoint, load_converted
from ai2bmd_torch.models.params import init_params
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
from ai2bmd_torch.physics.qmmm import QMMMPotential
from ai2bmd_torch.potentials import FragmentPotential, ViSNetPotential
from ai2bmd_torch.utils.device import resolve_device

WARM_ITERS = 1   # L-BFGS iterations a step from the previous step's caps (simulators.py:209-220)


def load_model(ckpt_path: str | None, cfg: ViSNetConfig | None = None, seed: int = 0):
    """The parameter tree and its config (``simulators.py:31-40``): a
    converted ``.npz`` through ``load_converted``, a path that exists through
    ``load_checkpoint`` (a Lightning .ckpt; both take the config from the
    file, not ``cfg``), else random weights (``init_params`` from ``seed``),
    as no reference weights ship."""
    if ckpt_path and ckpt_path.endswith(".npz"):
        return load_converted(ckpt_path)
    if ckpt_path and os.path.exists(ckpt_path):
        return load_checkpoint(ckpt_path)
    cfg = cfg or ViSNetConfig()
    return init_params(cfg, torch.Generator().manual_seed(seed)), cfg


@dataclasses.dataclass
class ProteinSimulation:
    """One assembled simulation: protein + potential + driver.  ``prot`` is
    the simulated system (the whole box on a solvated run), ``potential``
    the protein's ML potential, and ``qmmm`` the QM/MM potential the
    Simulator steps on a solvated run (None in vacuum)."""

    prot: Protein
    sim: Simulator
    potential: FragmentPotential | ViSNetPotential
    log_dir: str
    prot_name: str
    qmmm: QMMMPotential | None = None
    record_subset: np.ndarray | None = None

    @classmethod
    def from_pdb(cls, prot_file: str, log_dir: str | None = None, mode: str = "fragment",
                 longrange: str = "mm", solvent: bool | None = None,
                 write_solvent: bool = True, ckpt_path: str | None = None,
                 model_cfg: ViSNetConfig | None = None, sim_cfg: SimulationConfig | None = None,
                 opt_iters: int = 10, warm_caps: bool = True, polarizable_mm: bool = False,
                 rigid_water: bool = False, mm_backend: str = "ff19sb",
                 pair_backend: str = "auto", device=None) -> "ProteinSimulation":
        """``mode`` "fragment" or "visnet" (whole molecule, which ignores
        ``longrange`` as the JAX package does); ``solvent`` None means "the
        input's waters and ions, if it has any", and False runs a solvated
        input's protein alone in vacuum (``ai2bmd_tpu/simulators.py:
        121-129``); ``warm_caps`` False steps the stateless fragment
        potential, which places the caps and solves them cold with
        ``opt_iters`` L-BFGS iterations every step (:209-234; fragment mode
        only).  A solvated run takes ``write_solvent``, ``rigid_water``,
        ``mm_backend`` ("ff19sb", or "amoeba": the polarizable AMOEBA solvent)
        and ``polarizable_mm`` (the induced-dipole hybrid on ff19SB); its
        pairs take ``QMMMPotential.build``'s ``pair_backend`` ("auto": the
        neighbour list for either polarizable backend; JAX's from_pdb always
        takes "auto").  On the card every step is one replay of a captured
        CUDA graph.  ``device`` None means the card (raises without one)."""
        device = resolve_device(device)
        prot_name = os.path.basename(prot_file).rsplit(".", 1)[0]
        log_dir = log_dir or os.path.join(os.getcwd(), f"Logs-{prot_name}")
        if mode not in ("fragment", "visnet"):
            raise ValueError(f"unknown mode {mode!r}")
        full = load_protein(prot_file)
        sim_cfg = sim_cfg or SimulationConfig()
        qm_idx = full.protein_indices()
        has_solvent = len(qm_idx) < len(full)
        if solvent is None:
            solvent = has_solvent
        if solvent and not has_solvent:
            raise ValueError("solvent=True but the input has no water/ions")
        prot = full.select(qm_idx) if has_solvent else full

        params, cfg = load_model(ckpt_path, model_cfg)
        module = ViSNet(cfg, params)
        hbond = None
        if sim_cfg.hydrogen_constraints:
            hbond = BondRestraint.find_hydrogen_bonds(prot.atoms, device=device)
        if mode == "visnet":
            pot = ViSNetPotential.build(prot.numbers, module, cfg, device=device)
        else:
            pot = FragmentPotential.build(prot, module, cfg, longrange=longrange,
                                          opt_iters=opt_iters, device=device)
        # warm-started caps: the cap offsets ride in the integrator's carry,
        # cold-started once here (the JAX package's choice, simulators.py:
        # 154-163: warm-1 sits within the reference's own cold protocol)
        use_warm = warm_caps and mode == "fragment"
        qm, qm_aux0 = pot.energy_forces, None
        if use_warm:
            P0 = torch.as_tensor(np.asarray(prot.positions), dtype=torch.float32, device=device)
            qm_aux0 = pot.init_cap_delta(P0)
            qm = lambda P, aux: pot.stateful_energy_forces(P, aux, warm_iters=WARM_ITERS)
        common = dict(cfg=sim_cfg, log_dir=log_dir, prot_name=prot_name, hbond_restraint=hbond,
                      device=device)

        if solvent:
            # the SolventSimulator: subtractive QM/MM over the whole box
            qmmm = QMMMPotential.build(
                full.atoms, qm_energy_forces=None if use_warm else qm,
                qm_stateful=qm if use_warm else None, qm_init_aux=qm_aux0,
                polarizable=polarizable_mm, mm_backend=mm_backend, pair_backend=pair_backend,
                device=device)
            P_full = torch.as_tensor(full.positions, dtype=torch.float32, device=device)
            # rigid TIP3P (SETTLE) removes the O-H stretches, so the solvent
            # steps stably at 2 fs
            constraint = SettleConstraint.from_topology(qmmm.top, device) if rigid_water else None
            sim = Simulator(potential=qmmm, masses=full.masses, numbers=full.numbers,
                            stateful=True, init_aux=qmmm.init_aux(P_full), cell=full.cell,
                            constraint=constraint, **common)
            return cls(prot=full, sim=sim, potential=pot, log_dir=log_dir, prot_name=prot_name,
                       qmmm=qmmm, record_subset=None if write_solvent else qm_idx)

        common.update(masses=prot.masses, numbers=prot.numbers)
        if use_warm:
            sim = Simulator(potential=qm, stateful=True, init_aux=qm_aux0, **common)
        else:
            # no carry: the Simulator lifts the stateless potential
            sim = Simulator(potential=qm, **common)
        return cls(prot=prot, sim=sim, potential=pot, log_dir=log_dir, prot_name=prot_name)

    def simulate(self, simulation_steps: int, restart: bool = False, log=print):
        restart_path = None
        if restart:
            restart_path = os.path.join(self.log_dir, f"{self.prot_name}-restart.npz")
            if not os.path.exists(restart_path):
                raise FileNotFoundError(f"no restart checkpoint at {restart_path}")
        state = self.sim.initial_state(self.prot.positions, restart=restart_path, log=log)
        if not restart:
            state = self.sim.pre_equilibrate(state, log=log)
        log(("Re-start" if restart else "Start") + f" simulation for {simulation_steps} steps")
        state = self.sim.run(
            state, simulation_steps, log=log, record_subset=self.record_subset,
            # a restarted run writes {prot}-traj-restart.* instead of
            # truncating the original trajectory (reference simulator.py:119)
            traj_suffix="-restart" if restart else "")
        log("Simulation finished!")
        return state
