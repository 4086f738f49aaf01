"""Preprocessing: solvation, minimization, heating, equilibration.

Port of ``ai2bmd_tpu/preprocess.py``, which replaces the reference's
AmberTools/sander pipeline (src/AIMD/preprocess.py:111-507: tleap solvate and
ions, sander min / heat / NVT / NPT, cpptraj export) with stages on the MM
engine:

  1. ``solvate``: a TIP3P lattice box with a padding around the protein,
     clash-culled, randomly oriented, neutralizing Na+/Cl- in place of the
     waters farthest from the protein (numpy; the same box as JAX's, bit for
     bit, from the same seed)
  2. minimize: restrained steepest descent with backtracking, ``max_cyc``
     cycles of two evaluations
  3. heat: a Berendsen NVT ramp over ``heat_stages``, the protein tethered
  4. NVT: Langevin, in whole chunks of 500 steps as JAX runs them
     (ROADMAP.md, Queue 3: ``nvt_steps`` = 400 or 10 runs 500 steps)
  5. NPT: Berendsen barostat with dynamic-cell PME, ``min(500, npt_steps)``
     steps a chunk; ``last_npt_pressure_bar`` is the mean over the final
     half of the chunks

Outputs ``{prot}-preeq.pdb`` (the box) and ``{prot}-preeq-nowat.pdb``; when
both exist, ``run`` returns at once, like the reference's check_exist.

``method="AMOEBA"`` (``preprocess.py:318-352``) replaces stages 2-5 by a
minimization of the box with the whole AMOEBA force field
(``physics/amoeba_md.py``), the reference's pdbxyz8 + Tinker minimize9 with
amoebabio18.prm (src/AIMD/preprocess.py:184-244).

Every FF19SB evaluation is the dense pair route (``physics/mm.py``), as in
JAX (preprocess.py:172-177: no neighbour list to rebuild or overflow).  Each
stage's step reads and rewrites a tuple of static tensors; on the card it is
captured once as a CUDA graph (``md.graphed.GraphedStep``) and replayed a
step, the Langevin noise drawn outside it, xi then eta, from the stage's
generator; on the CPU the same step runs eagerly.  An NPT step takes its
pair virial from the step's own pair pass instead of a second one.  On the
card unless ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ai2bmd_torch import units
from ai2bmd_torch.data.protein_topology import build_topology
from ai2bmd_torch.io.pdb import PDBAtoms, read_pdb, write_pdb
from ai2bmd_torch.io.reorder import normalize_atom_order
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.md.graphed import stepper
from ai2bmd_torch.physics import mm as MM
from ai2bmd_torch.system import assign_nonbonded_params
from ai2bmd_torch.utils.device import resolve_device

WATER_DENSITY = 0.0334  # molecules / A^3 at 997 kg/m^3
TIP3P_R_OH = 0.9572
TIP3P_ANGLE = np.deg2rad(104.52)
CHUNK = 500                                   # steps a logged chunk (preprocess.py:235)
AMOEBA_CHUNK = 50                             # descent cycles a logged chunk (preprocess.py:333)
COMPRESSIBILITY = 4.6e-5 / 1.01325            # water, 1/bar
BAR_IN_EV_A3 = 1e5 * 1e-30 / 1.602176634e-19  # eV/A^3 per bar


def solvate(atoms: PDBAtoms, padding: float = 10.0, clash_dist: float = 2.4,
            seed: int = 0) -> PDBAtoms:
    """Embed the protein in a TIP3P box with neutralizing ions
    (``preprocess.py:43-127``)."""
    rng = np.random.default_rng(seed)
    pos = atoms.positions
    lo = pos.min(0) - padding
    hi = pos.max(0) + padding
    cell = hi - lo
    pos = pos - lo  # shift protein into [0, cell)

    spacing = WATER_DENSITY ** (-1.0 / 3.0)
    n_side = np.floor(cell / spacing).astype(int)
    waters = []
    for ix in range(n_side[0]):
        for iy in range(n_side[1]):
            for iz in range(n_side[2]):
                o = (np.array([ix, iy, iz]) + 0.5) * cell / n_side
                o = o + (rng.random(3) - 0.5) * 0.4
                waters.append(o)
    waters = np.array(waters)
    # cull clashes with protein heavy atoms
    heavy = pos[atoms.numbers > 1]
    d = np.linalg.norm(waters[:, None, :] - heavy[None, :, :], axis=-1)
    waters = waters[d.min(axis=1) > clash_dist]

    # neutralizing ions replace the waters farthest from the protein
    q_prot = assign_nonbonded_params(atoms)[0].sum()
    n_ions = int(round(abs(q_prot)))
    ion_name = "Na+" if q_prot < 0 else "Cl-"
    ion_z = 11 if q_prot < 0 else 17
    d_prot = np.linalg.norm(waters[:, None, :] - pos[None, :, :], axis=-1).min(axis=1)
    ion_slots = np.argsort(-d_prot)[:n_ions]
    ion_pos = waters[ion_slots]
    waters = np.delete(waters, ion_slots, axis=0)

    positions = [pos]
    names, resnames, resnums, numbers = (
        list(atoms.atom_names), list(atoms.residue_names), list(atoms.residue_numbers),
        list(atoms.numbers))
    next_res = int(atoms.residue_numbers.max())
    for o in waters:
        next_res += 1
        # random orientation
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ref = np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        h1 = o + TIP3P_R_OH * axis
        h2 = o + TIP3P_R_OH * (np.cos(TIP3P_ANGLE) * axis + np.sin(TIP3P_ANGLE) * u)
        positions.append(np.stack([o, h1, h2]))
        names += ["O", "H1", "H2"]
        resnames += ["WAT"] * 3
        resnums += [next_res] * 3
        numbers += [8, 1, 1]
    for ipos in ion_pos:
        next_res += 1
        positions.append(ipos[None])
        names.append(ion_name)
        resnames.append(ion_name)
        resnums.append(next_res)
        numbers.append(ion_z)

    return PDBAtoms(
        positions=np.concatenate(positions),
        numbers=np.array(numbers, np.int32),
        atom_names=np.array(names),
        residue_names=np.array(resnames),
        residue_numbers=np.array(resnums, np.int32),
        cell=cell,
    )


def npt_step(mm: MM.MMSystem, coeffs: L.LangevinCoeffs, masses: torch.Tensor,
             state: L.MDState, cell: torch.Tensor, taup_fs: float, **noise):
    """One step of the NPT stage (``preprocess.py:268-287``): a Langevin step
    of the dense MM at ``cell``, the pressure at the new positions, then the
    Berendsen scaling of positions and cell.  The pressure's pair virial is
    the step's own pair pass (the potential's carry holds it), the same
    number a second pass at those positions and that cell would give.
    ``noise`` is ``langevin_step``'s (``generator``, or ``xi`` and ``eta``).
    Returns (state, cell, pressure in bar)."""

    def potential(P, _):
        return MM.mm_energy_forces_virial_dense(mm, P, cell)   # the carry: the pair virial

    state = L.langevin_step(potential, coeffs, masses, state, **noise)
    ekin = L.kinetic_energy(masses, state.velocities)
    pres_bar = MM.pressure(mm, state.positions, cell, ekin, state.aux) / BAR_IN_EV_A3
    lam = (1.0 - COMPRESSIBILITY * (1.0 / taup_fs) * (1.0 - pres_bar)) ** (1.0 / 3.0)
    return dataclasses.replace(state, positions=state.positions * lam, aux=None), cell * lam, \
        pres_bar


def store(b, state: L.MDState) -> None:
    """Copy ``state``'s positions, velocities, forces and energy into the
    first four tensors of the buffer tuple ``b``."""
    for buf, t in zip(b, (state.positions, state.velocities, state.forces, state.energy)):
        buf.copy_(t)


def npt_body(mm: MM.MMSystem, coeffs: L.LangevinCoeffs, masses: torch.Tensor,
             taup_fs: float):
    """The NPT stage's step on a buffer tuple (positions, velocities, forces,
    energy, xi, eta, cell, pressure in bar), rewritten in place: what the
    stage captures and replays on the card."""

    def body(b):
        s, cell, p_bar = npt_step(mm, coeffs, masses, L.MDState(*b[:4]), b[6], taup_fs,
                                  xi=b[4], eta=b[5])
        store(b, s)
        b[6].copy_(cell)
        b[7].copy_(p_bar)

    return body


@dataclasses.dataclass
class Preprocessor:
    """The FF19SB protocol of ``preprocess.py:130-368``.  After ``run``:
    ``stages`` holds each stage's step count (evaluations for the
    minimization) and device ms (CUDA events on the card, the host clock on
    the CPU), ``energies`` the energy before and after the minimization and
    after each heat stage, ``temperatures`` T after each heat stage;
    ``mm``, ``minimized`` (the positions after the minimization),
    ``state`` and ``cell`` the last stage's, ``npt_pressures_bar`` each NPT
    chunk's mean and ``last_npt_pressure_bar`` the mean of their final
    half."""

    log_dir: str
    max_cyc: int = 100
    seed: int = 0
    padding: float = 10.0
    heat_stages: tuple = (50.0, 150.0, 300.0)
    heat_steps: int = 200
    nvt_steps: int = 400
    npt_steps: int = 4000        # Berendsen NPT stage (density convergence)
    taup_fs: float = 200.0       # barostat time constant
    target_temp: float = 300.0
    cutoff: float = 9.0
    restraint_kcal: float = 10.0
    method: str = "FF19SB"       # FF19SB (min/heat/NVT[/NPT]) | AMOEBA (minimize only)
    device: str | torch.device | None = None   # None: the card (raises without one)

    def run(self, prot_file: str, log=print) -> str:
        prot_name = os.path.basename(prot_file).rsplit(".", 1)[0]
        preeq = os.path.join(self.log_dir, f"{prot_name}-preeq.pdb")
        nowat = os.path.join(self.log_dir, f"{prot_name}-preeq-nowat.pdb")
        if os.path.exists(preeq) and os.path.exists(nowat):
            log(f"preprocessing outputs exist, skipping ({preeq})")
            return preeq
        device = resolve_device(self.device)

        atoms = normalize_atom_order(read_pdb(prot_file))
        log(f"solvating {prot_name} ({len(atoms)} atoms, {self.padding} A buffer)")
        box = solvate(atoms, padding=self.padding, seed=self.seed)
        n_prot = len(atoms)
        log(f"solvated: {len(box)} atoms, cell {np.round(box.cell, 2)}")
        self.stages, self.energies = {}, {}
        if self.method.upper() == "AMOEBA":
            return self._run_amoeba(box, n_prot, preeq, nowat, log, device)

        top = build_topology(box)
        self.mm = mm = MM.MMSystem.build(top, box.cell, cutoff=self.cutoff, device=device)
        self.temperatures = []
        P = torch.as_tensor(box.positions, dtype=torch.float32, device=device)
        masses = torch.as_tensor(top.masses, dtype=torch.float32, device=device)
        prot_mask = torch.zeros((top.n_atoms, 1), dtype=torch.float32, device=device)
        prot_mask[torch.as_tensor(top.protein_atoms, device=device)] = 1.0
        tether_ref = P
        k_tether = self.restraint_kcal * units.kcal_per_mol

        def potential(P, aux):
            e, f = MM.mm_energy_forces_dense(mm, P)
            # protein tether during preprocessing
            d = (P - tether_ref) * prot_mask
            return e + 0.5 * k_tether * (d * d).sum(), f - k_tether * d, aux

        # the stages' state: static tensors that each stage's step reads from
        # its argument and rewrites in place (on the card one captured graph a
        # stage; its warm-up runs on a copy)
        z3, z0 = lambda: torch.zeros_like(P), lambda: P.new_zeros(())
        md = (P.clone(), z3(), z3(), z0())          # positions, velocities, forces, energy
        noise = (z3(), z3())                        # xi, eta
        cell = torch.as_tensor(box.cell, dtype=torch.float32, device=device)

        # --- stage 1: restrained minimization (steepest descent, backtrack)
        def min_cycle(b):
            P, step_size, e_before, e_after = b
            e, f, _ = potential(P, None)
            P_new = P + torch.clamp(step_size * f, -0.2, 0.2)
            e_new, _, _ = potential(P_new, None)
            accept = e_new < e
            e_before.copy_(e)
            e_after.copy_(torch.where(accept, e_new, e))
            step_size.copy_(torch.where(accept, step_size * 1.2, step_size * 0.5))
            P.copy_(torch.where(accept, P_new, P))

        log(f"minimizing (max {self.max_cyc} cycles)")
        if self.max_cyc:
            b = (md[0], torch.tensor(1e-3, device=device), z0(), md[3])
            step = stepper(min_cycle, b)
            with self._stage("minimize", 2 * self.max_cyc, device):
                for i in range(self.max_cyc):
                    step()
                    if i == 0:
                        e_start = float(b[2])
                    if i % 20 == 0:
                        log(f"  min cycle {i}: E = {float(md[3]):.2f} eV")
            self.energies["minimize"] = (e_start, float(md[3]))
        self.minimized = md[0].clone()

        # --- stage 2: heat (Berendsen NVT ramp, tethered protein)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        md[1].copy_(L.maxwell_boltzmann_velocities(generator, top.masses,
                                                   self.heat_stages[0] / 2))
        e, f, _ = potential(md[0], None)
        store(md, L.MDState(md[0], md[1], f, e))

        def heat_step(b):
            store(b, L.berendsen_step(potential, 1.0, b[4], 100.0, masses, L.MDState(*b[:4])))

        temp = z0()
        heat = stepper(heat_step, (*md, temp)) if self.heat_steps else None
        for t in self.heat_stages:
            log(f"heating to {t} K ({self.heat_steps} steps)")
            temp.fill_(t)
            with self._stage(f"heat {t:g} K", self.heat_steps, device):
                for _ in range(self.heat_steps):
                    heat()
            t_now = float(L.temperature(masses, md[1]))
            self.temperatures.append(t_now)
            self.energies[f"heat {t:g} K"] = float(md[3])
            log(f"  T = {t_now:.1f} K, E = {float(md[3]):.2f} eV")

        # --- stage 3: NVT equilibration (Langevin), whole chunks as JAX runs them
        coeffs = L.LangevinCoeffs.build(top.masses, 1.0, self.target_temp, 0.002, device=device)

        def draw():
            for out in noise:     # xi, then eta: langevin_step's order
                torch.randn(out.shape, generator=generator, out=out)

        def nvt_step(b):
            store(b, L.langevin_step(potential, coeffs, masses, L.MDState(*b[:4]), xi=b[4],
                                     eta=b[5]))

        log(f"NVT equilibration ({self.nvt_steps} steps)")
        nvt = stepper(nvt_step, (*md, *noise)) if self.nvt_steps > 0 else None
        done = 0
        while done < self.nvt_steps:
            with self._stage("NVT", CHUNK, device):
                for _ in range(CHUNK):
                    draw()
                    nvt()
            done += CHUNK
            log(f"  [{min(done, self.nvt_steps)}/{self.nvt_steps}] "
                f"T = {float(L.temperature(masses, md[1])):.1f} K, "
                f"E = {float(md[3]):.2f} eV")

        # --- stage 4 (optional): Berendsen-barostat NPT with dynamic-cell PME
        # (the reference's final sander NPT stage, preprocess.py:435-479)
        if self.npt_steps > 0:
            log(f"NPT equilibration ({self.npt_steps} steps)")
            pres_bar = z0()
            step = stepper(npt_body(mm, coeffs, masses, self.taup_fs),
                            (*md, *noise, cell, pres_bar))
            done = 0
            self.npt_pressures_bar = []
            while done < self.npt_steps:
                pres = []
                with self._stage("NPT", min(CHUNK, self.npt_steps), device):
                    for _ in range(min(CHUNK, self.npt_steps)):
                        draw()
                        step()
                        pres.append(pres_bar.clone())
                done += CHUNK
                # chunk-mean instantaneous pressure: single-step values
                # fluctuate by hundreds of bar on small boxes
                self.npt_pressures_bar.append(float(torch.stack(pres).mean()))
                log(f"  [{min(done, self.npt_steps)}/{self.npt_steps}] "
                    f"cell = {np.round(cell.cpu().numpy(), 2)}, "
                    f"<P> = {self.npt_pressures_bar[-1]:.1f} bar")
            # converged-stage pressure: mean over the final half of NPT
            half = self.npt_pressures_bar[len(self.npt_pressures_bar) // 2:]
            self.last_npt_pressure_bar = float(np.mean(half))
            log(f"NPT final-half <P> = {self.last_npt_pressure_bar:.1f} bar")
            box.cell = cell.cpu().numpy().astype(np.float64)
        self.state, self.cell = L.MDState(*md), cell

        # --- outputs ---
        return self._write_outputs(box, md[0].cpu().numpy(), n_prot, preeq, nowat, log)

    def _run_amoeba(self, box, n_prot, preeq, nowat, log, device) -> str:
        """AMOEBA preprocessing (``preprocess.py:318-352``): the solvated box
        minimized with the whole AMOEBA force field (mutual polarization,
        Ewald induction) in chunks of 50 descent cycles, each followed by one
        fresh evaluation and its log line, until the RMS force is under the
        reference's 0.1 kcal/mol/A (Tinker minimize9,
        src/AIMD/preprocess.py:184-244); no heat, NVT or NPT stage.  Keeps
        ``md`` (the ``AmoebaMD``), ``chunks`` (cycles done, E in eV, RMS |F|
        in kcal/mol/A after each chunk), ``minimized``, ``energies`` and
        ``stages["AMOEBA minimize"]`` (evaluations, device ms; the first
        chunk's includes the descent cycle's capture)."""
        from ai2bmd_torch.physics.amoeba_md import AmoebaMD

        cutoff = min(self.cutoff, 0.5 * float(np.min(box.cell)) - 1.1)
        log(f"AMOEBA minimization (mutual polarization, Ewald induction, "
            f"cutoff {cutoff:.1f} A, max {self.max_cyc} cycles)")
        self.md = md = AmoebaMD.build(box, cutoff=cutoff, induction="ewald", device=device)
        P = box.positions.astype(np.float32)
        rms_target = 0.1 * units.kcal_per_mol      # minimize9's 0.1 kcal/mol/A
        self.chunks = []
        done, e_first = 0, None
        while done < self.max_cyc:
            n = min(AMOEBA_CHUNK, self.max_cyc - done)
            with self._stage("AMOEBA minimize", 2 * n, device):
                P, energies = md.minimize(P, steps=n, chunk=n)
            if e_first is None:
                e_first = energies[0]
            done += n
            Pt = torch.as_tensor(P, device=device)
            e, f, _ = md(Pt, md.init_aux(Pt))
            rms = float(torch.sqrt((f * f).sum(-1).mean()))
            self.chunks.append((done, float(e), rms / units.kcal_per_mol))
            log(f"  [{done}/{self.max_cyc}] E = {float(e):.2f} eV, "
                f"RMS |F| = {rms / units.kcal_per_mol:.3f} kcal/mol/A")
            if rms < rms_target:
                log("  converged to the reference RMS-gradient criterion")
                break
        if self.chunks:
            self.energies["minimize"] = (e_first, self.chunks[-1][1])
        self.minimized = torch.as_tensor(P, device=device)
        return self._write_outputs(box, np.asarray(P, np.float64), n_prot, preeq, nowat, log)

    @contextlib.contextmanager
    def _stage(self, name: str, steps: int, device: torch.device):
        """Add the block's steps and device ms to ``stages[name]``."""
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            yield
            ms = (time.perf_counter() - t0) * 1e3
        rec = self.stages.setdefault(name, dict(steps=0, ms=0.0))
        rec["steps"] += steps
        rec["ms"] += ms

    def _write_outputs(self, box, final, n_prot, preeq, nowat, log) -> str:
        write_pdb(preeq, box, positions=final)
        prot_only = PDBAtoms(
            positions=final[:n_prot],
            numbers=box.numbers[:n_prot],
            atom_names=box.atom_names[:n_prot],
            residue_names=box.residue_names[:n_prot],
            residue_numbers=box.residue_numbers[:n_prot],
            cell=box.cell,
        )
        write_pdb(nowat, prot_only)
        log(f"wrote {preeq} and {nowat}")
        return preeq
