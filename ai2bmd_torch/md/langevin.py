"""Langevin dynamics with ASE-compatible semantics.

Port of ``ai2bmd_tpu/md/langevin.py``: the Vanden-Eijnden / Ciccotti
integrator exactly as ASE's ``Langevin``, its replica-batched form, the
Maxwell-Boltzmann velocity draw, the kinetic energy and the temperature;
and the two steps preprocessing takes besides, NVE velocity Verlet (RATTLE
under a constraint) and the Berendsen thermostat.
The noise of a step comes from an explicit
``torch.Generator`` (one per replica in the batched form) unless the caller
passes it in (``xi``, ``eta``), which is how the tests feed both packages the
same numbers: torch's and JAX's generators differ.

Units: ASE internal (A, eV, amu, time = A*sqrt(amu/eV)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ai2bmd_torch.host import units
from ai2bmd_torch.utils.device import resolve_device


@dataclasses.dataclass
class MDState:
    positions: torch.Tensor    # [N,3] A
    velocities: torch.Tensor   # [N,3] A / internal time
    forces: torch.Tensor       # [N,3] eV/A at `positions`
    energy: torch.Tensor       # scalar eV
    step: int = 0
    aux: Any = None            # potential-side carry: cap offsets, or a tuple
    #                            (cell buckets, cap offsets) on solvated runs


def lift_potential(potential: Callable) -> Callable:
    """A stateless P -> (E, F) potential in the stateful (P, aux) -> (E, F,
    aux) protocol the integrators use."""

    def wrapped(P, aux):
        e, f = potential(P)
        return e, f, aux

    return wrapped


@dataclasses.dataclass(frozen=True)
class LangevinCoeffs:
    dt: float
    c1: float
    c2: float
    c3: torch.Tensor   # [N,1]
    c4: torch.Tensor   # [N,1]
    c5: torch.Tensor   # [N,1]

    @classmethod
    def build(cls, masses, timestep_fs: float, temp_K: float, friction_per_fs: float,
              device=None, dtype=torch.float32) -> "LangevinCoeffs":
        """``device`` None means the card (raises without one)."""
        device = resolve_device(device)
        dt = timestep_fs * units.fs
        fr = friction_per_fs / units.fs
        T = temp_K * units.kB
        sigma = np.sqrt(2.0 * T * fr / np.asarray(masses, np.float64))[:, None]
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(
            dt=dt,
            c1=dt / 2.0 - dt * dt * fr / 8.0,
            c2=dt * fr / 2.0 - dt * dt * fr * fr / 8.0,
            c3=t(math.sqrt(dt) * sigma / 2.0 - dt ** 1.5 * fr * sigma / 8.0),
            c4=t(fr / 2.0 * (dt ** 1.5 * sigma / (2.0 * math.sqrt(3.0)))),
            c5=t(dt ** 1.5 * sigma / (2.0 * math.sqrt(3.0))),
        )


def maxwell_boltzmann_velocities(generator: torch.Generator, masses, temp_K: float,
                                 dtype=torch.float32) -> torch.Tensor:
    """Velocities [N,3] on the generator's device."""
    m = torch.as_tensor(np.asarray(masses), dtype=dtype, device=generator.device)[:, None]
    std = torch.sqrt(temp_K * units.kB / m)
    return std * torch.randn((len(masses), 3), generator=generator, dtype=dtype,
                             device=generator.device)


def _mass_column(masses, like: torch.Tensor) -> torch.Tensor:
    """masses [N] (array or tensor) as a [N,1] tensor of ``like``'s dtype and
    device."""
    return torch.as_tensor(masses, dtype=like.dtype, device=like.device)[:, None]


def kinetic_energy(masses, velocities: torch.Tensor) -> torch.Tensor:
    """0.5 * sum m v^2 (eV) over every atom, as a 0-d tensor."""
    return 0.5 * (_mass_column(masses, velocities) * velocities * velocities).sum()


def temperature(masses, velocities: torch.Tensor) -> torch.Tensor:
    """Instantaneous temperature (K) of velocities [N,3]: 2 Ekin / (3 N kB)."""
    return 2.0 * kinetic_energy(masses, velocities) / (3.0 * velocities.shape[0] * units.kB)


def langevin_step(potential: Callable, coeffs: LangevinCoeffs, masses: torch.Tensor,
                  state: MDState, fixcm: bool = True, xi: torch.Tensor | None = None,
                  eta: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, constraint=None) -> MDState:
    """One Langevin step (two half-kicks around the position update).

    ``potential`` has the stateful protocol (P, aux) -> (E, F, aux);
    ``masses`` is [N] on the positions' device.  Without ``xi``/``eta`` the
    two standard normals are drawn from ``generator``, xi first.  The state
    may carry leading replica axes ([..., N,3]); fixcm then takes each
    replica's own centre of mass (``langevin_step_batched``).
    ``constraint`` (e.g. ``md.settle.SettleConstraint``, one trajectory
    only) has ``positions(x_old, x_new)`` and ``velocities(x, v)``: the
    positions are projected after the drift, with the matching velocity
    correction (RATTLE), and the velocities after the last kick
    (``langevin.py:117-149``)."""
    shape = state.positions.shape
    if xi is None or eta is None:
        if generator is None:
            raise ValueError("langevin_step needs either xi and eta or a generator")
        draw = lambda: torch.randn(shape, generator=generator, dtype=state.positions.dtype,
                                   device=state.positions.device)
        xi, eta = draw(), draw()
    m = masses[:, None]
    v = state.velocities
    v = v + (coeffs.c1 * state.forces / m - coeffs.c2 * v + coeffs.c3 * xi - coeffs.c4 * eta)
    x = state.positions + coeffs.dt * v + coeffs.c5 * eta
    if constraint is not None:
        x_c = constraint.positions(state.positions, x)
        v = v + (x_c - x) / coeffs.dt
        x = x_c
    if fixcm:
        x = x - ((x - state.positions) * m).sum(-2, keepdim=True) / m.sum()
    energy, f_new, aux = potential(x, state.aux)
    v = v + (coeffs.c1 * f_new / m - coeffs.c2 * v + coeffs.c3 * xi - coeffs.c4 * eta)
    if constraint is not None:
        v = constraint.velocities(x, v)
    return MDState(positions=x, velocities=v, forces=f_new, energy=energy,
                   step=state.step + 1, aux=aux)


def langevin_step_batched(potential: Callable, coeffs: LangevinCoeffs, masses: torch.Tensor,
                          state: MDState, fixcm: bool = True, xi: torch.Tensor | None = None,
                          eta: torch.Tensor | None = None,
                          generators: list[torch.Generator] | None = None) -> MDState:
    """One Langevin step of Rl replicas (``langevin.py:141-181``): every state
    tensor has a leading replica axis (energy [Rl]), and ``potential`` maps
    (Ps [Rl,N,3], aux) -> (E [Rl], F [Rl,N,3], aux), so the force evaluation
    batches across replicas.  Without ``xi``/``eta`` ([Rl,N,3]) replica r
    draws xi, then eta, from ``generators[r]``, as ``langevin_step`` draws
    from its generator: a replica follows the trajectory it would follow
    alone with the same generator."""
    shape = state.positions.shape
    if xi is None or eta is None:
        if generators is None or len(generators) != shape[0]:
            raise ValueError(
                f"langevin_step_batched needs xi and eta or {shape[0]} generators, one a replica")
        draw = lambda g: torch.randn(shape[1:], generator=g, dtype=state.positions.dtype,
                                     device=state.positions.device)
        noise = [(draw(g), draw(g)) for g in generators]
        xi = torch.stack([a for a, _ in noise])
        eta = torch.stack([b for _, b in noise])
    return langevin_step(potential, coeffs, masses, state, fixcm, xi, eta)


def velocity_verlet_step(potential: Callable, dt_fs: float, masses: torch.Tensor,
                         state: MDState, constraint=None) -> MDState:
    """NVE velocity Verlet (``langevin.py:184-203``); with ``constraint``
    (e.g. SETTLE) its RATTLE variant: the positions projected after the
    drift, with the matching velocity correction, and the velocities after
    the last half-kick."""
    dt = dt_fs * units.fs
    m = masses[:, None]
    v_half = state.velocities + 0.5 * dt * state.forces / m
    x = state.positions + dt * v_half
    if constraint is not None:
        x_c = constraint.positions(state.positions, x)
        v_half = v_half + (x_c - x) / dt
        x = x_c
    energy, f_new, aux = potential(x, state.aux)
    v = v_half + 0.5 * dt * f_new / m
    if constraint is not None:
        v = constraint.velocities(x, v)
    return MDState(positions=x, velocities=v, forces=f_new, energy=energy,
                   step=state.step + 1, aux=aux)


def berendsen_step(potential: Callable, dt_fs: float, temp_K: float, taut_fs: float,
                   masses: torch.Tensor, state: MDState) -> MDState:
    """One velocity-Verlet step after the Berendsen rescaling of the
    velocities towards ``temp_K`` with time constant ``taut_fs``
    (``langevin.py:206-224``)."""
    dt = dt_fs * units.fs
    m = masses[:, None]
    t_inst = temperature(masses, state.velocities)
    lam = torch.sqrt(1.0 + (dt_fs / taut_fs) * (temp_K / torch.clamp(t_inst, min=1e-6) - 1.0))
    v_half = state.velocities * lam + 0.5 * dt * state.forces / m
    x = state.positions + dt * v_half
    energy, f_new, aux = potential(x, state.aux)
    v = v_half + 0.5 * dt * f_new / m
    return MDState(positions=x, velocities=v, forces=f_new, energy=energy,
                   step=state.step + 1, aux=aux)
