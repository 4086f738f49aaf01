"""The port's test-scale AMOEBA engines (ai2bmd_torch.physics.amoeba's
AmoebaWaterSystem, AmoebaWaterBox and molecular_dipole_debye;
amoeba_protein's AmoebaVacuumSystem) against the JAX package's, on the CPU
in float64 (JAX under jax.enable_x64).

Inputs: 2 and 8 AMOEBA waters on a lattice with random orientations and a
jitter from a seed (tests/test_amoeba_md.py's builder), the 8 in their
periodic 6.2 A cell for the box (cutoffs 3 A, mesh spacing 0.6 A), and
ACE-ALA-ALA-NME perturbed from a seed.  Energies 1e-8 relative, forces 1e-7
of the largest component."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.data.protein_topology import build_topology as j_build_topology
from ai2bmd_tpu.io.build import build_polyalanine
from ai2bmd_tpu.physics import amoeba as JA
from ai2bmd_tpu.physics.amoeba_protein import AmoebaVacuumSystem as JVacuum
from ai2bmd_tpu.physics.amoeba_protein import assign_amoeba as j_assign
from ai2bmd_torch.physics import amoeba as TA
from ai2bmd_torch.physics.amoeba_protein import AmoebaVacuumSystem as TVacuum
from test_amoeba_md import _water_box_atoms

E_REL, F_REL = 1e-8, 1e-7


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_qmmm.py's): the workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(j_energy, t_energy_forces, P):
    """JAX's jitted value and gradient against the port's energy_forces."""
    with jax.enable_x64(True):
        e_j, g_j = jax.jit(jax.value_and_grad(j_energy))(jnp.asarray(P))
        e_j, g_j = float(e_j), np.asarray(g_j)
    e, f = t_energy_forces(torch.as_tensor(P))
    assert float(e) == pytest.approx(e_j, rel=E_REL)
    assert np.abs(f.numpy() + g_j).max() < F_REL * np.abs(g_j).max()


def _waters():
    atoms = _water_box_atoms(n_side=2, spacing=3.1, jitter=0.05)
    return atoms, len(atoms) // 3


@pytest.mark.parametrize("nw", [2, 8])
def test_water_system_matches_jax(nw):
    """AmoebaWaterSystem in vacuum (the first nw waters of the lattice;
    intermolecular multipoles, 20 SOR sweeps of Thole induction, buffered
    14-7, the water bond and angle): the energy and forces, and each
    water's permanent dipole in Debye."""
    P = _waters()[0].positions[:3 * nw]
    with jax.enable_x64(True):
        js = JA.AmoebaWaterSystem.build(nw, sor_iters=20)
        dip_j = [float(JA.molecular_dipole_debye(js, jnp.asarray(P), m)) for m in range(nw)]
    ts = TA.AmoebaWaterSystem.build(nw, sor_iters=20, device="cpu", dtype=torch.float64)
    _compare(js.energy, ts.energy_forces, P)
    dip = [float(TA.molecular_dipole_debye(ts, torch.as_tensor(P), m)) for m in range(nw)]
    np.testing.assert_allclose(dip, dip_j, rtol=1e-12)
    assert 1.6 < dip[0] < 1.9          # AMOEBA water's ~1.77 D, distorted by the jitter


def test_water_box_matches_jax():
    """AmoebaWaterBox, 8 waters in their periodic cell: the multipole SPME
    with the intramolecular erf part removed, real-space Thole induction
    and buffered 14-7 within 3 A, the water bond and angle."""
    atoms, nw = _waters()
    kw = dict(cutoff=3.0, vdw_cutoff=3.0, sor_iters=20, grid_spacing=0.6)
    with jax.enable_x64(True):
        jb = JA.AmoebaWaterBox.build(nw, atoms.cell, **kw)
    tb = TA.AmoebaWaterBox.build(nw, atoms.cell, device="cpu", dtype=torch.float64, **kw)
    assert tb.pme.grid == jb.pme.grid
    _compare(jb.energy, tb.energy_forces, atoms.positions)


def test_vacuum_system_matches_jax():
    """AmoebaVacuumSystem on ACE-ALA-ALA-NME: multipoles scaled by the
    mpole scales, group-masked SOR with the p-scaled energy field, vdW
    scaled by the vdW scales; and the terms one by one."""
    a = build_polyalanine(2)
    asg = j_assign(a.atom_names, a.residue_names, a.positions, j_build_topology(a).bonds)
    P = a.positions + np.random.default_rng(3).normal(0.0, 0.03, a.positions.shape)
    js = JVacuum(asg, sor_iters=20)
    ts = TVacuum(asg, sor_iters=20, device="cpu", dtype=torch.float64)
    _compare(js.energy, ts.energy_forces, P)
    with jax.enable_x64(True):
        ref = jax.jit(lambda p: (js.permanent_energy(p), js.polarization_energy(p),
                                 js.vdw_energy(p)))(jnp.asarray(P))
    mine = (ts.permanent_energy(torch.as_tensor(P)), ts.polarization_energy(torch.as_tensor(P)),
            ts.vdw_energy(torch.as_tensor(P)))
    for m, r in zip(mine, ref):
        assert float(m) == pytest.approx(float(r), rel=E_REL)


def test_engines_default_to_the_card(monkeypatch):
    a = build_polyalanine(2)
    asg = j_assign(a.atom_names, a.residue_names, a.positions, j_build_topology(a).bonds)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TA.AmoebaWaterSystem.build(2), lambda: TVacuum(asg),
                 lambda: TA.AmoebaWaterBox.build(8, np.full(3, 6.2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
