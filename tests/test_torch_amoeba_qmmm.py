"""AMOEBA subtractive QM/MM in the port (ai2bmd_torch.physics.qmmm with
mm_backend="amoeba": the polarizable solvent the reference runs through
Tinker9, src/Calculators/tinker_async.py:127-145) against the JAX package's,
on the CPU.

The box: tests/test_qmmm_amoeba.py's synthetic solvated Chignolin (175
protein atoms and 24 lattice waters, 247 atoms), cutoff 6 A, K = 256, the QM
term a harmonic tether (a differentiable stand-in).  JAX compiles the whole
AMOEBA step in minutes on the CPU (324 s in float64 when measured, one
compile), over the tier's budget: the step against JAX is marked slow, and
the functions it is made of are held against JAX in tier 1 by
tests/test_torch_amoeba.py (the permanent and vdW energies with their
gradients, the mutual operator, the induction functional and its
gradient, the p-vs-d correction, the mesh, the assignment).  Here in tier 1:
the port's float32 step against its float64 step within JAX's own float32
spread on this box (tools/amoeba_f32_spread.py), the combiner and the
carried dipoles, and the slice from a PDB with ViSNet 2 x 32 as the QM
term."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.physics.qmmm import QMMMPotential as JQMMM
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.io import pdb as TPDB
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.physics import qmmm as TQ
from test_qmmm_amoeba import _synthetic_solvated

# JAX's float32 against float64 on this box (tools/amoeba_f32_spread.py, the
# builder's run on the CPU): max|dF| 7.15e-5 eV/A on solvent atoms, 2.59e-5
# on protein atoms, |dE| 1.22e-4 eV
JAX_F32_SPREAD = dict(solvent=7.15e-5, protein=2.59e-5, energy=1.22e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_atoms(atoms):
    return TPDB.PDBAtoms(positions=atoms.positions, numbers=atoms.numbers,
                         atom_names=atoms.atom_names, residue_names=atoms.residue_names,
                         residue_numbers=atoms.residue_numbers, cell=atoms.cell)


@pytest.fixture(scope="module")
def synthetic():
    atoms, n_p, _ = _synthetic_solvated()
    return atoms, _port_atoms(atoms), n_p


def _tether(ref):
    return lambda P: (0.5 * ((P - ref) ** 2).sum(), -(P - ref))


def _port_qmmm(t_atoms, n_p, dtype):
    ref = torch.as_tensor(t_atoms.positions[:n_p], dtype=dtype)
    return TQ.QMMMPotential.build(t_atoms, _tether(ref), mm_backend="amoeba", cutoff=6.0,
                                  k_neighbors=256, device="cpu", dtype=dtype)


def test_float32_step_within_jax_spread_and_the_combiner(synthetic):
    """One call in float32 against float64 at the geometry JAX's spread was
    measured at: forces on solvent and protein atoms within twice JAX's own
    float32 spread on this box (the port's reads 7.19e-5 and 3.21e-5 eV/A),
    E within four times (the port's float32 sums run in another order:
    3.66e-4 eV, three times JAX's).  The call is E_full + E_QM - E_prot and
    F_full + the stitched protein difference, from the nl route's pieces;
    the carry holds the dipole pairs of the full box and of the protein, and
    a second call warm-started from them gives the same E."""
    _, t_atoms, n_p = synthetic
    X = t_atoms.positions
    out = {}
    for dt in (torch.float64, torch.float32):
        q = _port_qmmm(t_atoms, n_p, dt)
        P = torch.as_tensor(X, dtype=dt)
        aux = q.init_aux(P)
        assert q.backend == "nl" and q.amoeba is not None and len(aux) == 3
        out[dt] = q(P, aux)
    e64, f64, aux64 = out[torch.float64]
    e32, f32, _ = out[torch.float32]
    df = (f32.double() - f64).abs().max(-1).values.numpy()
    assert df[n_p:].max() <= 2 * JAX_F32_SPREAD["solvent"], df[n_p:].max()
    assert df[:n_p].max() <= 2 * JAX_F32_SPREAD["protein"], df[:n_p].max()
    assert abs(float(e32) - float(e64)) <= 4 * JAX_F32_SPREAD["energy"]

    q = _port_qmmm(t_atoms, n_p, torch.float64)
    P = torch.as_tensor(X, dtype=torch.float64)
    nl, _, (cf, cp) = q.init_aux(P)
    e2, f2, nl2, cf2 = q.mm_full_energy_forces(P, nl, cf)
    e1, f1, cp2 = q.mm_prot_energy_forces(P[q.sel], cp)
    eq, fq = _tether(torch.as_tensor(t_atoms.positions[:n_p]))(P[q.sel])
    assert float(e64) == pytest.approx(float(e2 + eq - e1), rel=1e-12)
    want = f2.clone()
    want[q.sel] += fq - f1
    np.testing.assert_allclose(f64.numpy(), want.numpy(), rtol=0, atol=1e-12)
    (md, mp), (md_p, mp_p) = aux64[2]
    assert md.shape == (len(X), 3) and md_p.shape == (n_p, 3)
    np.testing.assert_allclose(md.numpy(), cf2[0].numpy(), rtol=0, atol=1e-12)
    assert float(md.abs().max()) > 1e-3 and float((md - mp).abs().max()) > 0.0
    e_warm, _, _ = q(P, aux64)
    assert float(e_warm) == pytest.approx(float(e64), rel=1e-6)


def test_the_slice_with_visnet_2x32_runs_from_a_pdb(synthetic, tmp_path):
    """ProteinSimulation.from_pdb(mm_backend="amoeba") on the box written as
    a PDB, ViSNet 2 x 32 (random weights) as the QM term on the CPU: the
    QM/MM potential takes the AMOEBA backend on the nl route, two Langevin
    steps run, and the carry's dipoles and list stay finite, without
    overflow."""
    _, t_atoms, n_p = synthetic
    pdb = str(tmp_path / "box.pdb")
    TPDB.write_pdb(pdb, t_atoms)
    ps = TSIM.ProteinSimulation.from_pdb(
        pdb, log_dir=str(tmp_path / "run"), mm_backend="amoeba",
        model_cfg=TV.ViSNetConfig(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8),
        sim_cfg=TS.SimulationConfig(preeq_steps=0, record_per_steps=1, timestep_fs=0.25),
        device="cpu")
    assert ps.qmmm.amoeba is not None and ps.qmmm.backend == "nl"
    assert len(ps.qmmm.sel) == n_p
    state = ps.simulate(2, log=lambda *a: None)
    nl, _, ((md, mp), _) = state.aux
    assert not bool(nl.overflow)
    assert torch.isfinite(state.forces).all() and torch.isfinite(md).all()
    assert float(md.abs().max()) > 0.0


@pytest.mark.slow
def test_amoeba_qmmm_steps_match_jax_in_float64(synthetic):
    """Two Langevin steps of the AMOEBA QM/MM step on JAX's noise, float64 on
    both sides (JAX under jax_enable_x64, one compile of its whole step),
    from the port's step-0 evaluation: energy within 1e-8 relative, forces
    within 1e-7 of the largest, the carried dipoles (mu_d, mu_p) of the full
    box and of the protein within 1e-9 e A, positions within 1e-9 A."""
    j_atoms, t_atoms, n_p = synthetic
    masses = t_atoms.masses
    q = _port_qmmm(t_atoms, n_p, torch.float64)
    P = torch.as_tensor(t_atoms.positions, dtype=torch.float64)
    e0, f0, aux = q(P, q.init_aux(P))
    key = jax.random.PRNGKey(2)
    with jax.enable_x64(True):
        ref = jnp.asarray(j_atoms.positions[:n_p])
        jq = JQMMM.build(j_atoms, qm_energy_forces=lambda Pq: (0.5 * jnp.sum((Pq - ref) ** 2),
                                                              -(Pq - ref)),
                         mm_backend="amoeba", cutoff=6.0, k_neighbors=256)
        Pj = jnp.asarray(j_atoms.positions, jnp.float64)
        aux_j = jax.tree.map(lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
                             jq.init_aux(Pj))
        aux_j = (aux_j[0], aux_j[1], jax.tree.map(lambda a: jnp.asarray(a.numpy()), aux[2]))
        vel = JL.maxwell_boltzmann_velocities(key, masses, 300.0, jnp.float64)
        cj = JL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001)
        sj = JL.MDState(Pj, vel, jnp.asarray(f0.numpy()), jnp.asarray(float(e0)), key,
                        jnp.asarray(0, jnp.int32), aux=aux_j)
        step = jax.jit(lambda s: JL.langevin_step(jq, cj, masses, s))
        states = [step(sj)]
        states.append(step(states[0]))
        noise = []
        for _ in range(2):
            _, k1, k2 = jax.random.split(key, 3)
            key = jax.random.split(key, 3)[0]
            noise.append([torch.as_tensor(np.asarray(jax.random.normal(kk, Pj.shape,
                                                                       jnp.float64)))
                          for kk in (k1, k2)])
        states = jax.tree.map(lambda a: np.asarray(a), states)
    ct = TL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001, device="cpu", dtype=torch.float64)
    st = TL.MDState(P, torch.as_tensor(np.asarray(vel)), f0, e0, aux=aux)
    m = torch.as_tensor(masses, dtype=torch.float64)
    for (xi, eta), sj in zip(noise, states):
        st = TL.langevin_step(q, ct, m, st, xi=xi, eta=eta)
        np.testing.assert_allclose(st.positions.numpy(), sj.positions, rtol=0, atol=1e-9)
        assert float(st.energy) == pytest.approx(float(sj.energy), rel=1e-8)
        np.testing.assert_allclose(st.forces.numpy(), sj.forces, rtol=0,
                                   atol=1e-7 * np.abs(sj.forces).max())
        for got, want in zip(jax.tree.leaves(tuple(t.numpy() for pair in st.aux[2]
                                                   for t in pair)),
                             jax.tree.leaves(sj.aux[2])):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
