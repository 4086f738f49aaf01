"""The port's integrators, restraints and Simulator (ai2bmd_torch.md) against
the JAX package (ai2bmd_tpu.md), on the CPU in float32.

Parity tests feed both packages the same seeded numpy inputs and the port
the noise JAX draws (the keys split as ai2bmd_tpu/md/langevin.py:108-111
splits them).  The behaviour tests are tests/test_md.py's, run on the port
with its own generators: a 27-atom LJ argon cluster (NVE drift,
thermalization, fixed centre of mass, Maxwell-Boltzmann statistics, the
Simulator's files, bitwise restart continuity on the CPU, the runaway
guard)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.md import constraints as JC
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.md import simulation as JS
from ai2bmd_tpu.physics import nonbonded as JN
from ai2bmd_torch.frag.indexer import build_fragment_index
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import constraints as TC
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.physics import nonbonded as TN

T = lambda a: torch.as_tensor(np.array(a))
KCAL = 0.04336410390059322          # eV per kcal/mol


def _jax_noise(key, shape):
    """(xi, eta) that JAX's langevin_step draws from ``key``."""
    _, k1, k2 = jax.random.split(key, 3)
    return (jax.random.normal(k1, shape, jnp.float32), jax.random.normal(k2, shape, jnp.float32))


def _harmonic_jax(P):
    return 0.5 * jnp.sum(P * P) * 0.2, -0.2 * P


def _harmonic_torch(P):
    return 0.5 * (P * P).sum() * 0.2, -0.2 * P


def _toy_state(rng, n=12):
    P = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    v = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    masses = rng.uniform(1.0, 16.0, n).astype(np.float32)
    return P, v, masses


def test_kinetic_energy_and_temperature_match_jax(rng):
    """Tolerance 1e-6 relative (float32 sums of 12 atoms)."""
    _, v, masses = _toy_state(rng)
    ek_j, t_j = JL.kinetic_energy(masses, jnp.asarray(v)), JL.temperature(masses, jnp.asarray(v))
    ek_t, t_t = TL.kinetic_energy(T(masses), T(v)), TL.temperature(masses, T(v))
    assert float(ek_t) == pytest.approx(float(ek_j), rel=1e-6)
    assert float(t_t) == pytest.approx(float(t_j), rel=1e-6)


@pytest.mark.parametrize("friction", [0.0, 0.01])
def test_langevin_step_on_a_harmonic_well_matches_jax(rng, friction):
    """Five Langevin steps of a harmonic well (friction 0 is the NVE
    velocity-Verlet limit), the port fed JAX's noise.  Tolerance 1e-6 A and
    A/t (float32 over 5 steps)."""
    P, v, masses = _toy_state(rng)
    e0, f0 = _harmonic_jax(jnp.asarray(P))
    sj = JL.MDState(jnp.asarray(P), jnp.asarray(v), f0, e0, jax.random.PRNGKey(3), 0)
    st = TL.MDState(T(P), T(v), T(f0), T(e0))
    cj = JL.LangevinCoeffs.build(masses, 1.0, 300.0, friction)
    ct = TL.LangevinCoeffs.build(masses, 1.0, 300.0, friction, device="cpu")
    for _ in range(5):
        xi, eta = _jax_noise(sj.key, P.shape)
        sj = JL.langevin_step(JL.lift_potential(_harmonic_jax), cj, masses, sj)
        st = TL.langevin_step(TL.lift_potential(_harmonic_torch), ct, T(masses), st, xi=T(xi),
                              eta=T(eta))
    assert st.step == 5
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.velocities.numpy(), np.asarray(sj.velocities), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def chig_pair(chig_protein):
    """Both packages' Chignolin Simulators with the nonbonded "mm" term as
    the base potential and the H-bond restraint; positions perturbed by 0.15
    A (seed 0) so that the restraint pulls."""
    rng = np.random.default_rng(0)
    P = (chig_protein.positions + rng.normal(scale=0.15, size=chig_protein.positions.shape)
         ).astype(np.float32)
    excl = build_fragment_index(chig_protein.atoms).exclusion_mask()
    nb_j = JN.NonbondedParams.build(chig_protein, excl)
    nb_t = TN.NonbondedParams.build(chig_protein, excl, device="cpu")
    hb_j = JC.BondRestraint.find_hydrogen_bonds(chig_protein.atoms)
    hb_t = TC.BondRestraint.find_hydrogen_bonds(chig_protein.atoms, device="cpu")
    return P, nb_j, nb_t, hb_j, hb_t


def test_find_hydrogen_bonds_matches_jax(chig_pair, chig_protein):
    """The same (hydrogen, partner) pairs, thresholds and constants: one pair
    for each of Chignolin's 78 hydrogens."""
    _, _, _, hb_j, hb_t = chig_pair
    assert hb_t.pairs.dtype == torch.int64 and len(hb_t.pairs) == 78
    assert (chig_protein.numbers[hb_t.pairs[:, 0].numpy()] == 1).all()
    np.testing.assert_array_equal(hb_t.pairs.numpy(), np.asarray(hb_j.pairs))
    np.testing.assert_array_equal(hb_t.rt.numpy(), np.asarray(hb_j.rt))
    np.testing.assert_array_equal(hb_t.k.numpy(), np.asarray(hb_j.k))


def test_simulator_potential_matches_jax_chunk(chig_pair, chig_protein, tmp_path):
    """Three steps of the Simulator's stepped potential (nonbonded base,
    tether at 10 kcal/mol/A^2 to the start, H-bond restraint) against JAX's
    ``Simulator._chunk``, the port fed JAX's noise.  Tolerances: positions
    1e-5 A, forces 1e-4 eV/A, energy 1e-4 eV."""
    P, nb_j, nb_t, hb_j, hb_t = chig_pair
    cfg = dict(record_per_steps=3, preeq_steps=0, hydrogen_constraints=True)
    jsim = JS.Simulator(lambda p: JN.nonbonded_energy_forces(nb_j, p), chig_protein.masses,
                        chig_protein.numbers, JS.SimulationConfig(**cfg), str(tmp_path / "j"),
                        "chig", hbond_restraint=hb_j)
    tsim = TS.Simulator(lambda p: TN.nonbonded_energy_forces(nb_t, p), chig_protein.masses,
                        chig_protein.numbers, TS.SimulationConfig(**cfg), str(tmp_path / "t"),
                        "chig", hbond_restraint=hb_t, device="cpu")
    assert float(hb_t.energy(T(P))) > 0.01      # the restraint pulls at these positions
    key = jax.random.PRNGKey(1)
    vel = JL.maxwell_boltzmann_velocities(key, chig_protein.masses, 300.0)
    e0, f0 = JN.nonbonded_energy_forces(nb_j, jnp.asarray(P))
    sj = JL.MDState(jnp.asarray(P), vel, f0, e0, key, jnp.asarray(0, jnp.int32), aux=())
    k = 10.0 * KCAL
    sj_end = jsim._chunk(sj, jnp.asarray(P), jnp.asarray(k, jnp.float32), 3)

    tsim.tether_ref.copy_(T(P))
    tsim.tether_k.fill_(k)
    st = TL.MDState(T(P), T(vel), T(f0), T(e0))
    for _ in range(3):
        xi, eta = _jax_noise(key, P.shape)
        key = jax.random.split(key, 3)[0]
        st = TL.langevin_step(tsim.full_potential, tsim.coeffs, tsim.masses, st, xi=T(xi),
                              eta=T(eta))
    assert st.step == 3
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj_end.positions), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj_end.forces), rtol=0, atol=1e-4)
    assert float(st.energy) == pytest.approx(float(sj_end.energy), abs=1e-4)


# -- behaviours of tests/test_md.py on the port ------------------------------

def _lj(eps=0.01, sigma=3.0):
    def energy(p):
        d2 = ((p[None] - p[:, None]) ** 2).sum(-1) + torch.eye(p.shape[0]) * 1e9
        c6 = (sigma ** 2 / d2) ** 3
        return 0.5 * (4 * eps * (c6 ** 2 - c6)).sum()

    def pot(P):
        with torch.enable_grad():
            p = P.detach().requires_grad_(True)
            e = energy(p)
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g

    return pot


def _grid_cluster(n_side=3, spacing=3.4):
    g = np.arange(n_side) * spacing
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return (pos + 0.01 * np.random.default_rng(0).random(pos.shape)).astype(np.float32)


ARGON = 39.95


def test_nve_energy_conservation():
    """langevin_step without friction is velocity Verlet (its noise terms
    vanish)."""
    pot = TL.lift_potential(_lj())
    P = T(_grid_cluster())
    masses = np.full(len(P), ARGON)
    g = torch.Generator().manual_seed(0)
    vel = TL.maxwell_boltzmann_velocities(g, masses, 30.0)
    coeffs = TL.LangevinCoeffs.build(masses, 1.0, 30.0, 0.0, device="cpu")
    e0, f0 = _lj()(P)
    s = TL.MDState(P, vel, f0, e0)
    etot = []
    for _ in range(400):
        s = TL.langevin_step(pot, coeffs, T(masses).float(), s, fixcm=False, generator=g)
        etot.append(float(s.energy + TL.kinetic_energy(masses, s.velocities)))
    drift = (max(etot) - min(etot)) / len(P)
    assert drift < 5e-4, f"NVE drift {drift} eV/atom over 400 fs"


def test_langevin_thermalizes():
    pot = TL.lift_potential(_lj())
    P = T(_grid_cluster())
    masses = np.full(len(P), ARGON)
    target = 40.0
    coeffs = TL.LangevinCoeffs.build(masses, 2.0, target, 0.02, device="cpu")
    m = T(masses).float()
    g = torch.Generator().manual_seed(1)
    e0, f0 = _lj()(P)
    s = TL.MDState(P, torch.zeros_like(P), f0, e0)
    temps = []
    for _ in range(3000):
        s = TL.langevin_step(pot, coeffs, m, s, generator=g)
        temps.append(float(TL.temperature(masses, s.velocities)))
    tail = np.asarray(temps)[1500:]
    assert abs(tail.mean() - target) < 0.25 * target, tail.mean()


def test_langevin_fixes_com():
    pot = TL.lift_potential(_lj())
    P = T(_grid_cluster())
    masses = np.full(len(P), ARGON)
    coeffs = TL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.01, device="cpu")
    g = torch.Generator().manual_seed(2)
    e0, f0 = _lj()(P)
    s = TL.MDState(P, torch.zeros_like(P), f0, e0)
    for _ in range(200):
        s = TL.langevin_step(pot, coeffs, T(masses).float(), s, generator=g)
    m = masses[:, None]
    com0 = (P.numpy() * m).sum(0) / m.sum()
    com1 = (s.positions.numpy() * m).sum(0) / m.sum()
    assert np.abs(com1 - com0).max() < 1e-3


def test_maxwell_boltzmann_statistics():
    masses = np.full(2000, 12.0)
    v = TL.maxwell_boltzmann_velocities(torch.Generator().manual_seed(0), masses, 300.0)
    assert abs(float(TL.temperature(masses, v)) - 300.0) < 15.0


def _make_sim(log_dir, preeq=0, record=10, seed=3):
    P = _grid_cluster()
    cfg = TS.SimulationConfig(timestep_fs=2.0, temp_K=40.0, record_per_steps=record, seed=seed,
                              preeq_steps=preeq, runaway_factor=50.0)
    sim = TS.Simulator(_lj(), np.full(len(P), ARGON), np.full(len(P), 18), cfg, str(log_dir),
                       "lj", device="cpu")
    return sim, P


def test_simulator_end_to_end(tmp_path):
    """The tether ladder (5 stages), then 30 steps recorded every 10: the
    step count, the trajectories, the metrics CSV and the restart file."""
    sim, P = _make_sim(tmp_path, preeq=5)
    logs = []
    state = sim.initial_state(P)
    state = sim.pre_equilibrate(state, log=logs.append)
    assert float(sim.tether_k) == pytest.approx(0.1 * KCAL)
    state = sim.run(state, 30, log=logs.append)
    assert state.step == 5 * 5 + 30 and float(sim.tether_k) == 0.0
    frames = TT.read_dcd(str(tmp_path / "lj-traj.dcd"))
    assert frames.shape == (3, 27, 3)
    np.testing.assert_allclose(frames[-1], state.positions.numpy(), rtol=0, atol=0)
    assert (tmp_path / "lj-traj.xyz").read_text().count("step=") == 3
    rows = (tmp_path / "lj-metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,") and [r.split(",")[0] for r in rows[1:]] == ["35", "45", "55"]
    assert (tmp_path / "lj-restart.npz").exists()
    assert any("Pre-equilibration" in line for line in logs)
    assert any("ms/step" in line and "ns/day" in line for line in logs)


def test_restart_continuity(tmp_path):
    """Interrupting a run at step 20 and resuming in a new Simulator from
    its restart file reproduces the step-30 state of an uninterrupted run
    bitwise on the CPU (forces, energy, carry and the generator's state are
    all in the checkpoint)."""
    sim_ref, P = _make_sim(tmp_path / "ref")
    state_ref = sim_ref.run(sim_ref.initial_state(P), 30, log=lambda *_: None)

    sim_a, _ = _make_sim(tmp_path / "ab")
    state = sim_a.run(sim_a.initial_state(P), 20, log=lambda *_: None)
    restart = str(tmp_path / "ab" / "lj-restart.npz")

    sim_b, _ = _make_sim(tmp_path / "ab", seed=99)      # the seed is not what resumes it
    state_b = sim_b.initial_state(P, restart=restart, log=lambda *_: None)
    for name in ("positions", "velocities", "forces", "energy"):
        assert torch.equal(getattr(state_b, name), getattr(state, name)), name
    assert state_b.step == 20
    state_b = sim_b.run(state_b, 10, log=lambda *_: None)
    assert state_b.step == 30
    assert torch.equal(state_b.positions, state_ref.positions)
    assert torch.equal(state_b.velocities, state_ref.velocities)


def test_temperature_runaway_raises(tmp_path):
    sim, P = _make_sim(tmp_path)
    sim.cfg.runaway_factor = 1e-6      # any motion trips it
    with pytest.raises(TS.TemperatureRunawayError):
        sim.run(sim.initial_state(P), 10, log=lambda *_: None)


def test_non_finite_energy_raises(tmp_path):
    """The non-finite guard names the step and the energies."""
    P = _grid_cluster()
    cfg = TS.SimulationConfig(record_per_steps=2, preeq_steps=0)
    nan = lambda p: (torch.tensor(float("nan")), torch.zeros_like(p))
    sim = TS.Simulator(nan, np.full(len(P), ARGON), np.full(len(P), 18), cfg, str(tmp_path),
                       "lj", device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite energy at step 2"):
        sim.run(sim.initial_state(P), 4, log=lambda *_: None)


def test_bond_restraint_energy_forces_match_jax(chig_pair):
    """restraint_energy_forces (autograd) against JAX's restraint term on the
    perturbed Chignolin.  Tolerance 1e-5 eV and eV/A."""
    P, _, _, hb_j, hb_t = chig_pair
    zero = lambda p: (jnp.zeros((), jnp.float32), jnp.zeros_like(p))
    ej, fj = JC.with_restraints(zero, [hb_j])(jnp.asarray(P))
    et, ft = TC.restraint_energy_forces(hb_t, T(P))
    assert float(ej) > 0.01
    assert float(et) == pytest.approx(float(ej), abs=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-5)
