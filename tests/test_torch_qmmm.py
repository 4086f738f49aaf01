"""Solvated QM/MM in the port (ai2bmd_torch.physics.qmmm, md.settle, the
Simulator's solvated arguments) against the JAX package on the CPU.

One evaluation of the whole solvated Chignolin box (17,882 atoms) with a
zero QM term, in float64 on both sides; SETTLE against JAX's and against
the SHAKE oracle, alone and inside a Langevin step on JAX's noise; the
pair-backend ladder and the refused backends; the overflow guard on a cell
assignment; a restart of a nested carry; `python -m ai2bmd_torch` on the
box.  The solvated ProteinSimulation
against JAX's, two steps: marked slow (three JAX compilations of the whole
box)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu import simulators as JSIM
from ai2bmd_tpu.data import protein_topology as JPT
from ai2bmd_tpu.io.pdb import read_pdb as j_read
from ai2bmd_tpu.io.reorder import normalize_atom_order as j_norm
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.md import settle as JSET
from ai2bmd_tpu.md import simulation as JS
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.physics import mm as JMM
from ai2bmd_tpu.physics import qmmm as JQ
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.data import protein_topology as TPT
from ai2bmd_torch.host import normalize_atom_order, read_pdb
from ai2bmd_torch.md import graphed as TG
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import settle as TSET
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import neighbors as TNL
from ai2bmd_torch.physics import cellpair as TCP
from ai2bmd_torch.physics import mm as TMM
from ai2bmd_torch.physics import pme as TPME
from ai2bmd_torch.physics import qmmm as TQ

T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here: under pytest-xdist the workers
    share the cores, and a box-sized element-wise pass over 8 OpenMP threads
    then waits on preempted ones (the solvated CLI test below took 9 s alone
    and 433 s beside three other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def box():
    conftest.require_examples()
    path = conftest.example_pdb("chig-preeq")
    return j_norm(j_read(path)), normalize_atom_order(read_pdb(path))


def _jax_tables_in_float64(monkeypatch):
    """JAX's MMSystem.build casts every table to float32 whatever the x64
    flag says; widen them (values unchanged) so that its sums run in
    float64, as the port's do on float64 tensors."""
    build = JMM.MMSystem.build.__func__

    def build64(cls, *a, **k):
        m = build(cls, *a, **k)
        wide = {f.name: getattr(m, f.name).astype(jnp.float64) for f in dataclasses.fields(m)
                if getattr(getattr(m, f.name), "dtype", None) == jnp.float32}
        return dataclasses.replace(m, **wide)

    monkeypatch.setattr(JMM.MMSystem, "build", classmethod(build64))


def test_whole_box_matches_jax_in_float64(box, monkeypatch):
    """QMMMPotential on the solvated box with a zero QM term (full-box MM
    minus protein MM; the auto route takes the cell buckets in both), JAX
    under jax.enable_x64 with its tables widened, the port on float64
    tensors: E within 1e-6 relative, F within 1e-6 eV/A.  What is left
    (~4e-7 eV/A) is JAX's mesh spreading, which accumulates in float32
    (preferred_element_type, ai2bmd_tpu/physics/mm.py:464) even under x64."""
    j_atoms, t_atoms = box
    _jax_tables_in_float64(monkeypatch)
    zero_t = lambda P: (P.sum() * 0, torch.zeros_like(P))
    tq = TQ.QMMMPotential.build(t_atoms, zero_t, device="cpu", dtype=torch.float64)
    assert tq.backend == "cellpair" and tq.cp.nc3 == (5, 6, 5)
    P = torch.as_tensor(t_atoms.positions, dtype=torch.float64)
    e_t, f_t, (state, _) = tq(P, tq.init_aux(P))
    assert isinstance(state, TCP.CellState) and not bool(state.overflow)
    with jax.enable_x64(True):
        jq = JQ.QMMMPotential.build(j_atoms, lambda P: (jnp.sum(P) * 0, jnp.zeros_like(P)))
        assert jq.cp is not None and jq.cp.occ == tq.cp.occ
        Pj = jnp.asarray(j_atoms.positions, jnp.float64)
        e_j, f_j, _ = jax.jit(jq.__call__)(Pj, jq.init_aux(Pj))
        e_j, f_j = float(e_j), np.asarray(f_j)
    assert f_j.dtype == np.float64
    assert float(e_t) == pytest.approx(e_j, rel=1e-6)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def waters(box):
    """SETTLE tables of the box's waters in both packages, and positions
    that satisfy the rigid geometry (JAX's snap)."""
    j_atoms, t_atoms = box
    jc = JSET.SettleConstraint.from_topology(JPT.build_topology(j_atoms))
    tc = TSET.SettleConstraint.from_topology(TPT.build_topology(t_atoms), "cpu")
    X0 = np.asarray(jax.jit(jc.snap)(jnp.asarray(j_atoms.positions, jnp.float32)))
    return jc, tc, X0, t_atoms.masses


def test_settle_matches_jax_and_shake(waters, rng):
    """Positions: SETTLE from snapped positions after a random 0.02 A kick,
    against JAX's SETTLE in float32 (1e-5 A; coordinates up to 59 A) and,
    in float64, against the SHAKE oracle (2e-5 A, tests/test_settle.py's
    bar); the float32 constraints hold to 1e-5 A.  Velocities: the RATTLE
    projection against JAX's (Cramer's rule here, a batched solve there),
    1e-5 of the scale."""
    jc, tc, X0, masses = waters
    for name in ("o_idx", "h1_idx", "h2_idx"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    assert len(tc.o_idx) > 5000
    X1 = X0 + (rng.normal(size=X0.shape) * 0.02).astype(np.float32)
    got = tc.positions(T(X0), T(X1))
    np.testing.assert_allclose(got.numpy(), np.asarray(jc.positions(jnp.asarray(X0),
                                                                    jnp.asarray(X1))), atol=1e-5)
    shake = TSET.shake_reference(tc, T(X0).double(), T(X1).double(), masses)
    got64 = tc.positions(T(X0).double(), T(X1).double())
    np.testing.assert_allclose(got64.numpy(), shake.numpy(), atol=2e-5)
    assert float(tc.max_violation(got)) < 1e-5
    V = (rng.normal(size=X0.shape) * 0.05).astype(np.float32)
    v_t = tc.velocities(T(X0), T(V))
    v_j = np.asarray(jc.velocities(jnp.asarray(X0), jnp.asarray(V)))
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=0, atol=1e-5 * np.abs(v_j).max())


def test_constrained_langevin_step_matches_jax(waters):
    """One Langevin step with SETTLE of the box's atoms under a weak
    harmonic pull, fed JAX's noise, in float64 on both sides (JAX under
    jax.enable_x64): positions and velocities against JAX's
    langevin_step(constraint=...) within 1e-9; the graphed body (step_into,
    run eagerly on the CPU) gives the same step bitwise."""
    jc, tc, X0, masses = waters
    X0 = X0.astype(np.float64)
    k = 5e-5
    pot_j = lambda P, aux: (0.5 * k * jnp.sum(P * P), -k * P, aux)
    pot_t = lambda P, aux: (0.5 * k * (P * P).sum(), -k * P, aux)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(3)
        vel = jc.velocities(jnp.asarray(X0), JL.maxwell_boltzmann_velocities(
            key, masses, 300.0, jnp.float64))
        cj = JL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001)
        sj = JL.MDState(jnp.asarray(X0), vel, -k * jnp.asarray(X0), jnp.asarray(0.0), key,
                        jnp.asarray(0, jnp.int32), aux=())
        sj1 = jax.jit(lambda s: JL.langevin_step(pot_j, cj, masses, s, constraint=jc))(sj)
        _, k1, k2 = jax.random.split(key, 3)
        xi, eta = (T(jax.random.normal(kk, X0.shape, jnp.float64)) for kk in (k1, k2))
        vel, pos1, vel1 = T(vel), np.asarray(sj1.positions), np.asarray(sj1.velocities)
    assert pos1.dtype == np.float64
    ct = TL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001, device="cpu", dtype=torch.float64)
    m = torch.as_tensor(masses, dtype=torch.float64)
    st = TL.MDState(T(X0), vel, -k * T(X0), torch.zeros((), dtype=torch.float64))
    st1 = TL.langevin_step(pot_t, ct, m, st, xi=xi, eta=eta, constraint=tc)
    np.testing.assert_allclose(st1.positions.numpy(), pos1, rtol=0, atol=1e-9)
    np.testing.assert_allclose(st1.velocities.numpy(), vel1, rtol=0, atol=1e-9)
    buf = TG.StepBuffers.from_state(st)
    buf.xi.copy_(xi)
    buf.eta.copy_(eta)
    TG.step_into(buf, pot_t, ct, m, tc)
    assert torch.equal(buf.positions, st1.positions) and torch.equal(buf.velocities,
                                                                     st1.velocities)


def test_pair_backend_ladder_and_refusals(box, monkeypatch):
    """auto takes the cell buckets on the box and the dense path when the
    input overflows a cell (JAX's probe); dense and nl on request, nl with
    the cell build of its list (the box holds 3 cells an axis at cutoff +
    skin; the list is rebuilt inside the captured step, so the card takes
    it too); the AMOEBA solvent (item 15) and the polarizable hybrid (item
    13b) take nl, as JAX's ladder sends them; cellpair on a box under 3
    cells an axis, an unknown backend or MM backend, and the hybrid on an
    explicit dense route are refused."""
    _, atoms = box
    build = lambda a=atoms, **kw: TQ.QMMMPotential.build(
        a, lambda P: (P.sum() * 0, torch.zeros_like(P)), device="cpu", **kw)
    assert build().backend == "cellpair"
    crowded = dataclasses.replace(atoms, positions=atoms.positions * 0.05)
    assert build(crowded).backend == "dense"
    with pytest.raises(ValueError, match="cell-bucket overflow"):
        build(crowded, pair_backend="cellpair").init_aux(T(crowded.positions).float())
    assert build(pair_backend="dense").backend == "dense"
    nl = build(pair_backend="nl")
    assert nl.backend == "nl"
    small = dataclasses.replace(atoms, cell=np.array([20.0, 20.0, 20.0]))
    with pytest.raises(ValueError, match="box too small"):
        build(small, pair_backend="cellpair")
    with pytest.raises(ValueError, match="unknown pair_backend"):
        build(pair_backend="tiles")
    assert nl.nl_grid == ((5, 5, 5), 288) and nl.nbr_cells.shape == (125, 27)
    with pytest.raises(ValueError, match="unknown mm_backend"):
        build(mm_backend="tinker")
    amoeba = build(mm_backend="amoeba")
    assert amoeba.backend == "nl" and amoeba.amoeba is not None and amoeba.mm_full is None
    assert amoeba.mesh == amoeba.amoeba.full.pme.grid
    pol = build(polarizable=True)
    assert pol.backend == "nl" and pol.mm_full.polarization is not None
    with pytest.raises(ValueError, match="dense path does not support the legacy polarization"):
        build(polarizable=True, pair_backend="dense")


def _simulator(tmp_path, n, potential=None, init_aux=None, record=1, **kw):
    potential = potential or (lambda P, aux: (P.sum() * 0, torch.zeros_like(P), aux))
    return TS.Simulator(potential, np.full(n, 12.0), np.full(n, 6), TS.SimulationConfig(
        preeq_steps=0, record_per_steps=record, timestep_fs=0.5), str(tmp_path), "box",
                        stateful=True, init_aux=init_aux, device="cpu", **kw)


def test_overflow_guard_raises_on_a_cell_overflow(tmp_path, rng):
    """A cell assignment whose occupancy exceeds occ (a crowded cluster) in
    the carry makes the Simulator's record-interval guard raise, as does an
    overflowed neighbour list; sound ones pass.  An overflow at a step
    between records still raises at the next record: assign(prev=) keeps
    the flag sticky in the carry, as QMMMPotential calls it every step."""
    L, n = 30.0, 400
    P = rng.uniform(0, L, size=(n, 3)).astype(np.float32)
    cp = TCP.build_cellpairs(np.array([L, L, L]), 9.0, n, "cpu")
    crowd = P.copy()
    crowd[: cp.occ + 5] = 2.0 + 0.01 * rng.random((cp.occ + 5, 3))
    sim = _simulator(tmp_path, n)
    state = lambda aux: TL.MDState(T(P), T(P) * 0, T(P) * 0, torch.zeros(()), aux=aux)
    sound = TCP.assign(cp, T(P))
    assert not bool(sound.overflow)
    sim._check_overflow(state((sound, torch.zeros(3))))
    bad = TCP.assign(cp, T(crowd))
    assert bool(bad.overflow)
    with pytest.raises(RuntimeError, match="cell-bucket assignment overflow"):
        sim._check_overflow(state((bad, torch.zeros(3))))
    nl = TNL.build_neighbor_list(T(P), 9.0, 2, T(np.array([L, L, L], np.float32)))
    with pytest.raises(RuntimeError, match="neighbor list overflow"):
        sim._check_overflow(state((nl, None)))

    calls = []

    def potential(X, aux):      # call 1 is the first forces, call 2 step 1 of 3
        calls.append(len(calls) + 1)
        at = T(crowd) if len(calls) == 2 else X
        return X.sum() * 0, torch.zeros_like(X), (TCP.assign(cp, at, prev=aux[0]), aux[1])

    run = _simulator(tmp_path / "run", n, potential, (sound, torch.zeros(3)), record=3)
    with pytest.raises(RuntimeError, match="cell-bucket assignment overflow at step 3"):
        run.run(run.initial_state(P), 3, log=lambda *_: None)
    assert calls == [1, 2, 3, 4]


def test_nested_carry_survives_a_restart(tmp_path, rng):
    """A run whose carry is (cell assignment, cap-like offsets) writes every
    leaf to its restart file and a restart gives them back with their
    dtypes; the trajectory keeps only record_subset's atoms and the DCD
    carries the cell."""
    L, n = 30.0, 120
    P = rng.uniform(0, L, size=(n, 3)).astype(np.float32)
    cp = TCP.build_cellpairs(np.array([L, L, L]), 9.0, n, "cpu")

    def potential(X, aux):
        return (X * X).sum() * 1e-4, -2e-4 * X, (TCP.assign(cp, X), aux[1] + 1.0)

    aux0 = (TCP.assign(cp, T(P)), torch.zeros(4))
    sim = _simulator(tmp_path, n, potential, aux0, cell=np.array([L, L, L]))
    end = sim.run(sim.initial_state(P), 2, log=lambda *_: None, record_subset=np.arange(10))
    back = _simulator(tmp_path, n, potential, aux0).initial_state(
        P, restart=str(tmp_path / "box-restart.npz"), log=lambda *_: None)
    assert back.step == 2 and torch.equal(back.positions, end.positions)
    assert isinstance(back.aux[0], TCP.CellState)
    for a, b in zip(back.aux[0], end.aux[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(back.aux[1], end.aux[1]) and float(back.aux[1][0]) == 3.0
    from ai2bmd_torch.io.trajectory import read_dcd

    frames, cells = read_dcd(str(tmp_path / "box-traj.dcd"), return_cells=True)
    assert frames.shape == (2, 10, 3) and np.allclose(cells[0], L)


def test_new_entry_points_default_to_the_card(box, monkeypatch):
    """QMMMPotential.build, MMSystem.build, PMEParams.build and
    build_cellpairs' callers take the card unless told otherwise."""
    _, atoms = box
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQ.QMMMPotential.build(atoms, lambda P: (P.sum(), P))
    top = TPT.build_topology(atoms)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMM.MMSystem.build(top, atoms.cell)
    from ai2bmd_torch.system import Protein

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPME.PMEParams.build(Protein.from_atoms(atoms), np.zeros((0, 2), np.int32))


def test_cli_runs_the_solvated_box_with_explicit_solvent(tmp_path, capsys):
    """A solvated input without --no-solvent (refused until ROADMAP item 13;
    the case argv2-13 of test_torch_cli.py's refused routes) runs
    subtractive QM/MM over the whole box: with --rigid-water and
    --no-write-solvent, exit 0, the QM/MM line, a frame of the 175 protein
    atoms, a DCD that carries the cell."""
    assert TCLI.main(["--prot-file", conftest.example_pdb("chig-preeq"), "--device", "cpu",
                      "--model-preset", "tiny", "--timestep", "0.25", "--log-dir",
                      str(tmp_path), "--rigid-water", "--no-write-solvent", "--preeq-steps", "0",
                      "--sim-steps", "1", "--record-per-steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "QM/MM: 17882 atoms in the box, 175 in the QM region; cellpair pairs" in out
    assert "rigid water (SETTLE)" in out
    frames, cells = TT.read_dcd(str(tmp_path / "chig-preeq-traj.dcd"), return_cells=True)
    assert frames.shape == (1, 175, 3) and np.isfinite(frames).all()
    np.testing.assert_allclose(cells[0], [55.216, 59.157, 53.428], atol=1e-3)


@pytest.mark.slow
def test_solvated_simulation_steps_match_jax(box, monkeypatch, tmp_path):
    """ProteinSimulation.from_pdb on the solvated box at 3 x 32 in both
    packages (JAX's weights bridged in): the first forces and two Langevin
    steps of the port fed JAX's noise against JAX's Simulator._chunk, from
    the port's step-0 forces.  float32 on both sides: protein atoms within
    2e-2 eV/A (the subtractive combiner's float32 spread, ROADMAP.md Queue
    3: JAX's own float32 against float64 on this box reads 1.27e-2), solvent
    atoms within 1e-3 eV/A; positions of solvent atoms within 1e-5 A, of
    protein atoms within 1e-3 A (2e-2 eV/A moves a hydrogen by dt^2/m x 2e-2
    = 2e-4 A a step at 1 fs; measured 1.1e-4 A after two)."""
    small = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8)
    pdb = conftest.example_pdb("chig-preeq")
    cfg = dict(preeq_steps=0, record_per_steps=2)
    jps = JSIM.ProteinSimulation.from_pdb(pdb, log_dir=str(tmp_path / "j"),
                                          model_cfg=JV.ViSNetConfig(**small),
                                          sim_cfg=JS.SimulationConfig(**cfg))
    jparams, _ = JSIM.load_model(None, JV.ViSNetConfig(**small))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    monkeypatch.setattr(TSIM, "load_model", lambda ckpt, cfg=None, seed=0: (tparams, cfg))
    tps = TSIM.ProteinSimulation.from_pdb(pdb, log_dir=str(tmp_path / "t"),
                                          model_cfg=TV.ViSNetConfig(**small),
                                          sim_cfg=TS.SimulationConfig(**cfg), device="cpu")
    prot = tps.qmmm.sel.numpy()
    solvent = np.ones(tps.qmmm.n_atoms, bool)
    solvent[prot] = False
    P = jps.prot.positions.astype(np.float32)
    st = tps.sim.initial_state(P)
    key = jax.random.PRNGKey(1)
    vel = JL.maxwell_boltzmann_velocities(key, jps.prot.masses, 300.0)
    aux_j = jps.sim._init_aux
    sj = JL.MDState(jnp.asarray(P), vel, jnp.asarray(st.forces.numpy()),
                    jnp.asarray(st.energy.numpy()), key, jnp.asarray(0, jnp.int32), aux=aux_j)
    sj_end = jps.sim._chunk(sj, jnp.asarray(P), jnp.asarray(0.0, jnp.float32), 2)
    st = TL.MDState(T(P), T(vel), st.forces, st.energy, aux=st.aux)
    for _ in range(2):
        _, k1, k2 = jax.random.split(key, 3)
        key = jax.random.split(key, 3)[0]
        xi, eta = (T(jax.random.normal(kk, P.shape, jnp.float32)) for kk in (k1, k2))
        st = TL.langevin_step(tps.sim.full_potential, tps.sim.coeffs, tps.sim.masses, st,
                              xi=xi, eta=eta)
    dF = np.abs(st.forces.numpy() - np.asarray(sj_end.forces)).max(-1)
    dx = np.abs(st.positions.numpy() - np.asarray(sj_end.positions)).max(-1)
    assert dx[solvent].max() <= 1e-5 and dx[~solvent].max() <= 1e-3, (dx[solvent].max(),
                                                                     dx[~solvent].max())
    assert dF[solvent].max() <= 1e-3 and dF[~solvent].max() <= 2e-2, (dF[solvent].max(),
                                                                      dF[~solvent].max())
