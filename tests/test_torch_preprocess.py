"""Preprocessing in the port (ai2bmd_torch.io.build, .preprocess, the moving
cell and the pressure of ai2bmd_torch.physics.mm, the velocity-Verlet and
Berendsen steps of ai2bmd_torch.md.langevin) against the JAX package on the
CPU.

The input box is the JAX suite's: solvate(build_polyalanine(2), padding=4.0,
seed=0), 251 atoms in a 17.9 x 14.5 x 12.8 A cell.  Float64 comparisons run
JAX under jax.enable_x64 with its MM tables widened (as
tests/test_torch_qmmm.py does); float32 ones compare each package's own
float32."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu import preprocess as JP
from ai2bmd_tpu.data import protein_topology as JPT
from ai2bmd_tpu.io import build as JB
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.md import settle as JSET
from ai2bmd_tpu.ops import neighbors as JNL
from ai2bmd_tpu.physics import mm as JMM
from ai2bmd_torch import preprocess as TP
from ai2bmd_torch.data import protein_topology as TPT
from ai2bmd_torch.io import build as TB
from ai2bmd_torch.io.pdb import read_pdb, write_pdb
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import settle as TSET
from ai2bmd_torch.ops import neighbors as TNL
from ai2bmd_torch.physics import mm as TMM

T = lambda a: torch.as_tensor(np.array(a))
SCALE = 1.03
JP_BAR = 1e5 * 1e-30 / 1.602176634e-19     # eV/A^3 per bar, ai2bmd_tpu/preprocess.py:263
JP_COMP = 4.6e-5 / 1.01325                  # ai2bmd_tpu/preprocess.py:262


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def box():
    """The ala2 box in both packages, its topology, and float32 MM tables."""
    jbox = JP.solvate(JB.build_polyalanine(2), padding=4.0, seed=0)
    tbox = TP.solvate(TB.build_polyalanine(2), padding=4.0, seed=0)
    jtop, ttop = JPT.build_topology(jbox), TPT.build_topology(tbox)
    return dict(jbox=jbox, tbox=tbox, jtop=jtop, ttop=ttop,
                jm=JMM.MMSystem.build(jtop, jbox.cell),
                tm=TMM.MMSystem.build(ttop, tbox.cell, device="cpu"),
                P=tbox.positions.astype(np.float32))


def _mm64(box):
    """Both packages' MM tables in float64 (JAX's widened from its float32
    values under x64, as test_torch_qmmm.py's _jax_tables_in_float64)."""
    jm = box["jm"]
    with jax.enable_x64(True):
        wide = {f.name: jnp.asarray(getattr(jm, f.name), jnp.float64)
                for f in dataclasses.fields(jm)
                if getattr(getattr(jm, f.name), "dtype", None) == jnp.float32}
    return (dataclasses.replace(jm, **wide),
            TMM.MMSystem.build(box["ttop"], box["tbox"].cell, device="cpu", dtype=torch.float64))


def _same_atoms(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is y, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name


@pytest.mark.parametrize("peptide, padding, seed", [
    (("polyalanine", 2), 4.0, 0),
    (("polyalanine", 5, -60.0, -45.0), 6.0, 3),
    (("peptide", ["ALA", "GLY", "CYX", "ALA", "CYX"]), 5.0, 1),
], ids=["ala2", "ala5-helix", "gly-cyx"])
def test_builder_and_solvate_equal_jax_bit_for_bit(peptide, padding, seed):
    """The builder's chain and the solvated box (waters, ions, cell) equal
    the JAX package's bit for bit, field by field, from the same seed."""
    kind, *args = peptide
    j = getattr(JB, f"build_{kind}")(*args)
    t = getattr(TB, f"build_{kind}")(*args)
    _same_atoms(t, j)
    jb, tb = JP.solvate(j, padding=padding, seed=seed), TP.solvate(t, padding=padding, seed=seed)
    assert len(tb) > 3 * len(t)
    _same_atoms(tb, jb)


def test_dense_mm_at_a_moved_cell_matches_jax_in_float64(box):
    """mm_energy_forces_dense at positions and cell scaled by 1.03 (the
    dynamic-cell influence, the bonded, exclusion and pair terms at the new
    cell), float64 on both sides: F within 1e-6 eV/A, E within 1e-9 of the
    reciprocal term's magnitude (2.2e4 eV here, nearly cancelled by the
    pairs'): JAX's mesh spreading accumulates in float32 even under x64
    (mm.py:464), as test_torch_qmmm.py found on the Chignolin box."""
    jm, tm = _mm64(box)
    P = box["P"].astype(np.float64) * SCALE
    cell = np.asarray(box["tbox"].cell, np.float64) * SCALE
    with jax.enable_x64(True):
        e_j, f_j = jax.jit(lambda p, c: JMM.mm_energy_forces_dense(jm, p, c))(
            jnp.asarray(P), jnp.asarray(cell))
        e_j, f_j = float(e_j), np.asarray(f_j)
    assert f_j.dtype == np.float64
    e_t, f_t = TMM.mm_energy_forces_dense(tm, T(P), T(cell))
    e_recip = float(TMM._recip_excl_energy(tm, T(P), T(cell)))
    assert abs(float(e_t) - e_j) <= 1e-9 * abs(e_recip)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-6)
    # the static path (cell=None) is not the moved cell's
    e_static, _ = TMM.mm_energy_forces_dense(tm, T(P))
    assert abs(float(e_static) - e_j) > 1e-3


def test_dynamic_influence_at_the_static_cell_is_the_static_influence(box):
    """dynamic_influence(mm, mm.cell) gives the influence function and the
    neutralizing term MMSystem.build tabulated (float64 tables: within 1e-7
    of the largest, both being float32-rounded in places), and a dense
    evaluation through it equals the static one: E within 1e-9 of the
    reciprocal term's magnitude, F within 1e-7 eV/A."""
    tm = TMM.MMSystem.build(box["ttop"], box["tbox"].cell, device="cpu", dtype=torch.float64)
    infl, e_neutral = TMM.dynamic_influence(tm, tm.cell)
    assert infl.shape == tm.influence.shape == tm.grid
    np.testing.assert_allclose(infl.numpy(), tm.influence.numpy(), rtol=0,
                               atol=1e-7 * float(tm.influence.abs().max()))
    assert float(e_neutral) == pytest.approx(tm.e_neutral, rel=1e-9, abs=1e-12)
    P = T(box["P"].astype(np.float64))
    e_s, f_s = TMM.mm_energy_forces_dense(tm, P)
    e_d, f_d = TMM.mm_energy_forces_dense(tm, P, tm.cell.clone())
    assert abs(float(e_d) - float(e_s)) <= 1e-9 * abs(float(TMM._recip_excl_energy(tm, P)))
    np.testing.assert_allclose(f_d.numpy(), f_s.numpy(), rtol=0, atol=1e-7)


def _energy_at_scale(tm, P, cell, s, nl=None):
    if nl is None:
        return float(TMM.mm_energy_forces_dense(tm, P * s, cell * s)[0])
    return float(TMM.mm_energy(tm, P * s, nl, cell * s))


@pytest.mark.parametrize("route", ["dense", "nl"])
def test_pressure_matches_jax_and_a_central_difference(box, route):
    """The instantaneous pressure at the 1.03-scaled state with a kinetic
    energy of 2 eV, float64, held to the virial's scale (2K + |dU_smooth/ds|
    + |W|) / 3V (W the pair virial; the two large terms cancel to ~0.1% of
    it here): against JAX's mm_pressure_dense / mm_pressure within 1e-7 of
    it (JAX differentiates in a float32 scale s even under x64, so its
    dU_smooth/ds is float32-rounded), and against (2K - dU/ds) / 3V with
    dU/ds a central difference of U(s) = E(sP, sc) (h = 1e-6) within 1e-5
    of it (a pair crossing the cutoff under the scaling moves U by ~1e-5
    eV).  On the dense route the pressure from the pair virial a force
    evaluation returns (what an NPT step reuses) equals mm_pressure_dense's,
    which makes a second pair pass, bit for bit."""
    jm, tm = _mm64(box)
    P = T(box["P"].astype(np.float64) * SCALE)
    cell = T(np.asarray(box["tbox"].cell, np.float64) * SCALE)
    ekin = torch.tensor(2.0, dtype=torch.float64)
    nl_t = nl_j = None
    with jax.enable_x64(True):
        Pj, cj = jnp.asarray(P.numpy()), jnp.asarray(cell.numpy())
        if route == "dense":
            p_j = jax.jit(lambda p, c: JMM.mm_pressure_dense(jm, p, c, 2.0))(Pj, cj)
        else:
            nl_j = JNL.build_neighbor_list(Pj, tm.cutoff + 1.0, len(P), cj)
            p_j = jax.jit(lambda p, c: JMM.mm_pressure(jm, p, nl_j, c, 2.0))(Pj, cj)
        p_j = float(p_j)
    _, _, w = TMM.mm_energy_forces_virial_dense(tm, P, cell)
    if route == "dense":
        p_t = TMM.mm_pressure_dense(tm, P, cell, ekin)
        assert float(TMM.pressure(tm, P, cell, ekin, w)) == float(p_t)
    else:
        nl_t = TNL.build_neighbor_list(P, tm.cutoff + 1.0, len(P), cell)
        assert not bool(nl_t.overflow) and not bool(nl_j.overflow)
        p_t = TMM.mm_pressure(tm, P, nl_t, cell, ekin)
    h = 1e-6
    du = (_energy_at_scale(tm, P, cell, 1 + h, nl_t)
          - _energy_at_scale(tm, P, cell, 1 - h, nl_t)) / (2 * h)
    volume = float(torch.prod(cell))
    du_smooth = float(TMM.smooth_strain_derivative(tm, P, cell))
    scale = (4.0 + abs(du_smooth) + abs(float(w))) / (3 * volume)
    assert abs(du) < 1e-2 * (abs(du_smooth) + abs(float(w)))
    assert abs(float(p_t) - p_j) <= 1e-7 * scale
    assert abs(float(p_t) - (4.0 - du) / (3 * volume)) <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["verlet", "verlet-settle", "berendsen"])
def test_verlet_and_berendsen_steps_match_jax(box, kind):
    """3 steps of velocity_verlet_step (NVE; RATTLE with SETTLE) or
    berendsen_step (to 300 K, tau 100 fs) at 0.5 fs on the box's dense MM,
    float64 on both sides (JAX under x64, its tables widened), from the same
    velocities (and, with SETTLE, the same snapped positions): forces within
    1e-6 eV/A (JAX's float32 mesh spreading), so velocities within 1e-7
    (A per ASE time unit: three half-kicks of dt F / m at 1e-6 eV/A on a
    hydrogen) and positions within 1e-8 A; E within 1e-9 of the reciprocal
    term's magnitude."""
    jm, tm = _mm64(box)
    P, masses = box["P"].astype(np.float64), box["ttop"].masses
    v0 = np.random.default_rng(2).standard_normal(P.shape) * 0.02
    jc = tc = None
    with jax.enable_x64(True):
        if kind == "verlet-settle":
            jc = JSET.SettleConstraint.from_topology(box["jtop"])
            tc = TSET.SettleConstraint.from_topology(box["ttop"], "cpu")
            P = np.asarray(jax.jit(jc.snap)(jnp.asarray(P)))
            v0 = np.asarray(jc.velocities(jnp.asarray(P), jnp.asarray(v0)))
        jpot = lambda p, aux: (*JMM.mm_energy_forces_dense(jm, p), aux)
        e0, f0, _ = jax.jit(jpot)(jnp.asarray(P), ())
        sj = JL.MDState(jnp.asarray(P), jnp.asarray(v0), f0, e0, jax.random.PRNGKey(0),
                        jnp.asarray(0, jnp.int32), aux=())
        if kind == "berendsen":
            jstep = jax.jit(lambda s: JL.berendsen_step(jpot, 0.5, 300.0, 100.0, masses, s))
        else:
            jstep = jax.jit(lambda s: JL.velocity_verlet_step(jpot, 0.5, masses, s,
                                                              constraint=jc))
        for _ in range(3):
            sj = jstep(sj)
        want = {k: np.asarray(getattr(sj, k)) for k in ("positions", "velocities", "forces")}
        e_j = float(sj.energy)
    assert want["positions"].dtype == np.float64
    tpot = lambda p, aux: (*TMM.mm_energy_forces_dense(tm, p), aux)
    st = TL.MDState(T(P), T(v0), T(f0), T(e0))
    m = torch.as_tensor(masses, dtype=torch.float64)
    for _ in range(3):
        st = (TL.berendsen_step(tpot, 0.5, 300.0, 100.0, m, st) if kind == "berendsen" else
              TL.velocity_verlet_step(tpot, 0.5, m, st, constraint=tc))
    assert st.step == 3
    np.testing.assert_allclose(st.positions.numpy(), want["positions"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(st.velocities.numpy(), want["velocities"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(st.forces.numpy(), want["forces"], rtol=0, atol=1e-6)
    assert abs(float(st.energy) - e_j) <= 1e-9 * abs(float(TMM._recip_excl_energy(
        tm, st.positions)))
    if tc is not None:
        assert float(tc.max_violation(st.positions)) < 1e-9
    moved = np.abs(st.positions.numpy() - P).max()
    assert moved > 1e-4


def test_npt_step_matches_jax_with_its_noise(box):
    """One step of the NPT stage fed the xi / eta JAX's langevin_step draws
    from its key, against the JAX package's step built from its own
    functions as preprocess.py:268-287 composes them (a Langevin step of the
    dense MM at the cell, mm_pressure_dense at the new positions, the
    Berendsen scaling), float64 on both sides; the port's pressure comes
    from the step's own pair pass.  The pressure within 1e-7 of the virial's
    scale (JAX's strain derivative is float32-rounded, as in
    test_pressure_matches_jax_and_a_central_difference), which moves the
    scaling by ~1e-7: the cell and the positions within 1e-5 A."""
    jm, tm = _mm64(box)
    P, masses = box["P"].astype(np.float64), box["ttop"].masses
    cell0 = np.asarray(box["tbox"].cell, np.float64)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(7)
        v0 = JL.maxwell_boltzmann_velocities(key, masses, 300.0, jnp.float64)
        cj = JL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.002)

        @jax.jit
        def jax_npt(s, cell):
            pot_cell = lambda p, aux: (*JMM.mm_energy_forces_dense(jm, p, cell), aux)
            s = JL.langevin_step(pot_cell, cj, masses, s)
            ekin = JL.kinetic_energy(masses, s.velocities)
            pres_bar = JMM.mm_pressure_dense(jm, s.positions, cell, ekin) / JP_BAR
            lam = (1.0 - JP_COMP * (1.0 / 200.0) * (1.0 - pres_bar)) ** (1.0 / 3.0)
            return s.positions * lam, cell * lam, pres_bar

        e0, f0 = JMM.mm_energy_forces_dense(jm, jnp.asarray(P))
        sj = JL.MDState(jnp.asarray(P), v0, f0, e0, key, jnp.asarray(0, jnp.int32), aux=())
        pos_j, cell_j, pres_j = (np.asarray(a) for a in jax_npt(sj, jnp.asarray(cell0)))
        _, k1, k2 = jax.random.split(key, 3)
        xi, eta = (T(jax.random.normal(k, P.shape, jnp.float64)) for k in (k1, k2))
    assert pos_j.dtype == np.float64
    ct = TL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.002, device="cpu", dtype=torch.float64)
    st = TL.MDState(T(P), T(v0), T(f0), T(e0))
    s1, cell_t, pres_t = TP.npt_step(tm, ct, torch.as_tensor(masses, dtype=torch.float64), st,
                                     T(cell0), 200.0, xi=xi, eta=eta)
    assert s1.aux is None and s1.step == 1
    _, _, w = TMM.dense_pair_energy_forces(tm, T(P))
    scale = 2 * abs(float(w)) / (3 * float(np.prod(cell0))) / JP_BAR
    assert abs(float(pres_t) - float(pres_j)) <= 1e-7 * scale
    np.testing.assert_allclose(cell_t.numpy(), cell_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s1.positions.numpy(), pos_j, rtol=0, atol=1e-5)
    assert np.abs(cell_t.numpy() - cell0).max() > 1e-6       # the cell moved


def _counting(monkeypatch, module, name, use_callback):
    """Count the calls of module.name and keep the positions of each (in JAX
    through a host callback, so that a jitted or scanned call counts each
    time it runs)."""
    seen = []
    fn = getattr(module, name)

    def wrapped(mm, P, *a, **k):
        if use_callback:
            jax.debug.callback(lambda p: seen.append(np.asarray(p)), P)
        else:
            seen.append(P.numpy().copy())
        return fn(mm, P, *a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return seen


def _logged(seen):
    lines = []
    return lines, lambda msg: lines.append((re.sub(r"-?\d+\.\d+|\[[^]]*\]", "#", str(msg)),
                                            len(seen)))


def test_preprocessor_end_to_end_against_jax(box, tmp_path, monkeypatch):
    """Preprocessor.run with tiny stages (5 cycles, one heat stage of 10
    steps, nvt_steps=10, npt_steps=10) on a bare ala2 PDB in both packages:
    the same log lines, numbers aside, with the same number of MM
    evaluations at each (JAX's NVT stage runs one whole chunk of 500 steps
    for nvt_steps=10, and so does the port); the minimized positions (those
    of the heat stage's first evaluation in JAX) within 5e-4 A of JAX's,
    float32 on both sides: each package's float32 forces on this box part
    from float64 by up to 3e-2 eV/A (reciprocal and pair terms of 3e4 eV
    nearly cancel), and a cycle moves an atom by step_size * F with
    step_size <= 1e-3 * 1.2^5, so 5 cycles may part by 5 * 2.5e-3 * 3e-2 A;
    the energy falls; finite positions, both files written, an NPT
    pressure; a second run finds the outputs and skips."""
    pdb = str(tmp_path / "ala2.pdb")
    write_pdb(pdb, TB.build_polyalanine(2))
    kw = dict(max_cyc=5, padding=4.0, heat_stages=(100.0,), heat_steps=10, nvt_steps=10,
              npt_steps=10)
    (tmp_path / "j").mkdir()
    jseen = _counting(monkeypatch, JMM, "mm_energy_forces_dense", True)
    jlines, jlog = _logged(jseen)
    JP.Preprocessor(log_dir=str(tmp_path / "j"), **kw).run(pdb, log=jlog)
    tlines, tlog = _logged(_counting(monkeypatch, TMM, "mm_energy_forces_virial_dense", False))
    (tmp_path / "t").mkdir()
    pre = TP.Preprocessor(log_dir=str(tmp_path / "t"), device="cpu", **kw)
    out = pre.run(pdb, log=tlog)
    blocking = lambda lines: [(m, n) for m, n in lines if m.startswith("  ")]
    assert [m for m, _ in tlines] == [m.replace(str(tmp_path / "j"), str(tmp_path / "t"))
                                      for m, _ in jlines]
    assert blocking(tlines) == blocking(jlines)
    assert [n for _, n in blocking(tlines)] == [2, 10 + 1 + 10, 10 + 1 + 10 + 500,
                                                10 + 1 + 10 + 500 + 10]
    assert {k: v["steps"] for k, v in pre.stages.items()} == {
        "minimize": 10, "heat 100 K": 10, "NVT": 500, "NPT": 10}
    np.testing.assert_allclose(pre.minimized.numpy(), jseen[10], rtol=0, atol=5e-4)
    assert np.abs(pre.minimized.numpy() - box["P"]).max() > 1e-3
    e_before, e_after = pre.energies["minimize"]
    assert e_after < e_before
    b = read_pdb(out)
    assert len(b) == 251 and np.isfinite(b.positions).all()
    assert (tmp_path / "t" / "ala2-preeq-nowat.pdb").exists()
    assert np.isfinite(pre.last_npt_pressure_bar) and len(pre.npt_pressures_bar) == 1
    again = []
    assert pre.run(pdb, log=again.append) == out
    assert again == [f"preprocessing outputs exist, skipping ({out})"]


def test_the_amoeba_method_minimizes_the_box(tmp_path):
    """Preprocessor(method="AMOEBA") on ACE-ALA-ALA-NME (padding 4 A, cutoff
    5 A, max_cyc 20, as tests/test_preprocess.py runs JAX's): JAX's log
    lines, the energy falling, the minimized box written with its
    protein-only companion."""
    pdb = str(tmp_path / "ala2.pdb")
    write_pdb(pdb, TB.build_polyalanine(2))
    logs = []
    pre = TP.Preprocessor(log_dir=str(tmp_path), max_cyc=20, padding=4.0, cutoff=5.0,
                          method="AMOEBA", device="cpu")
    out = pre.run(pdb, log=logs.append)
    assert out == str(tmp_path / "ala2-preeq.pdb")
    assert logs[2] == ("AMOEBA minimization (mutual polarization, Ewald induction, cutoff "
                       "5.0 A, max 20 cycles)")
    assert re.fullmatch(r"  \[20/20\] E = -?\d+\.\d\d eV, RMS \|F\| = \d+\.\d{3} kcal/mol/A",
                        logs[3]), logs[3]
    assert pre.stages["AMOEBA minimize"]["steps"] == 40 and len(pre.chunks) == 1
    e0, e1 = pre.energies["minimize"]
    assert e1 < e0
    box = read_pdb(out)
    assert len(box) == 251 and np.isfinite(box.positions).all()
    assert np.abs(box.positions - TP.solvate(TB.build_polyalanine(2), padding=4.0).positions
                  ).max() > 1e-2
    assert len(read_pdb(str(tmp_path / "ala2-preeq-nowat.pdb"))) == 32


def test_settle_from_topology_defaults_to_the_card(box, monkeypatch):
    """SettleConstraint.from_topology (and build) take the card unless given
    a device: without one they raise; with device="cpu" the box's waters
    (each O with its two H) are on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSET.SettleConstraint.from_topology(box["ttop"])
    c = TSET.SettleConstraint.from_topology(box["ttop"], device="cpu")
    assert c.o_idx.device.type == "cpu"
    np.testing.assert_array_equal(c.o_idx.numpy(), np.sort(box["ttop"].water_oxygens))
    np.testing.assert_array_equal(c.h1_idx.numpy(), c.o_idx.numpy() + 1)
