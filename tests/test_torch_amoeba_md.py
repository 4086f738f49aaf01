"""Pure-AMOEBA MD in the port (ai2bmd_torch.physics.amoeba_md, the unrolled
full-Ewald induction of physics/amoeba_system.py, Preprocessor(method=
"AMOEBA")) against the JAX package on the CPU, in float64 (JAX under
jax.enable_x64, its tables widened as tests/test_torch_amoeba.py builds
them).

Systems: the 24-atom water box of tests/test_amoeba_variational.py (cutoff
3 A, beta 0.6), and ACE-ALA-ALA-NME (32 atoms) alone in a 16 A cell (cutoff
5 A, beta 0.6), where the p-vs-d correction pcorr is not zero.  Inputs are
made from seeds with numpy.

The unrolled induction's position gradient is held at 3 and 8 PCG
iterations, far from convergence, against central differences of the same
energy (1e-7 of the largest component); the energy itself against JAX's
(1e-8 relative).  JAX's own jax.grad of these functions compiles for about
100 s each, so the direct comparisons with it are marked slow, as are the
whole-preprocessing and Langevin comparisons with JAX."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.data.protein_topology import build_topology as j_build_topology
from ai2bmd_tpu.io.pdb import PDBAtoms
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.physics.amoeba_md import AmoebaMD as JMD
from ai2bmd_tpu.physics.amoeba_protein import assign_amoeba as j_assign
from ai2bmd_tpu.physics.amoeba_system import AmoebaPeriodicSystem as JSystem
from ai2bmd_torch import preprocess as TP
from ai2bmd_torch.io import build as TB
from ai2bmd_torch.io.pdb import read_pdb, write_pdb
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.ops import neighbors as TNL
from ai2bmd_torch.physics.amoeba_md import AmoebaMD as TMD
from ai2bmd_torch.physics.amoeba_system import AmoebaPeriodicSystem as TSystem
from test_amoeba_md import _water_box_atoms
from test_amoeba_variational import _water_box

E_REL, F_REL = 1e-8, 1e-7


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_qmmm.py's): the workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def _rel(ref, x):
    ref, x = np.asarray(ref, np.float64), np.asarray(x, np.float64)
    return np.abs(ref - x).max() / np.abs(ref).max()


def _peptide_atoms(L: float = 16.0) -> PDBAtoms:
    """ACE-ALA-ALA-NME centred in an L-A cubic cell."""
    a = TB.build_polyalanine(2)
    return dataclasses.replace(a, positions=a.positions - a.positions.mean(0) + L / 2,
                               cell=np.full(3, L))


def _systems(kind: str):
    """(port system, JAX system, positions, port list, JAX list), both with
    float64 tables; the list is JAX's, copied."""
    if kind == "water":
        cell, P, asg = _water_box(m=2, L=6.4, seed=3)
        kw, k_max = dict(cutoff=3.0, beta=0.6, grid_spacing=0.7), 23
    else:
        atoms = _peptide_atoms()
        cell, P = atoms.cell, atoms.positions
        asg = j_assign(atoms.atom_names, atoms.residue_names, P,
                       j_build_topology(atoms).bonds)
        kw, k_max = dict(cutoff=5.0, beta=0.6, grid_spacing=0.8), 31
    ts = TSystem.build(asg, cell, device="cpu", dtype=torch.float64, table_dtype=np.float64,
                       **kw)
    with jax.enable_x64(True):
        js = JSystem.build(asg, cell, dtype=jnp.float64, **kw)
        nl = js.neighbor_list(jnp.asarray(P), k_max=k_max)
        assert not bool(nl.overflow)
        nl_t = TNL.NeighborList(T(nl.idx).long(), T(nl.valid), T(P), torch.tensor(False))
    return ts, js, P, nl_t, nl


def _fd_grad(fn, P, atoms, h=1e-5):
    """Central differences of fn (float64 [N,3] -> scalar) in the
    coordinates of ``atoms`` ([len(atoms), 3])."""
    g = np.zeros((len(atoms), 3))
    for n, a in enumerate(atoms):
        for c in range(3):
            d = np.zeros_like(P)
            d[a, c] = h
            g[n, c] = (float(fn(T(P + d))) - float(fn(T(P - d)))) / (2 * h)
    return g


def _value_and_grad(fn, P):
    X = T(P).requires_grad_(True)
    e = fn(X)
    (g,) = torch.autograd.grad(e, X)
    return float(e.detach()), g.numpy()


@pytest.mark.parametrize("kind", ["water", "peptide"])
@pytest.mark.parametrize("iters", [3, 8])
def test_unrolled_induction_gradient_is_the_energy_derivative(kind, iters):
    """induced_dipoles_ewald(...)[1] after 3 and 8 PCG iterations: its
    autograd position gradient against central differences of the same
    function on 12 atoms (the one with the largest gradient and 11 drawn
    from a seed), within 1e-7 of the largest component.  The right-hand
    side -E_d keeps its graph in the positions; without it the gradient
    parts from the derivative by 1.8e-2 (water, 3 iterations) and 2.6e-5
    (8)."""
    ts, _, P, nl, _ = _systems(kind)
    fn = lambda p: ts.induced_dipoles_ewald(p, nl, cg_iters=iters)[1]
    _, g = _value_and_grad(fn, P)
    top = int(np.abs(g).max(1).argmax())
    rest = np.random.default_rng(6).permutation(np.delete(np.arange(len(P)), top))[:11]
    atoms = np.concatenate([[top], rest])
    assert np.abs(_fd_grad(fn, P, atoms) - g[atoms]).max() / np.abs(g).max() < F_REL


def test_unrolled_energy_and_amoeba_md_energy_match_jax():
    """On the peptide box at a fixed list: the unrolled-induction energy
    energy_ewald_induction at 3 iterations against JAX's (its AmoebaMD.energy
    less its valence energy), 1e-8 relative; AmoebaMD.energy (that plus the
    valence terms, float32 valence tables in both packages) against JAX's
    AmoebaMD.energy; its forces are its
    energy's derivative along three random directions (central
    differences); the warm variant returns the same energy."""
    atoms = _peptide_atoms()
    kw = dict(cutoff=5.0, skin=0.5, cg_iters=3, grid_spacing=0.8, beta=0.6)
    md = TMD.build(atoms, device="cpu", dtype=torch.float64, table_dtype=np.float64, **kw)
    P = atoms.positions + np.random.default_rng(4).normal(0.0, 0.03, atoms.positions.shape)
    with jax.enable_x64(True):
        jmd = JMD.build(atoms, **kw)
        js = JSystem.build(j_assign(atoms.atom_names, atoms.residue_names, atoms.positions,
                                    j_build_topology(atoms).bonds), atoms.cell,
                           cutoff=5.0, beta=0.6, grid_spacing=0.8, dtype=jnp.float64)
        jmd = dataclasses.replace(jmd, sys=js, cell=jnp.asarray(atoms.cell, jnp.float64))
        Pj = jnp.asarray(P)
        nl = jmd.init_aux(Pj)
        e_j = float(jax.jit(lambda p: jmd.energy(p, nl))(Pj))
        e_nb_j = e_j - float(jmd.val.energy(Pj, jmd.cell))
        nl_t = TNL.NeighborList(T(nl.idx).long(), T(nl.valid), T(P), torch.tensor(False))
    Pt = T(P)
    assert float(md.sys.energy_ewald_induction(Pt, nl_t, 3)) == pytest.approx(e_nb_j, rel=E_REL)
    e, f = md.energy_forces(Pt, nl_t)
    assert float(e) == pytest.approx(e_j, rel=E_REL)
    rng = np.random.default_rng(5)
    for _ in range(3):
        d = rng.standard_normal(P.shape)
        d /= np.linalg.norm(d)
        h = 1e-5
        num = -(float(md.energy(T(P + h * d), nl_t)) - float(md.energy(T(P - h * d), nl_t))) / (
            2 * h)
        assert float((f * T(d)).sum()) == pytest.approx(num, rel=1e-6, abs=1e-9)
    e_w, m = md.sys.energy_ewald_induction_warm(Pt, nl_t, None, cg_iters=3)
    assert float(e_w) == pytest.approx(float(md.sys.energy_ewald_induction(Pt, nl_t, 3)),
                                       rel=1e-14)
    assert not m.requires_grad and m.shape == Pt.shape


@pytest.fixture(scope="module")
def water_md():
    """27 jittered AMOEBA waters (tests/test_amoeba_md.py's box, 9.3 A),
    cutoff 4 A, skin 0.6, 8 PCG iterations, float32 on the CPU."""
    atoms = _water_box_atoms(jitter=0.08)
    return atoms, TMD.build(atoms, cutoff=4.0, skin=0.6, cg_iters=8, grid_spacing=1.2,
                            device="cpu")


def test_build_terms_and_list(water_md):
    """The valence terms cover every water (2 bonds, 1 angle, 1 Urey-Bradley
    each), beta = 3.6 / cutoff, K from the density rule, the box too small
    for the cell build (the dense list), no overflow."""
    atoms, md = water_md
    nw = len(atoms) // 3
    assert md.val.bond_ij.shape[0] == 2 * nw and md.val.ang_ijk.shape[0] == nw
    assert md.val.ub_ik.shape[0] == nw
    assert md.sys.pme.beta == pytest.approx(0.9) and md.k_max == 64 and md.nl_grid is None
    nl = md.init_aux(T(atoms.positions).float())
    assert not bool(nl.overflow) and nl.idx.shape == (len(atoms), 64)


def test_minimize_lowers_the_energy_and_restarts_its_step(water_md):
    """Two calls of minimize (5 cycles each, chunks of 5): each cycle's
    starting energy never rises, the second call starts where the first
    ended, and the positions stay finite."""
    atoms, md = water_md
    P1, e1 = md.minimize(atoms.positions, steps=5, chunk=5)
    P2, e2 = md.minimize(P1, steps=5, chunk=5)
    es = np.array(e1 + e2)
    assert len(es) == 10 and np.isfinite(P2).all()
    assert (np.diff(es) <= 0).all() and es[-1] < es[0] - 0.05
    assert e2[0] == pytest.approx(e1[-1], abs=1e-3) or e2[0] < e1[-1]


def test_langevin_steps_carry_the_list(water_md):
    """initial_state with an explicit generator, then 3 Langevin steps of the
    stateful potential (the list rebuilt every call, overflow sticky):
    finite positions and energies, the list of the last positions;
    make_step_fn's captured steps need the card."""
    atoms, md = water_md
    g = torch.Generator().manual_seed(0)
    state = md.initial_state(atoms.positions, g, temp_K=100.0)
    masses = torch.as_tensor(md.masses, dtype=torch.float32)
    coeffs = TL.LangevinCoeffs.build(md.masses, 0.5, 100.0, 0.01, device="cpu")
    for _ in range(3):
        state = TL.langevin_step(md, coeffs, masses, state, generator=g)
    assert torch.isfinite(state.positions).all() and torch.isfinite(state.energy)
    assert state.aux.ref_pos is state.positions and not bool(state.aux.overflow)
    with pytest.raises(RuntimeError, match="CUDA graphs need the card"):
        md.make_step_fn(state, g)


def test_entry_points_default_to_the_card(water_md, monkeypatch):
    atoms, _ = water_md
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMD.build(atoms)
    with pytest.raises(ValueError, match="periodic cell"):
        TMD.build(dataclasses.replace(atoms, cell=None), device="cpu")


# ---------------------------------------------------------------------------
# against JAX's compiled gradients and protocols (minutes of JAX compiles)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("kind", ["water", "peptide"])
@pytest.mark.parametrize("iters", [3, 8])
def test_unrolled_induction_gradient_matches_jax_grad(kind, iters):
    """The port's position gradient of induced_dipoles_ewald(...)[1] against
    JAX's jax.grad of the same function, 1e-7 of the largest component, and
    the energies 1e-8 relative."""
    ts, js, P, nl_t, nl = _systems(kind)
    with jax.enable_x64(True):
        e_j, g_j = jax.jit(jax.value_and_grad(
            lambda p: js.induced_dipoles_ewald(p, nl, iters)[1]))(jnp.asarray(P))
        e_j, g_j = float(e_j), np.asarray(g_j)
    e, g = _value_and_grad(lambda p: ts.induced_dipoles_ewald(p, nl_t, cg_iters=iters)[1], P)
    assert e == pytest.approx(e_j, rel=E_REL)
    assert _rel(g_j, g) < F_REL


@pytest.mark.slow
def test_amoeba_md_energy_forces_match_jax():
    """AmoebaMD's energy and forces at a fixed list on the peptide box at 12
    iterations against JAX's jax.value_and_grad of AmoebaMD.energy."""
    atoms = _peptide_atoms()
    kw = dict(cutoff=5.0, skin=0.5, grid_spacing=0.8, beta=0.6)
    md = TMD.build(atoms, device="cpu", dtype=torch.float64, table_dtype=np.float64, **kw)
    P = atoms.positions + np.random.default_rng(4).normal(0.0, 0.03, atoms.positions.shape)
    with jax.enable_x64(True):
        jmd = JMD.build(atoms, **kw)
        js = JSystem.build(j_assign(atoms.atom_names, atoms.residue_names, atoms.positions,
                                    j_build_topology(atoms).bonds), atoms.cell,
                           cutoff=5.0, beta=0.6, grid_spacing=0.8, dtype=jnp.float64)
        jmd = dataclasses.replace(jmd, sys=js, cell=jnp.asarray(atoms.cell, jnp.float64))
        Pj = jnp.asarray(P)
        nl = jmd.init_aux(Pj)
        e_j, g_j = jax.jit(jax.value_and_grad(lambda p: jmd.energy(p, nl)))(Pj)
        nl_t = TNL.NeighborList(T(nl.idx).long(), T(nl.valid), T(P), torch.tensor(False))
    e, f = md.energy_forces(T(P), nl_t)
    assert float(e) == pytest.approx(float(e_j), rel=E_REL)
    assert _rel(-np.asarray(g_j), f.numpy()) < F_REL


@pytest.mark.slow
def test_preprocessor_amoeba_matches_jax(tmp_path):
    """Both packages' AMOEBA preprocessing of ACE-ALA-ALA-NME (padding 4 A,
    cutoff 5 A, max_cyc 20) in float32: the same log lines up to the
    energy's last digits, the minimized boxes within 2e-3 A.  The peptide's
    positions are moved by N(0, 0.02 A) from a seed: on the builder's exactly
    planar amides JAX's out-of-plane bend has NaN forces, so its descent
    never accepts a step (its line reads "E = 1.76 eV, RMS |F| = nan")."""
    pdb = str(tmp_path / "ala2.pdb")
    a = TB.build_polyalanine(2)
    write_pdb(pdb, dataclasses.replace(a, positions=a.positions + np.random.default_rng(
        8).normal(0.0, 0.02, a.positions.shape)))
    kw = dict(max_cyc=20, padding=4.0, cutoff=5.0, method="AMOEBA")
    from ai2bmd_tpu import preprocess as JP

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jlogs, tlogs = [], []
    jout = JP.Preprocessor(log_dir=str(tmp_path / "j"), **kw).run(pdb, log=jlogs.append)
    tout = TP.Preprocessor(log_dir=str(tmp_path / "t"), device="cpu", **kw).run(
        pdb, log=tlogs.append)
    assert tlogs[:3] == jlogs[:3]
    num = lambda s: [float(v) for v in re.findall(r"-?\d+\.\d+", s)]
    np.testing.assert_allclose(num(tlogs[3]), num(jlogs[3]), rtol=1e-3, atol=0.02)
    np.testing.assert_allclose(read_pdb(tout).positions, read_pdb(jout).positions, atol=2e-3)


@pytest.mark.slow
def test_langevin_steps_match_jax_on_its_noise(water_md):
    """Three Langevin steps of AmoebaMD in float32 on the water box from the
    same state, the port fed JAX's xi and eta: positions within 1e-5 A,
    energies within 1e-4 relative."""
    from test_torch_md import _jax_noise

    atoms, md = water_md
    jmd = JMD.build(atoms, cutoff=4.0, skin=0.6, cg_iters=8, grid_spacing=1.2)
    P = jnp.asarray(atoms.positions, jnp.float32)
    v = np.random.default_rng(2).normal(0.0, 0.005, atoms.positions.shape).astype(np.float32)
    jcoeffs = JL.LangevinCoeffs.build(jmd.masses, 0.5, 100.0, 0.01)
    e, f, nl = jax.jit(lambda p, a: jmd(p, a))(P, jmd.init_aux(P))
    key = jax.random.PRNGKey(7)
    js = JL.MDState(P, jnp.asarray(v), f, e, key, 0, aux=nl)
    tcoeffs = TL.LangevinCoeffs.build(md.masses, 0.5, 100.0, 0.01, device="cpu")
    masses = torch.as_tensor(md.masses, dtype=torch.float32)
    ef, ff, tnl = md(T(atoms.positions).float(), md.init_aux(T(atoms.positions).float()))
    ts = TL.MDState(T(atoms.positions).float(), T(v), ff, ef, aux=tnl)
    step = jax.jit(lambda s: JL.langevin_step(jmd, jcoeffs, jmd.masses, s))
    for _ in range(3):
        xi, eta = _jax_noise(js.key, P.shape)
        js = step(js)
        ts = TL.langevin_step(md, tcoeffs, masses, ts, xi=T(xi), eta=T(eta))
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions), atol=1e-5)
    assert float(ts.energy) == pytest.approx(float(js.energy), rel=1e-4)
