"""The port's AMOEBA valence terms (ai2bmd_torch.physics.amoeba_valence)
against the JAX package's, on the CPU.

The system is Chignolin with a lattice of AMOEBA waters in its periodic
cell (tests/test_qmmm_amoeba.py's synthetic box): every term kind the
amoebabio18 assignment gives a protein and water (bonds, Urey-Bradley,
angles, in-plane angles, stretch-bends, out-of-plane bends, torsions,
pi-orbital torsions, torsion-torsions), and stretch-torsions and
angle-torsions, which amoebabio18 has only for nucleic acids, added to both
packages' tables on the protein's torsions.  Tables are compared for
equality; energies term by term, the total and the gradient on positions
perturbed from a seed, in float64 positions on both packages' float32
tables (JAX under jax.enable_x64): 1e-8 relative and 1e-7 of the largest
gradient component."""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.data.protein_topology import build_topology as j_build_topology
from ai2bmd_tpu.physics import amoeba_valence as JV
from ai2bmd_tpu.physics.amoeba_protein import assign_amoeba as j_assign
from ai2bmd_torch import units
from ai2bmd_torch.physics import amoeba_valence as TV
from test_qmmm_amoeba import _synthetic_solvated

E_REL, F_REL = 1e-8, 1e-7
# the index table of each term; JAX's energy skips a term whose table is empty
TERMS = {"bond": "bond_ij", "ub": "ub_ik", "ang": "ang_ijk", "angp": "angp_ijkd",
         "sb": "sb_ijk", "opb": "opb_dbac", "tor": "tor_ijkl", "pit": "pit_atoms",
         "st": "st_ijkl", "at": "at_ijkl", "tt": "tt_atoms"}


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


def _with_nucleic_terms(jv, tv, n: int = 24):
    """Both packages' tables with stretch-torsions and angle-torsions added
    on the first n torsions: amoebabio18 has them only for nucleic acids,
    so a protein's assignment has none (the tables test holds that).  Their
    constants are the prm's records in turn, r0 and theta0 from a seed."""
    val = TV.load_valence_tables()
    rng = np.random.default_rng(2)
    ijkl = np.asarray(jv.tor_ijkl[:n])
    rows = np.arange(n) % len(val["strtors"])
    tabs = dict(st_ijkl=ijkl, st_k=val["strtors"][rows, 4:13],
                st_r0=rng.uniform(1.0, 1.6, (n, 3)), at_ijkl=ijkl,
                at_k=val["angtors"][rows, 4:10], at_t0=rng.uniform(100.0, 120.0, (n, 2)))
    jv = dataclasses.replace(jv, **{k: jnp.asarray(v, jnp.int32 if k.endswith("ijkl")
                                                      else jnp.float32)
                                    for k, v in tabs.items()})
    tv = dataclasses.replace(tv, **{k: torch.as_tensor(np.asarray(getattr(jv, k)).astype(
        np.int64 if k.endswith("ijkl") else np.float32)) for k in tabs})
    return jv, tv


@pytest.fixture(scope="module")
def chig_waters():
    """Both packages' valence terms of the box with the chirality signs set
    from the build geometry; perturbed positions; JAX's energy and gradient
    of each term alone and of the total (one jit)."""
    atoms, n_p, _ = _synthetic_solvated()
    asg = j_assign(atoms.atom_names, atoms.residue_names, atoms.positions,
                   j_build_topology(atoms).bonds)
    jv = JV.resolve_chirality_signs(JV.AmoebaValence.build(asg), atoms.positions, asg.bonds)
    tv = TV.resolve_chirality_signs(TV.AmoebaValence.build(asg, device="cpu"),
                                    atoms.positions, asg.bonds)
    jv, tv = _with_nucleic_terms(jv, tv)
    P = atoms.positions + np.random.default_rng(1).normal(0.0, 0.05, atoms.positions.shape)
    with jax.enable_x64(True):
        cell = jnp.asarray(atoms.cell)

        def alone(term):
            return dataclasses.replace(jv, **{
                f: jnp.zeros((0, getattr(jv, f).shape[1]), jnp.int32)
                for t, f in TERMS.items() if t != term})

        variants = [alone(t) for t in TERMS] + [jv]
        ref = jax.jit(lambda p: [jax.value_and_grad(lambda q: v.energy(q, cell))(p)
                                 for v in variants])(jnp.asarray(P))
        ref = {k: (float(e), np.asarray(g)) for k, (e, g) in zip([*TERMS, "total"], ref)}
    return atoms, asg, jv, tv, P, ref


def test_tables_and_chirality_signs_equal_jax(chig_waters):
    """Every table of AmoebaValence.build equals JAX's (float32 values, int
    indices), the scalar conventions too; every term kind but the nucleic
    acids' stretch- and angle-torsions is present; the torsion-torsion signs
    from the build geometry (+1, L-chirality) and from its mirror image (-1)
    equal JAX's."""
    atoms, asg, _, _, _, _ = chig_waters
    jv = JV.resolve_chirality_signs(JV.AmoebaValence.build(asg), atoms.positions, asg.bonds)
    tv = TV.resolve_chirality_signs(TV.AmoebaValence.build(asg, device="cpu"),
                                    atoms.positions, asg.bonds)
    for f in dataclasses.fields(jv):
        a, b = getattr(jv, f.name), getattr(tv, f.name)
        if isinstance(a, (int, dict)):
            assert a == b, f.name
        else:
            assert b.dtype == (torch.int64 if a.dtype == jnp.int32 else torch.float32), f.name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f.name)
    for t, f in TERMS.items():
        assert (getattr(tv, f).shape[0] > 0) == (t not in ("st", "at")), t
    assert tv.tt_sign.tolist() == [1.0]
    mirror = atoms.positions * np.array([-1.0, 1.0, 1.0])
    js = JV.resolve_chirality_signs(jv, mirror, asg.bonds).tt_sign
    ts = TV.resolve_chirality_signs(tv, mirror, asg.bonds).tt_sign
    assert ts.tolist() == np.asarray(js).tolist() == [-1.0]


@pytest.mark.parametrize("term", [*TERMS, "total"])
def test_energy_and_gradient_match_jax(chig_waters, term):
    """Each term alone (term_energies) and the total (energy), with its
    position gradient, in the periodic cell on perturbed positions."""
    atoms, _, _, tv, P, ref = chig_waters
    X = T(P).requires_grad_(True)
    cell = T(atoms.cell)
    e = tv.energy(X, cell) if term == "total" else tv.term_energies(X, cell)[term]
    (g,) = torch.autograd.grad(e, X)
    e_j, g_j = ref[term]
    assert float(e.detach()) == pytest.approx(e_j, rel=E_REL)
    assert np.abs(g.numpy() - g_j).max() < F_REL * np.abs(g_j).max()


def test_missing_parameters_raise_jax_key_error():
    """A bond between classes with no record raises JAX's KeyError, naming
    the class tuple."""
    asg = types.SimpleNamespace(n_atoms=2, atype=np.array([349, 352]),
                                bonds=np.array([[0, 1]], np.int32))
    with pytest.raises(KeyError) as jerr:
        JV.AmoebaValence.build(asg)
    with pytest.raises(KeyError) as terr:
        TV.AmoebaValence.build(asg, device="cpu")
    assert str(terr.value) == str(jerr.value) and "bond parameters" in str(terr.value)


def test_water_terms_match_tinker_formulas():
    """One water (tests/test_amoeba_valence.py's hand-evaluated Tinker
    formulas, amoebabio18's 556.85 / 0.9572, 48.70 / 108.5, -7.60 /
    1.5537): bond, angle sextic in degrees and Urey-Bradley."""
    asg = types.SimpleNamespace(n_atoms=3, atype=np.array([349, 350, 350]),
                                bonds=np.array([[0, 1], [0, 2]], np.int32))
    tv = TV.AmoebaValence.build(asg, device="cpu")
    r1, r2, th = 0.99, 0.93, math.radians(104.0)
    P = torch.tensor([[0.0, 0.0, 0.0], [r1 * math.sin(th / 2), r1 * math.cos(th / 2), 0.0],
                      [-r2 * math.sin(th / 2), r2 * math.cos(th / 2), 0.0]], dtype=torch.float64)
    terms = {k: float(v) / units.kcal_per_mol for k, v in tv.term_energies(P).items()}
    bond = lambda dt: 556.85 * dt * dt * (1 - 2.55 * dt + 3.793125 * dt * dt)
    dtd = math.degrees(th) - 108.50
    ang = ((math.pi / 180.0) ** 2 * 48.70 * dtd * dtd
           * (1 - 0.014 * dtd + 5.6e-5 * dtd ** 2 - 7e-7 * dtd ** 3 + 2.2e-8 * dtd ** 4))
    r13 = math.sqrt(r1 * r1 + r2 * r2 - 2 * r1 * r2 * math.cos(th))
    assert set(terms) == {"bond", "ang", "ub"}
    assert terms["bond"] == pytest.approx(bond(r1 - 0.9572) + bond(r2 - 0.9572), rel=1e-6)
    assert terms["ang"] == pytest.approx(ang, rel=1e-6)
    assert terms["ub"] == pytest.approx(-7.60 * (r13 - 1.5537) ** 2, rel=1e-5)


def test_tortors_spline_at_its_nodes(chig_waters):
    """The torsion-torsion spline, evaluated as the energy evaluates it (the
    cell lookup, then the bicubic in the offsets), is the grid's value at
    every node of every grid, in eV, and the grid's repeated +180 row and
    column wrap onto -180."""
    _, _, _, tv, _, _ = chig_waters
    full = torch.as_tensor(TV.load_valence_tables()["tortors_grid"]) * units.kcal_per_mol
    R = tv.tt_res
    assert full.shape[1:] == (R + 1, R + 1)
    nodes = torch.tensor([-math.pi + 2.0 * math.pi * g / R for g in range(R + 1)],
                         dtype=torch.float64)
    p1, p2 = torch.meshgrid(nodes, nodes, indexing="ij")
    gi, t = TV._spline_cell(p1.reshape(-1), R)
    gj, u = TV._spline_cell(p2.reshape(-1), R)
    pw = lambda x: torch.stack([torch.ones_like(x), x, x * x, x * x * x], dim=-1)
    for g in range(full.shape[0]):
        C = tv.tt_coeffs[g, gi, gj].double()
        value = torch.einsum("mij,mi,mj->m", C, pw(t), pw(u)).reshape(R + 1, R + 1)
        np.testing.assert_allclose(value.numpy(), full[g].numpy(), rtol=0, atol=2e-6)
