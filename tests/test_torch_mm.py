"""The port's ff19SB MM engine (ai2bmd_torch.physics.mm, .cellpair,
ai2bmd_torch.ops.neighbors, ai2bmd_torch.data.protein_topology) against the
JAX package's on the CPU, with the same numpy inputs: the solvated Chignolin
box's topology arrays; the dense, cell-bucket and neighbour-list pair paths
on tests/test_cellpair.py's 600-atom random box (float32, 1e-4 of the
scale); the bonded terms with CMAP and the reciprocal / exclusion terms on
Chignolin; the rebuild criteria and the cell-bucket overflow flag."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu.data import protein_topology as JPT
from ai2bmd_tpu.io.pdb import read_pdb as j_read
from ai2bmd_tpu.io.reorder import normalize_atom_order as j_norm
from ai2bmd_tpu.ops import neighbors as JNL
from ai2bmd_tpu.physics import cellpair as JCP
from ai2bmd_tpu.physics import mm as JMM
from ai2bmd_tpu.physics import qmmm as JQ
from ai2bmd_torch.data import protein_topology as TPT
from ai2bmd_torch.host import normalize_atom_order, read_pdb
from ai2bmd_torch.ops import neighbors as TNL
from ai2bmd_torch.physics import cellpair as TCP
from ai2bmd_torch.physics import mm as TMM
from ai2bmd_torch.physics import qmmm as TQ

T = lambda a: torch.as_tensor(np.asarray(a))
CUTOFF = 6.0


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_box(rng, n=600, L=21.0):
    """tests/test_cellpair.py's uniform box: random positions, charges, LJ."""
    P = rng.uniform(0, L, size=(n, 3))
    q = rng.normal(size=n) * 0.4
    q -= q.mean()
    return (P.astype(np.float32), q.astype(np.float32), rng.uniform(1.8, 3.4, size=n),
            rng.uniform(0.01, 0.2, size=n), np.array([L, L, L]))


def _bare_topology(cls, q, sig, eps):
    n = len(q)
    z = lambda k: np.zeros((0, k), np.int64)
    return cls(n_atoms=n, charges=q, sigmas=sig, epsilons=eps / JMM.KCAL, masses=np.ones(n),
               bonds=z(2), bond_k=np.zeros(0), bond_r0=np.zeros(0), angles=z(3),
               angle_k=np.zeros(0), angle_t0=np.zeros(0), dihedrals=z(4), dih_k=np.zeros(0),
               dih_n=np.zeros(0), dih_phase=np.zeros(0), excl_pairs=z(2), pairs14=z(2),
               water_oxygens=np.zeros(0, np.int32), protein_atoms=np.zeros(0, np.int32))


@pytest.fixture(scope="module")
def box():
    P, q, sig, eps, cell = _random_box(np.random.default_rng(0))
    jm = JMM.MMSystem.build(_bare_topology(JPT.SystemTopology, q, sig, eps), cell, cutoff=CUTOFF)
    tm = TMM.MMSystem.build(_bare_topology(TPT.SystemTopology, q, sig, eps), cell, cutoff=CUTOFF,
                            device="cpu")
    return P, cell, jm, tm


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def test_topology_of_the_solvated_box_matches_jax():
    """build_topology on chig-preeq.pdb (17,882 atoms: protein, 5,900 TIP3P
    waters, ions) and its protein subsystem: every array equal to the JAX
    package's."""
    conftest.require_examples()
    path = conftest.example_pdb("chig-preeq")
    j_top = JPT.build_topology(j_norm(j_read(path)))
    t_top = TPT.build_topology(normalize_atom_order(read_pdb(path)))
    assert t_top.n_atoms == 17882 and len(t_top.water_oxygens) > 5000
    for a, b in ((t_top, j_top), (TQ._subsystem_topology(t_top, t_top.protein_atoms),
                                  JQ._subsystem_topology(j_top, j_top.protein_atoms))):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
                assert x.dtype == y.dtype, f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("path", ["dense", "cellpair", "nl"])
def test_pair_paths_match_jax(box, path):
    """E and F of each direct-space route against the JAX package's same
    route (nl: the whole neighbour-list energy, reciprocal terms included,
    through autograd); the cell-bucket route also against the port's dense
    one."""
    P, cell, jm, tm = box
    Pj, Pt = jnp.asarray(P), T(P)
    if path == "dense":
        e_j, f_j, w_j = JMM.dense_pair_energy_forces(jm, Pj, tile=256)
        e_t, f_t, w_t = TMM.dense_pair_energy_forces(tm, Pt, tile=256)
        _close(w_t, w_j)
    elif path == "cellpair":
        jcp, tcp = JCP.build_cellpairs(cell, CUTOFF, len(P)), TCP.build_cellpairs(
            cell, CUTOFF, len(P), "cpu")
        assert (tcp.nc3, tcp.occ, tcp.skin) == (jcp.nc3, jcp.occ, jcp.skin)
        np.testing.assert_array_equal(tcp.nbr.numpy(), np.asarray(jcp.nbr))
        js, ts = JCP.assign(jcp, Pj), TCP.assign(tcp, Pt)
        assert not bool(ts.overflow)
        np.testing.assert_array_equal(ts.bucket_idx.numpy(), np.asarray(js.bucket_idx))
        e_j, f_j, _ = JCP.pair_energy_forces(jcp, js, Pj, jm.charge, jm.sigma, jm.eps, jm.beta)
        e_t, f_t, _ = TCP.pair_energy_forces(tcp, ts, Pt, tm.charge, tm.sigma, tm.eps, tm.beta,
                                             cell_chunk=5)
        e_d, f_d, _ = TMM.dense_pair_energy_forces(tm, Pt)
        _close(e_t, e_d, 1e-5)
        _close(f_t, f_d, 1e-5)
    else:
        nl_j = JNL.build_neighbor_list(Pj, CUTOFF + 1.0, 128, jnp.asarray(cell, jnp.float32))
        nl_t = TNL.build_neighbor_list(Pt, CUTOFF + 1.0, 128, tm.cell)
        assert not bool(nl_t.overflow) and not bool(nl_j.overflow)
        e_j, f_j = jax.jit(lambda p: JMM.mm_energy_forces(jm, p, nl_j))(Pj)
        e_t, f_t = TMM.mm_energy_forces(tm, Pt, nl_t)
    _close(e_t, e_j)
    _close(f_t.numpy(), f_j)


def test_neighbor_list_builds_match_jax(box):
    """The tiled dense build and the cell-list build give JAX's pair set
    (each row's valid neighbours as a set)."""
    P, cell, _, tm = box
    nc, occ = TNL.cell_grid(cell, CUTOFF, len(P))
    assert (nc, occ) == JNL.cell_grid(cell, CUTOFF, len(P))
    jl = JNL.build_neighbor_list(jnp.asarray(P), CUTOFF, 96, jnp.asarray(cell, jnp.float32))
    rows = lambda nl: [set(i[v].tolist()) for i, v in zip(np.asarray(nl.idx),
                                                          np.asarray(nl.valid))]
    want = rows(jl)
    for nl in (TNL.build_neighbor_list(T(P), CUTOFF, 96, tm.cell, tile=128),
               TNL.build_neighbor_list_cells(T(P), CUTOFF, 96, tm.cell, nc, occ)):
        assert not bool(nl.overflow)
        assert rows(nl) == want


@pytest.fixture(scope="module")
def chig_mm():
    """Chignolin's own topology (CMAP included) in both packages."""
    conftest.require_examples()
    path = conftest.example_pdb("chig")
    j_atoms, t_atoms = j_norm(j_read(path)), normalize_atom_order(read_pdb(path))
    jm = JMM.MMSystem.build(JPT.build_topology(j_atoms), j_atoms.cell)
    tm = TMM.MMSystem.build(TPT.build_topology(t_atoms), t_atoms.cell, device="cpu")
    return t_atoms.positions.astype(np.float32), jm, tm


@pytest.mark.parametrize("term", ["cmap", "bonded", "recip_excl"])
def test_bonded_cmap_and_reciprocal_terms_match_jax(chig_mm, term):
    """Chignolin's CMAP (ff19SB, bicubic), all bonded terms, and the PME
    reciprocal + exclusion / 1-4 corrections: energy and autograd forces
    against JAX's jax.grad, float32, 1e-4 of the scale."""
    P, jm, tm = chig_mm
    assert tm.cmap_atoms.shape[0] == jm.cmap_atoms.shape[0] > 0
    np.testing.assert_allclose(tm.cmap_coeffs.numpy(), np.asarray(jm.cmap_coeffs), rtol=1e-6)
    fj = {"cmap": lambda p: JMM.cmap_energy(jm, p, jm.cell),
          "bonded": lambda p: JMM.bonded_energy(jm, p),
          "recip_excl": lambda p: JMM._recip_excl_energy(jm, p)}[term]
    ft = {"cmap": TMM.cmap_energy, "bonded": TMM.bonded_energy,
          "recip_excl": TMM._recip_excl_energy}[term]
    e_j, g_j = jax.jit(jax.value_and_grad(fj))(jnp.asarray(P))
    p = T(P).requires_grad_(True)
    e_t = ft(tm, p)
    (g_t,) = torch.autograd.grad(e_t, p)
    _close(float(e_t.detach()), float(e_j))
    _close(g_t.numpy(), g_j)


def test_rebuild_criteria_and_assign_overflow(box):
    """needs_rebuild (cell buckets and neighbour lists) trips past half the
    skin and not before; a cluster of atoms in one cell sets assign's
    overflow flag, as it does JAX's."""
    P, cell, _, tm = box
    cp = TCP.build_cellpairs(cell, CUTOFF, len(P), "cpu")
    st = TCP.assign(cp, T(P))
    small, large = T(np.full((len(P), 3), 0.4 * cp.skin / np.sqrt(3), np.float32)), T(
        np.zeros((len(P), 3), np.float32))
    large[7, 1] = 0.6 * cp.skin
    assert not bool(TCP.needs_rebuild(cp, st, T(P) + small))
    assert bool(TCP.needs_rebuild(cp, st, T(P) + large))
    nl = TNL.build_neighbor_list(T(P), CUTOFF + 1.0, 128, tm.cell)
    assert not bool(TNL.needs_rebuild(nl, T(P) + 0.9 * small, 1.0, tm.cell))
    assert bool(TNL.needs_rebuild(nl, T(P) + large, 0.5 * cp.skin, tm.cell))
    crowd = P.copy()
    crowd[: cp.occ + 3] = np.float32(1.0) + 0.01 * np.arange(cp.occ + 3, dtype=np.float32)[:, None]
    got, want = TCP.assign(cp, T(crowd)), JCP.assign(JCP.build_cellpairs(cell, CUTOFF, len(P)),
                                                     jnp.asarray(crowd))
    assert bool(got.overflow) and bool(want.overflow)
    assert not bool(TNL.build_neighbor_list(T(P), CUTOFF, 256, tm.cell).overflow)
    assert bool(TNL.build_neighbor_list(T(P), CUTOFF, 4, tm.cell).overflow)
