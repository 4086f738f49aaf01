"""The port's AMOEBA engine (ai2bmd_torch.physics.amoeba, amoeba_protein,
amoeba_pme, amoeba_system) against the JAX package's, on the CPU in float64
(JAX under jax_enable_x64, as tests/test_amoeba_variational.py runs it).

Inputs are made from seeds with numpy.  The assignment is held on Chignolin
with waters and both ion kinds (tables equal), the multipole rotation on
every frame kind that assignment holds, the mesh against JAX's and against
the direct k-space sum, and the periodic system's pieces on the 2 x 2 x 2
water box of tests/test_amoeba_variational.py (24 atoms): the packed
multipoles, the permanent and vdW energies with their gradients, the
mutual operator on a random vector, the induction functional F(m) with its
gradient and the p-vs-d correction.  Each JAX function is jitted alone and
evaluated once (module fixture): a whole-energy JAX compile takes minutes
(tests/test_torch_amoeba_qmmm.py holds the whole step, marked slow).
Tolerances: energies 1e-8 relative, gradients 1e-7 of the largest
component."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.data.protein_topology import build_topology as j_build_topology
from ai2bmd_tpu.io.pdb import PDBAtoms
from ai2bmd_tpu.physics import amoeba as JA
from ai2bmd_tpu.physics import amoeba_pme as JMP
from ai2bmd_tpu.physics.amoeba_protein import assign_amoeba as j_assign
from ai2bmd_tpu.physics.amoeba_system import AmoebaPeriodicSystem as JSystem
from ai2bmd_torch.ops import neighbors as TNL
from ai2bmd_torch.physics import amoeba as TA
from ai2bmd_torch.physics import amoeba_pme as TMP
from ai2bmd_torch.physics.amoeba_protein import assign_amoeba as t_assign
from ai2bmd_torch.physics.amoeba_system import AmoebaPeriodicSystem as TSystem
from test_amoeba_variational import _water_box
from test_qmmm_amoeba import _synthetic_solvated

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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def ions_box():
    """Chignolin, its lattice waters (tests/test_qmmm_amoeba.py's synthetic
    box) and one Na+ and one Cl- in the cell's corners."""
    atoms, n_p, _ = _synthetic_solvated()
    corners = np.array([[1.0, 1.0, 1.0], atoms.cell - 1.0])
    return PDBAtoms(
        positions=np.concatenate([atoms.positions, corners]),
        numbers=np.concatenate([atoms.numbers, [11, 17]]).astype(np.int32),
        atom_names=np.concatenate([atoms.atom_names, ["Na+", "Cl-"]]),
        residue_names=np.concatenate([atoms.residue_names, ["Na+", "Cl-"]]),
        residue_numbers=np.concatenate([atoms.residue_numbers,
                                        atoms.residue_numbers.max() + [1, 2]]).astype(np.int32),
        cell=atoms.cell), n_p


def test_assign_amoeba_tables_equal_jax_on_chignolin_waters_and_ions(ions_box):
    """Every per-atom table and pair list of assign_amoeba equals JAX's, on
    protein atoms, waters and both ion kinds."""
    atoms, _ = ions_box
    bonds = j_build_topology(atoms).bonds
    ja = j_assign(atoms.atom_names, atoms.residue_names, atoms.positions, bonds)
    ta = t_assign(atoms.atom_names, atoms.residue_names, atoms.positions, bonds)
    for f in ("atype", "q", "dip_loc", "quad_loc", "frame_z", "frame_x", "frame_kind", "alpha",
              "thole", "group_id", "vdw_rmin", "vdw_eps", "vdw_red", "heavy_of", "scale_pairs",
              "scale_order", "group_pairs", "bonds"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), err_msg=f)
    assert set(ta.atype[-2:]) == {int(t) for t in ja.atype[-2:]}
    assert (ta.frame_z[-2:] == np.arange(len(atoms) - 2, len(atoms))).all()   # monatomic


def test_rotate_multipoles_every_frame_kind(ions_box, rng):
    """Lab-frame dipoles and quadrupoles on perturbed positions against JAX's
    rotate_multipoles: Z-then-X, bisector, and the monatomic ions (which
    rotate to zero)."""
    atoms, _ = ions_box
    bonds = j_build_topology(atoms).bonds
    a = t_assign(atoms.atom_names, atoms.residue_names, atoms.positions, bonds)
    kinds = set(a.frame_kind.tolist())
    assert kinds == {0, 1}
    assert (a.frame_z == np.arange(len(atoms))).sum() == 2
    P = atoms.positions + rng.normal(0.0, 0.05, atoms.positions.shape)
    args = (a.frame_z, a.frame_x, a.frame_kind, a.dip_loc, a.quad_loc)
    with jax.enable_x64(True):
        mj, tj = jax.jit(JA.rotate_multipoles)(jnp.asarray(P), *map(jnp.asarray, args))
        mj, tj = np.asarray(mj), np.asarray(tj)
    mt, tt = TA.rotate_multipoles(T(P), *map(T, args))
    np.testing.assert_allclose(mt.numpy(), mj, rtol=0, atol=1e-13)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=1e-13)
    assert mt[-2:].abs().max() == 0.0 and tt[-2:].abs().max() == 0.0


def test_reciprocal_energy_matches_jax_and_the_direct_sum(rng):
    """The mesh (order-6 splines spread by index_add) against JAX's dense
    spread, 1e-10 relative, and against the exact k-space sum of
    ewald_multipole_direct (numpy), 2e-5 e^2/A; the direct sum's real part
    (pair_energy_kernel by torch.func) against the closed form of
    multipole_pair_energy_soa."""
    n, cell, beta = 8, np.array([14.0, 15.0, 13.0]), 0.5
    P = rng.random((n, 3)) * cell
    q = rng.standard_normal(n)
    q -= q.mean()
    mu = rng.standard_normal((n, 3)) * 0.3
    A = rng.standard_normal((n, 3, 3)) * 0.2
    th = 0.5 * (A + np.transpose(A, (0, 2, 1)))
    th -= np.eye(3)[None] * np.trace(th, axis1=1, axis2=2)[:, None, None] / 3
    pme_t = TMP.MultipoleEwaldParams.build(cell, beta=beta, grid_spacing=0.45, device="cpu")
    e_t = float(TMP.reciprocal_energy(pme_t, T(P), T(q), T(mu), T(th)))
    with jax.enable_x64(True):
        pme_j = JMP.MultipoleEwaldParams.build(cell, beta=beta, grid_spacing=0.45)
        assert pme_j.grid == pme_t.grid
        e_j = float(jax.jit(lambda *a: JMP.reciprocal_energy(pme_j, *a))(
            *map(jnp.asarray, (P, q, mu, th))))
    assert e_t == pytest.approx(e_j, rel=1e-10)
    e_real, e_rec, e_self = TMP.ewald_multipole_direct(P, q, mu, th, cell, beta, kmax=10)
    assert e_t == pytest.approx(e_rec, abs=2e-5)
    ii, jj = np.triu_indices(n, 1)
    d = P[jj] - P[ii]
    d = d - cell * np.round(d / cell)
    x, y, z = (T(d[:, a]) for a in range(3))
    t6 = lambda t: tuple(T(t[:, a, b]) for a, b in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                                        (2, 2)])
    soa = TMP.multipole_pair_energy_soa(
        x, y, z, T(q[ii]), T(q[jj]), tuple(T(mu[ii, a]) for a in range(3)),
        tuple(T(mu[jj, a]) for a in range(3)), t6(th[ii]), t6(th[jj]),
        TMP.bn_chain_erfc(x * x + y * y + z * z, beta))
    assert float(soa.sum()) == pytest.approx(e_real, rel=1e-10)


def test_self_energy_and_point_multipole_terms_match_jax(rng):
    """self_energy's closed form against JAX's autodiff of the erf kernel at
    x = 0, on quadrupoles with a trace (as float32 tables leave them); the
    point-multipole pair energy (torch.func) and the Thole-damped fields of
    a multipole and of a dipole, on random pairs."""
    n, beta = 6, 0.45
    q, mu = rng.standard_normal(n), rng.standard_normal((n, 3)) * 0.3
    A = rng.standard_normal((n, 3, 3)) * 0.2
    th = 0.5 * (A + np.transpose(A, (0, 2, 1)))
    x = rng.standard_normal((n, 3)) * 2.0
    r = np.linalg.norm(x, axis=-1)
    lam = TA._thole_lambdas(T(r), T(np.full(n, 0.9)), T(np.full(n, 0.39)))
    with jax.enable_x64(True):
        e_j = float(jax.jit(JMP.self_energy, static_argnums=3)(*map(jnp.asarray, (q, mu, th)),
                                                              beta))
        pair_j = np.asarray(jax.jit(jax.vmap(JA.pair_permanent_energy))(
            *map(jnp.asarray, (x, q, mu, th, q[::-1], mu[::-1], th[::-1]))))
        lam_j = [jnp.asarray(v.numpy())[:, None] for v in lam]
        fp_j = np.asarray(JA.field_from_permanent(*map(jnp.asarray, (x, q, mu, th)), *lam_j))
        fd_j = np.asarray(JA.field_from_dipole(jnp.asarray(x), jnp.asarray(mu), *lam_j[:2]))
    assert float(TMP.self_energy(T(q), T(mu), T(th), beta)) == pytest.approx(e_j, rel=1e-12)
    pair_t = [float(TA.pair_permanent_energy(T(x[i]), T(q[i]), T(mu[i]), T(th[i]),
                                             T(q[::-1][i]), T(mu[::-1][i]), T(th[::-1][i])))
              for i in range(n)]
    np.testing.assert_allclose(pair_t, pair_j, rtol=1e-12)
    lam_t = [v[:, None] for v in lam]
    np.testing.assert_allclose(TA.field_from_permanent(T(x), T(q), T(mu), T(th), *lam_t).numpy(),
                               fp_j, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(TA.field_from_dipole(T(x), T(mu), *lam_t[:2]).numpy(), fd_j,
                               rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def water_box():
    """The 24-atom box (cutoff 3 A, beta 0.6, mesh spacing 0.7) as both
    packages' periodic systems with float64 tables, its list, a random
    dipole set, and JAX's evaluations of each piece (one jit each)."""
    cell, P, asg = _water_box(m=2, L=6.4, seed=3)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(P.shape)
    ts = TSystem.build(asg, cell, cutoff=3.0, beta=0.6, grid_spacing=0.7, device="cpu",
                       dtype=torch.float64, table_dtype=np.float64)
    with jax.enable_x64(True):
        js = JSystem.build(asg, cell, cutoff=3.0, beta=0.6, grid_spacing=0.7,
                           dtype=jnp.float64)
        Pj, vj = jnp.asarray(P), jnp.asarray(v)
        nl = js.neighbor_list(Pj, k_max=23)

        def functional(p, m):
            F, _, pcorr = js._induction_functional(p, nl)
            return jax.value_and_grad(F)(m), jax.value_and_grad(pcorr)(m)

        ref = dict(
            packed=jax.jit(lambda p: js._packed(p)[0])(Pj),
            permanent=jax.jit(jax.value_and_grad(lambda p: js.permanent_energy(p, nl)))(Pj),
            vdw=jax.jit(jax.value_and_grad(lambda p: js.vdw_energy(p, nl)))(Pj),
            mutual=jax.jit(lambda p, m: js._mutual_operator(p, nl)(m))(Pj, vj),
            sor=jax.jit(jax.value_and_grad(lambda p: js.polarization_energy(p, nl)))(Pj),
            functional=jax.jit(functional)(Pj, vj))
        ref = jax.tree.map(np.asarray, ref)
        nl_t = TNL.NeighborList(T(nl.idx).long(), T(nl.valid), T(P), torch.tensor(False))
    return ts, nl_t, T(P), T(v), ref


def _value_and_grad(fn, X):
    X = X.clone().requires_grad_(True)
    e = fn(X)
    (g,) = torch.autograd.grad(e, X)
    return float(e.detach()), g.numpy()


@pytest.mark.parametrize("term", ["permanent", "vdw", "sor"])
def test_periodic_energy_and_gradient_match_jax(water_box, term):
    """permanent_energy (erfc pairs, mesh, self, scaled-pair corrections),
    vdw_energy (buffered 14-7 over the list) and the SOR polarization energy
    (amoeba_induction="sor": real-space Thole fields, sor_iters sweeps, the
    gradient through them) with their gradients."""
    ts, nl, P, _, ref = water_box
    fn = {"permanent": ts.permanent_energy, "vdw": ts.vdw_energy,
          "sor": ts.polarization_energy}[term]
    e, g = _value_and_grad(lambda p: fn(p, nl), P)
    e_j, g_j = ref[term]
    assert e == pytest.approx(float(e_j), rel=E_REL)
    assert _rel(g_j, g) < F_REL


def test_packed_multipoles_and_the_list_match_jax(water_box):
    """_packed's [N,15] rows, and neighbor_list: JAX's pair set, row by row."""
    ts, nl, P, _, ref = water_box
    np.testing.assert_allclose(ts._packed(P)[0].numpy(), ref["packed"], rtol=0, atol=1e-14)
    rows = lambda lst: [set(i[v].tolist()) for i, v in zip(lst.idx.numpy(), lst.valid.numpy())]
    mine = ts.neighbor_list(P, k_max=23)
    assert not bool(mine.overflow) and rows(mine) == rows(nl)


def test_mutual_operator_matches_jax_on_a_random_vector(water_box):
    """The explicit operator (1/alpha, the damped Ewald dipole tensor, the
    mesh's dipole gradient gathered back through the stencils, the self
    term) applied to a random dipole set."""
    ts, nl, P, v, ref = water_box
    out = ts._mutual_operator(P, nl)(v[..., None])[..., 0]
    assert _rel(ref["mutual"], out.numpy()) < 1e-12


def test_induction_functional_and_its_gradient_match_jax(water_box):
    """F(m) and dF/dm (whose value at 0 is the solve's right-hand side
    -E_d), and the p-vs-d correction pcorr(m) with its gradient."""
    ts, nl, P, v, ref = water_box
    F, _, pcorr = ts._induction_functional(P, nl)
    (f_j, gf_j), (p_j, gp_j) = ref["functional"]
    f, gf = _value_and_grad(F, v)
    p, gp = _value_and_grad(pcorr, v)
    assert f == pytest.approx(float(f_j), rel=E_REL)
    assert _rel(gf_j, gf) < F_REL
    assert p == pytest.approx(float(p_j), rel=E_REL, abs=1e-15)
    np.testing.assert_allclose(gp, gp_j, rtol=0, atol=1e-15)


def test_variational_induction_matches_the_unrolled_solve(water_box):
    """In the port itself (tests/test_amoeba_variational.py's check of JAX):
    at a converged budget (25 iterations), the variational energy Phi
    (solve without a graph, Phi's position gradient through
    torch.utils.checkpoint) equals the unrolled PCG's F(m) + pcorr(m), and
    their position gradients agree; a warm start from the converged dipole
    pair reaches the same Phi in 5 iterations."""
    ts, nl, P, _, _ = water_box
    e_u, g_u = _value_and_grad(lambda p: ts.induced_dipoles_ewald(p, nl, cg_iters=25)[1], P)
    e_v, g_v = _value_and_grad(lambda p: ts.induction_variational(p, nl, cg_iters=25)[2], P)
    assert e_v == pytest.approx(e_u, rel=1e-10)
    assert _rel(g_u, g_v) < 5e-7
    md, mp, phi = ts.induction_variational(P, nl, cg_iters=25)
    md1, mp1, phi1 = ts.induction_variational(P, nl, cg_iters=5, m0_d=md, m0_p=mp)
    assert float(phi1) == pytest.approx(float(phi), rel=1e-10)
    np.testing.assert_allclose(md1.numpy(), md.numpy(), rtol=0, atol=1e-10)
