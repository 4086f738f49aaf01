"""The port's smooth PME (ai2bmd_torch.physics.pme) on the CPU: the five
checks of tests/test_pme.py (mesh against a direct Ewald sum, the NaCl
Madelung constant, translation invariance and finite-difference forces,
exclusions, a charged system's background), and the port against the JAX
package (ai2bmd_tpu.physics.pme) on a random charged box with the same numpy
inputs; `python -m ai2bmd_torch --fragment-longrange-calc pme` end to end.
FragmentPotential(longrange="pme") on Chignolin against JAX:
tests/test_torch_slice.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu.io.pdb import PDBAtoms as JAtoms
from ai2bmd_tpu.physics import pme as JPME
from ai2bmd_tpu.system import Protein as JProtein
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import units
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.physics import pme as PME
from ai2bmd_torch.system import Protein

NO_EXCL = np.zeros((0, 2), np.int32)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(q, pos, cell, sigma=None, eps=None, atoms_cls=PDBAtoms, prot_cls=Protein):
    n = len(q)
    atoms = atoms_cls(positions=np.asarray(pos, float), numbers=np.full(n, 18, np.int32),
                      atom_names=np.array(["X"] * n), residue_names=np.array(["TOY"] * n),
                      residue_numbers=np.ones(n, np.int32), cell=np.asarray(cell, float))
    zeros = np.zeros(n)
    return prot_cls(atoms=atoms, charges=np.asarray(q, float),
                    sigmas=zeros if sigma is None else sigma,
                    epsilons=zeros if eps is None else eps)


def _random_neutral_system(rng, n=16, L=12.0):
    q = rng.random(n) - 0.5
    q -= q.mean()
    return q, rng.random((n, 3)) * L, np.array([L, L, L])


def _pme(prot, excl=NO_EXCL, **kw):
    return PME.PMEParams.build(prot, excl, device="cpu", **kw)


def _energy(pme, pos):
    return float(PME.pme_energy(pme, torch.as_tensor(pos, dtype=torch.float32)))


def test_mesh_matches_direct_ewald(rng):
    q, pos, cell = _random_neutral_system(rng)
    pme = _pme(_toy(q, pos, cell), beta=0.35, cutoff=5.9, grid_spacing=0.5)
    e_exact = PME.ewald_direct_sum(q, pos, cell, 0.35, kmax=10) * units.COULOMB
    e_mesh = _energy(pme, pos)
    assert abs(e_mesh - e_exact) < 2e-3 * max(1.0, abs(e_exact)), (e_mesh, e_exact)


def test_madelung_nacl():
    """Rock salt: E per ion pair = -M k_e / a with M = 1.7475646."""
    a, n_side = 2.82, 2
    idx = np.arange(2 * n_side)
    X, Y, Z = np.meshgrid(idx, idx, idx, indexing="ij")
    pos = np.stack([X, Y, Z], -1).reshape(-1, 3) * a
    q = ((X + Y + Z) % 2 * 2 - 1).reshape(-1).astype(float)
    pme = _pme(_toy(q, pos, [2 * n_side * a] * 3), beta=0.45, cutoff=5.5, grid_spacing=0.35)
    madelung = -_energy(pme, pos) / (len(q) // 2) / units.COULOMB * a
    assert abs(madelung - 1.7475646) < 5e-3, madelung


def test_translation_invariance_and_forces(rng):
    q, pos, cell = _random_neutral_system(rng)
    pme = _pme(_toy(q, pos, cell), beta=0.35, cutoff=5.9, grid_spacing=0.5)
    P0 = torch.as_tensor(pos, dtype=torch.float32)
    e0, F0 = PME.pme_energy_forces(pme, P0)
    e1, F1 = PME.pme_energy_forces(pme, P0 + torch.tensor([1.234, -0.567, 3.1]))
    assert abs(float(e0 - e1)) < 5e-3
    np.testing.assert_allclose(F0.numpy(), F1.numpy(), atol=2e-2)
    assert float(F0.sum(0).abs().max()) < 1e-2
    h = 1e-2
    for a_i, c in [(0, 0), (7, 2)]:
        dp = torch.zeros_like(P0)
        dp[a_i, c] = h
        fd = -(float(PME.pme_energy(pme, P0 + dp)) - float(PME.pme_energy(pme, P0 - dp))) / (2 * h)
        assert abs(fd - float(F0[a_i, c])) < 3e-2 * max(1.0, abs(fd))


def test_exclusions_remove_pair_interaction():
    """An excluded pair loses its whole Coulomb interaction; what is left is
    the periodic images' dipole energy (small for L >> d)."""
    L = 20.0
    pos = np.array([[5.0, 5.0, 5.0], [7.0, 5.0, 5.0]])
    q = np.array([0.5, -0.5])
    prot = _toy(q, pos, [L, L, L])
    e_ex = _energy(_pme(prot, np.array([[0, 1]], np.int32), beta=0.35, cutoff=8.0,
                        grid_spacing=0.5), pos)
    assert abs(e_ex) < 0.02, e_ex
    e_in = _energy(_pme(prot, beta=0.35, cutoff=8.0, grid_spacing=0.5), pos)
    direct = units.COULOMB * q[0] * q[1] / 2.0
    assert abs(e_in - e_ex - direct) < 5e-3, (e_in, e_ex, direct)


def test_charged_system_background():
    """A net-charged system gets the uniform neutralizing background term."""
    q = np.array([1.0, 1.0])
    pos = np.array([[3.0, 3.0, 3.0], [9.0, 9.0, 9.0]])
    cell = np.array([12.0, 12.0, 12.0])
    e_mesh = _energy(_pme(_toy(q, pos, cell), beta=0.4, cutoff=5.9, grid_spacing=0.4), pos)
    e_exact = PME.ewald_direct_sum(q, pos, cell, 0.4, kmax=10) * units.COULOMB
    assert abs(e_mesh - e_exact) < 5e-3 * abs(e_exact), (e_mesh, e_exact)


def test_pme_matches_jax_on_a_random_charged_box(rng):
    """48 atoms of net charge +1 with LJ parameters and a few excluded pairs
    in a 14 A box, float32: energy and forces against the JAX package's
    pme_energy_forces within 1e-5 of their scale, the mesh charge density
    within 1e-6."""
    n, L = 48, 14.0
    q = rng.normal(size=n) * 0.5
    q += (1.0 - q.sum()) / n
    pos = rng.random((n, 3)) * L
    sig, eps = rng.uniform(1.5, 3.5, n), rng.uniform(0.01, 0.2, n)
    excl = np.array([[0, 1], [2, 5], [7, 30], [11, 12]], np.int32)
    kw = dict(beta=0.35, cutoff=6.0, grid_spacing=0.7)
    tp = _pme(_toy(q, pos, [L] * 3, sig, eps), excl, **kw)
    jp = JPME.PMEParams.build(_toy(q, pos, [L] * 3, sig, eps, JAtoms, JProtein), excl, **kw)
    assert tp.grid == jp.grid
    P = pos.astype(np.float32)
    e_j, f_j = jax.jit(lambda p: JPME.pme_energy_forces(jp, p))(jnp.asarray(P))
    e_t, f_t = PME.pme_energy_forces(tp, torch.as_tensor(P))
    f_j = np.asarray(f_j)
    assert float(e_t) == pytest.approx(float(e_j), rel=1e-5)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-5 * np.abs(f_j).max())
    rho_t = PME.spread(tp.charge, torch.as_tensor(P), tp.cell, tp.grid)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(JPME._spread_charges(jp, jnp.asarray(P))),
                               rtol=0, atol=1e-6)


def test_cli_runs_pme_in_fragment_mode(tmp_path, capsys):
    """--fragment-longrange-calc pme (refused until ROADMAP item 12 was
    ported; the case argv1-12 of test_torch_cli.py's refused routes) runs
    fragment mode with PME over Chignolin's CRYST1 cell: exit 0, a finite
    frame of the 175 atoms."""
    conftest.require_examples()
    assert TCLI.main(["--prot-file", conftest.example_pdb("chig"), "--device", "cpu",
                      "--model-preset", "tiny", "--timestep", "0.25", "--log-dir",
                      str(tmp_path), "--fragment-longrange-calc", "pme", "--preeq-steps", "0",
                      "--sim-steps", "1", "--record-per-steps", "1"]) == 0
    frames = TT.read_dcd(str(tmp_path / "chig-traj.dcd"))
    assert frames.shape == (1, 175, 3) and np.isfinite(frames).all()
    assert "Simulation finished!" in capsys.readouterr().out
