"""Port parity of the replica ensemble (ai2bmd_torch vs ai2bmd_tpu) on
Chignolin, small ViSNet (3 layers x 32, 4 heads), float32, CPU.

The replica-batched warm potential, its per-replica cap L-BFGS and the
batched Langevin step are held against the JAX package's functions on the
same numpy inputs (JAX on its jnp path, as its own tests run it).  The
ensemble against lone replicas of the port with the same generators, and
its refusals: tests/test_torch_ensemble_lone.py (a file of its own, so that
pytest-xdist's --dist loadfile runs it beside this one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.frag import hydrogen as JH
from ai2bmd_tpu.frag import runtime as JR
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.physics import nonbonded as JN
from ai2bmd_torch.frag import hydrogen as TH
from ai2bmd_torch.frag import runtime as TR
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.physics import nonbonded as TN

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8, max_z=20)
RL = 3
T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ens(chig_protein):
    """Both packages' runtimes and weights, and RL replica geometries (the
    protein plus 0.005 A of noise each, from a seed).  At 0.02 A the cold
    (10-iteration) cap iterates of the port's lone solve already differ from
    JAX's by 4.6e-5 A, float32 rounding grown over the iterations, in the
    batched and the lone solve alike (ROADMAP.md, Queue 3)."""
    from ai2bmd_tpu.frag.indexer import build_fragment_index

    fi = build_fragment_index(chig_protein.atoms)
    jcfg = JV.ViSNetConfig(**SMALL)
    jparams = JV.init_params(jax.random.PRNGKey(0), jcfg)
    P = np.asarray(chig_protein.positions, np.float32)
    Ps = (P[None] + 0.005 * np.random.default_rng(5).standard_normal((RL,) + P.shape)
          ).astype(np.float32)
    return dict(fi=fi, jrt=JR.FragmentRuntime.build(fi), jcfg=jcfg, jparams=jparams,
                trt=TR.FragmentRuntime.build(fi, device="cpu"), tcfg=TV.ViSNetConfig(**SMALL),
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams)), Ps=Ps)


@pytest.fixture(scope="module")
def cold_deltas(ens):
    """JAX's cold cap offsets of the RL replicas (10 iterations each)."""
    return np.asarray(jax.jit(lambda Ps: JR.initial_cap_delta_batched(ens["jrt"], Ps, 10))(
        jnp.asarray(ens["Ps"])))


def test_initial_cap_delta_batched_matches_jax(ens, cold_deltas):
    """Cold offsets per replica.  Tolerance 1e-5 A, as
    test_optimize_caps_iterates_match_jax (float32 iterates)."""
    got = TR.initial_cap_delta_batched(ens["trt"], T(ens["Ps"]), n_iter=10)
    assert got.shape == cold_deltas.shape
    np.testing.assert_allclose(got.numpy(), cold_deltas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_iter", [1, 10], ids=["warm1", "cold10"])
def test_batched_lbfgs_iterates_match_jax(ens, n_iter):
    """optimize_caps over [Rl,R,S,3] keeps one solve per replica: against
    jax.vmap of the JAX joint solve, tolerance 1e-5 A, and each replica
    against the port's lone solve of its rows (the same recursion; inner
    products summed in another order)."""
    jrt, trt = ens["jrt"], ens["trt"]
    pos = np.asarray(jax.vmap(lambda P: JR.build_row_positions(jrt, P))(jnp.asarray(ens["Ps"])))
    ref = np.asarray(jax.vmap(lambda p: JH.optimize_caps(jrt.ht, p, n_iter=n_iter))(
        jnp.asarray(pos)))
    got = TH.optimize_caps(trt.ht, T(pos), n_iter=n_iter)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    for r in range(RL):
        lone = TH.optimize_caps(trt.ht, T(pos[r]), n_iter=n_iter)
        np.testing.assert_allclose(got[r].numpy(), lone.numpy(), rtol=0, atol=1e-6)
    assert np.abs(got.numpy() - pos).max() > 1e-3        # the caps really moved


@pytest.mark.parametrize("remat", [False, True], ids=["stash", "remat"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_ensemble_energy_forces_match_jax(ens, cold_deltas, remat, chunk):
    """ensemble_fragment_energy_forces_warm for RL replicas with their cold
    offsets, in chunks of 1 and 3, with remat off and on, against the JAX
    function with the same settings.  Tolerances as
    test_stateful_energy_forces_match_jax: E and F 1e-4, offsets 1e-5 A."""
    jcfg = dataclasses.replace(ens["jcfg"], remat=remat)
    tcfg = dataclasses.replace(ens["tcfg"], remat=remat)
    e_j, f_j, d_j = jax.jit(lambda Ps, d: JR.ensemble_fragment_energy_forces_warm(
        ens["jparams"], ens["jrt"], Ps, jcfg, d, warm_iters=1, replica_chunk=chunk))(
        jnp.asarray(ens["Ps"]), jnp.asarray(cold_deltas))
    e_t, f_t, d_t = TR.ensemble_fragment_energy_forces_warm(
        ens["tparams"], ens["trt"], T(ens["Ps"]), tcfg, T(cold_deltas), warm_iters=1,
        replica_chunk=chunk)
    assert e_t.shape == (RL,) and f_t.shape == (RL, ens["fi"].n_atoms, 3)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-5)


def test_langevin_step_batched_matches_jax_with_its_noise(ens, chig_protein):
    """Two batched Langevin steps (1 fs, 300 K, 0.001/fs) of RL replicas under
    the batched "mm" long-range term.  The port takes the xi/eta that
    ai2bmd_tpu/md/langevin.py:156-160 draws, reproduced with the same key
    splits.  Tolerances: positions and velocities 1e-5, forces and E 2e-4."""
    masses = chig_protein.masses
    jnb = JN.NonbondedParams.build(chig_protein, ens["fi"].exclusion_mask())
    tnb = TN.NonbondedParams.build(chig_protein, ens["fi"].exclusion_mask(), device="cpu")

    def jpot(Ps, aux):
        e, g = jax.vmap(jax.value_and_grad(lambda p: JN.nonbonded_energy(jnb, p)))(Ps)
        return e, -g, aux

    Ps = jnp.asarray(ens["Ps"])
    keys = jax.random.split(jax.random.PRNGKey(3), RL)
    vel = jax.vmap(lambda k: JL.maxwell_boltzmann_velocities(k, masses, 300.0))(keys)
    e0, f0, _ = jpot(Ps, None)
    sj = JL.MDState(Ps, vel, f0, e0, keys, jnp.zeros((RL,), jnp.int32), aux=None)
    st = TL.MDState(T(Ps), T(vel), T(f0), T(e0))
    cj = JL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001)
    ct = TL.LangevinCoeffs.build(masses, 1.0, 300.0, 0.001, device="cpu")
    m = torch.as_tensor(masses, dtype=torch.float32)
    step = jax.jit(lambda s: JL.langevin_step_batched(jpot, cj, masses, s))
    shape = Ps.shape[1:]
    for _ in range(2):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(sj.key)
        xi = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(ks[:, 1])
        eta = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(ks[:, 2])
        sj = step(sj)
        st = TL.langevin_step_batched(lambda x, aux: (*TN.nonbonded_energy_forces(tnb, x), aux),
                                      ct, m, st, xi=T(xi), eta=T(eta))
    assert st.step == 2 and st.energy.shape == (RL,)
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.velocities.numpy(), np.asarray(sj.velocities), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj.forces), rtol=0, atol=2e-4)
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(sj.energy), rtol=0, atol=2e-4)
    with pytest.raises(ValueError, match="generators"):
        TL.langevin_step_batched(lambda x, aux: None, ct, m, st, generators=[None])
