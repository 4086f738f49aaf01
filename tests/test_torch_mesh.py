"""The port's dp x mp mesh in a world of four gloo ranks on the CPU:
``ShardedPotential`` over 1 x 4 (bucket 0 padded with empty rows) and
``EnsembleSimulation`` over 2 x 2 against JAX's ``EnsembleSimulation`` and
the port's lone path; the CLI's mesh routes (``--mesh-dp``, ``--mesh-mp``,
``--restart``) against its one-rank run; and ``dryrun_multichip(4)``.
Chignolin at JAX's 2 layers x 16 (tests/test_parallel.py); the world's rank
program is torch_mesh_ranks.world_of_four.  Split from
tests/test_torch_parallel.py so that pytest-xdist's --dist loadfile runs the
two files side by side.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
import torch_mesh_ranks as MR
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import potentials as TP
from ai2bmd_torch.frag import runtime as TRT
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.parallel import replica_generators
from ai2bmd_torch.parallel.dryrun import dryrun_multichip
from ai2bmd_torch.parallel.launch import launch
from ai2bmd_tpu.frag.indexer import build_fragment_index as j_build_fragment_index
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.parallel import EnsembleSimulation as JEnsembleSimulation
from ai2bmd_tpu.parallel import make_mesh as j_make_mesh

CLI = ["--device", "cpu", "--model-preset", "tiny", "--timestep", "0.25", "--replicas", "4",
       "--record-per-steps", "1", "--preeq-steps", "0"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores (each rank takes one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def four():
    """The world of four ranks, started once: (protein, fragment index, the
    JAX weights in numpy, the port's, every rank's results)."""
    conftest.require_examples()
    prot, fi = MR.chig()
    jparams = jax.tree.map(np.asarray, JV.init_params(jax.random.PRNGKey(0),
                                                      JV.ViSNetConfig(**MR.TINY)))
    return prot, fi, jparams, params_from_jax(jparams), launch(MR.world_of_four, 4, "cpu",
                                                               args=(jparams,),
                                                               timeout_s=MR.WORLD_S)


@pytest.fixture(scope="module")
def jax_start(four):
    """JAX's EnsembleSimulation on a 2 x 2 mesh: the initial energy and
    forces of its cold start (one ShardedPotential evaluation at mp = 2)."""
    prot, _, jparams, _, _ = four
    ens = JEnsembleSimulation.build(prot, j_build_fragment_index(prot.atoms),
                                    jax.tree.map(jnp.asarray, jparams),
                                    JV.ViSNetConfig(**MR.TINY),
                                    j_make_mesh(2, 2, jax.devices()[:4]),
                                    n_replicas=MR.N_REPLICAS, opt_iters=MR.OPT_ITERS)
    state = ens.initial_state(prot.positions, seed=0)
    return np.asarray(state.energy), np.asarray(state.forces)


@pytest.fixture(scope="module")
def lone(four):
    prot, _, _, params, _ = four
    cfg = TV.ViSNetConfig(**MR.TINY)
    return TP.FragmentPotential.build(prot, TV.ViSNet(cfg, params), cfg,
                                      opt_iters=MR.OPT_ITERS, device="cpu")


def test_sharded_potential_1x4_matches_jax_and_the_lone_path(four, jax_start, lone):
    """ShardedPotential over 1 x 4 (Chignolin's buckets of 2 / 4 / 4 rows:
    bucket 0 padded with two empty rows): the cold (E, F) within 1e-4 eV and
    eV/A of JAX's sharded cold start and of the port's lone path, bitwise
    the same on the four ranks."""
    prot, _, _, _, outs = four
    je, jf = jax_start
    le, lf = lone.energy_forces(torch.as_tensor(prot.positions, dtype=torch.float32))
    assert outs[0]["layout"] == [(24, 0, 1), (32, 1, 1), (40, 2, 1)]
    for out in outs:
        for e, f in ((je[0], jf[0]), (float(le), lf.numpy())):
            np.testing.assert_allclose(float(out["sp_e"]), e, atol=1e-4)
            np.testing.assert_allclose(out["sp_f"], f, atol=1e-4)
        np.testing.assert_array_equal(out["sp_f"], outs[0]["sp_f"])


def test_ensemble_simulation_starts_as_jax_does(four, jax_start):
    """EnsembleSimulation's cold start over 2 x 2: every replica's E and F
    within 1e-4 of JAX's EnsembleSimulation.initial_state on the same mesh."""
    je, jf = jax_start
    out = four[4][0]
    np.testing.assert_allclose(out["initial_e"], je, atol=1e-4)
    np.testing.assert_allclose(out["initial_f"], jf, atol=1e-4)


def test_ensemble_simulation_replicas_follow_their_lone_runs(four, lone):
    """Each of the 4 replicas after 3 steps over 2 x 2 against its lone run
    on its own generator (replica_generators(seed)): the same cold start
    (2 L-BFGS iterations), then warm FragmentPotential steps; within 1e-5 A
    (only the order of the sums differs), and the replicas diverge."""
    prot, _, _, _, outs = four
    out = outs[0]
    assert out["step"] == MR.STEPS
    P = torch.as_tensor(prot.positions, dtype=torch.float32)
    m = torch.as_tensor(prot.masses, dtype=torch.float32)
    coeffs = TL.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device="cpu")
    e0, f0 = lone.energy_forces(P)
    d0 = TRT.initial_cap_delta(lone.rt, P, n_iter=MR.OPT_ITERS)
    for r, g in enumerate(replica_generators(MR.SEED, MR.N_REPLICAS, "cpu")):
        v = TL.maxwell_boltzmann_velocities(g, prot.masses, 300.0)
        state = TL.MDState(P, v, f0, e0, aux=d0)
        for _ in range(MR.STEPS):
            state = TL.langevin_step(lone.stateful_energy_forces, coeffs, m, state, generator=g)
        np.testing.assert_allclose(out["positions"][r], state.positions.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out["forces"][r], state.forces.numpy(), rtol=0, atol=1e-3)
    assert not np.allclose(out["positions"][0], out["positions"][1])


def test_ensemble_simulation_mp_copies_are_bitwise_equal(four):
    """After 3 steps both ranks of each mp row hold bitwise the same
    replicas (the all-reduce gives each the same sums, the long range is
    computed alike, the generators are the same), and rank 0's gather holds
    each dp block's."""
    outs = four[4]
    assert [o["dp"] for o in outs] == [0, 0, 1, 1]
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(outs[a]["local_positions"], outs[b]["local_positions"])
    np.testing.assert_array_equal(outs[0]["positions"][2:], outs[2]["local_positions"])


def _cli(tmp_path, name, *argv):
    return TCLI.main(["--prot-file", conftest.example_pdb("chig"), *CLI,
                      "--log-dir", str(tmp_path / name), *argv])


def _final(tmp_path, name):
    with np.load(tmp_path / name / "4x-ensemble-final.npz") as z:
        return z["positions"], z["velocities"]


def test_cli_mesh_routes_write_the_one_rank_files(tmp_path):
    """--device cpu --replicas 4: one rank (ReplicaEnsemble in process), 3
    steps; --mesh-dp 2 (ReplicaEnsemble over two gloo ranks) 2 steps, then
    --restart to 3: the same files, every replica bitwise the one-rank run's
    at step 3 (the restart resumes on the same mesh); --mesh-mp 2
    (EnsembleSimulation over 1 x 2): the same files, within 1e-4 A of the
    one-rank run (its cold start is JAX's EnsembleSimulation's, a warm
    evaluation short of ReplicaEnsemble's)."""
    conftest.require_examples()
    assert _cli(tmp_path, "one", "--sim-steps", "3") == 0
    assert _cli(tmp_path, "dp", "--sim-steps", "2", "--mesh-dp", "2") == 0
    with np.load(tmp_path / "dp" / "chig-4x-ensemble-restart.npz") as z:
        assert int(z["step"]) == 2 and z["rng_states"].shape[0] == 4
        assert z["positions"].shape == (4, 175, 3) and z["aux_0"].shape[0] == 4
    assert _cli(tmp_path, "dp", "--sim-steps", "3", "--mesh-dp", "2", "--restart") == 0
    assert _cli(tmp_path, "mp", "--sim-steps", "3", "--mesh-mp", "2") == 0

    names = lambda d: sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / d / "*"))
                             if not p.endswith(".log"))
    assert names("mp") == names("one")
    assert names("dp") == sorted(names("one") + [f"chig-r{r:03d}-traj-restart.dcd"
                                                 for r in range(4)])
    for r in range(4):
        assert TT.read_dcd(str(tmp_path / "mp" / f"chig-r{r:03d}-traj.dcd")).shape == (3, 175, 3)
        assert TT.read_dcd(str(tmp_path / "dp" / f"chig-r{r:03d}-traj-restart.dcd")).shape == (
            1, 175, 3)
    one, dp, mp = (_final(tmp_path, d) for d in ("one", "dp", "mp"))
    np.testing.assert_array_equal(dp[0], one[0])
    np.testing.assert_array_equal(dp[1], one[1])
    np.testing.assert_allclose(mp[0], one[0], rtol=0, atol=1e-4)
    assert not np.array_equal(mp[0][0], mp[0][1])
    logs = glob.glob(str(tmp_path / "mp" / "*.log"))
    assert len(logs) == 1 and "Step 3: Epot mean" in open(logs[0]).read()


def test_dryrun_multichip_on_four_ranks():
    """dryrun_multichip(4): one EnsembleSimulation step of polyalanine(6)
    over 2 x 2 (4 replicas), then the solvated box over 4 x 1 (one replica a
    rank): finite, and the replicas diverge."""
    out = dryrun_multichip(4, timeout_s=MR.WORLD_S)
    assert out["sharded"].shape == (4, 72, 3) and np.isfinite(out["sharded"]).all()
    assert out["solvated"].shape[0] == 4 and np.isfinite(out["solvated"]).all()
    assert not np.array_equal(out["sharded"][0], out["sharded"][1])
    assert not np.array_equal(out["solvated"][0], out["solvated"][1])
