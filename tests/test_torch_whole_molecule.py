"""Whole-molecule mode of the port (ai2bmd_torch.potentials.ViSNetPotential,
ProteinSimulation(mode="visnet"), ``python -m ai2bmd_torch --mode visnet``)
against the JAX package's, on the CPU.

Chignolin (175 atoms, one molecule of 176 slots) with a 3 x 32 ViSNet from
a synthetic Lightning checkpoint (tests/test_torch_checkpoint.py's write_ckpt)
loaded by each package: energy and forces, independence of the padding, a
few Langevin steps of ProteinSimulation fed JAX's noise; the CLI with a
converted checkpoint, then --restart; the --replicas route loading the
checkpoint; and the limits of the edge and full-layer kernels' shapes."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu import simulators as JSIM
from ai2bmd_tpu.md import langevin as JL
from ai2bmd_tpu.md import simulation as JS
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.potentials import ViSNetPotential as JVP
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import potentials as TP
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.models import checkpoint as TC
from ai2bmd_torch.models.params import flatten, init_params
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
from ai2bmd_torch.ops import vismp as TK
from test_torch_checkpoint import write_ckpt

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8, max_z=20)
TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)   # --model-preset tiny
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def chig():
    conftest.require_examples()
    from ai2bmd_torch.host import load_protein

    return load_protein(conftest.example_pdb("chig"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_ckpt(tmp_path_factory.mktemp("ckpt") / "visnet-uni-small.ckpt",
                      JV.ViSNetConfig(**SMALL))


@pytest.fixture(scope="module")
def potentials(chig, ckpt):
    """Both packages' ViSNetPotential on Chignolin, each from its own
    load_checkpoint of the same file, and JAX's E and F at the PDB positions."""
    jparams, jcfg = JSIM.load_model(ckpt)
    jpot = JVP.build(chig.numbers, jparams, jcfg)
    P = chig.positions.astype(np.float32)
    e_j, f_j = jax.jit(jpot.energy_forces)(jnp.asarray(P))
    tparams, tcfg = TSIM.load_model(ckpt)
    tpot = TP.ViSNetPotential.build(chig.numbers, ViSNet(tcfg, tparams), tcfg, device="cpu")
    return jpot, tpot, P, np.asarray(e_j), np.asarray(f_j)


def test_energy_and_forces_match_jax(potentials):
    """E and F of the whole molecule (A = 176) from the checkpoint's weights.
    Tolerance 1e-4 eV and eV/A: float32 sums over 176 sources in another
    order."""
    jpot, tpot, P, e_j, f_j = potentials
    assert tpot.pad_to == jpot.pad_to == 176
    assert tpot.z.shape == (1, 176) and int(tpot.mask.sum()) == 175
    e_t, f_t = tpot.energy_forces(T(P))
    assert e_t.shape == () and f_t.shape == (175, 3)
    assert float(np.abs(f_j).max()) > 1e-3      # the forces are not trivially zero
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pad_multiple, pad_to", [(16, 176), (64, 192)])
def test_energy_and_forces_do_not_depend_on_the_padding(potentials, chig, pad_multiple,
                                                        pad_to):
    """Padded slots are masked out wherever they are parked: 8 against 16
    (the same 176 slots) and 64 (192).  Tolerance 1e-5 (float32 sums over
    more masked zeros)."""
    _, tpot, P, _, _ = potentials
    other = TP.ViSNetPotential.build(chig.numbers, tpot.module, tpot.cfg,
                                     pad_multiple=pad_multiple, device="cpu")
    assert other.pad_to == pad_to
    e8, f8 = tpot.energy_forces(T(P))
    e, f = other.energy_forces(T(P))
    np.testing.assert_allclose(float(e), float(e8), rtol=0, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), f8.numpy(), rtol=0, atol=1e-5)


def _jax_noise(key, shape):
    """(xi, eta) that JAX's langevin_step draws from ``key``."""
    _, k1, k2 = jax.random.split(key, 3)
    return (jax.random.normal(k1, shape, jnp.float32), jax.random.normal(k2, shape, jnp.float32))


def test_protein_simulation_visnet_mode_matches_jax(ckpt, tmp_path):
    """ProteinSimulation.from_pdb(mode="visnet", ckpt_path=...) in both
    packages: a stateless potential (no caps), then three Langevin steps of
    the Simulator's stepped potential against JAX's ``Simulator._chunk``,
    the port fed JAX's noise from JAX's velocities.  Tolerances: positions
    1e-5 A, forces 1e-4 eV/A, energy 1e-4 eV."""
    conftest.require_examples()
    pdb = conftest.example_pdb("chig")
    cfg = dict(preeq_steps=0, record_per_steps=3)
    jps = JSIM.ProteinSimulation.from_pdb(pdb, log_dir=str(tmp_path / "j"), mode="visnet",
                                          ckpt_path=ckpt, sim_cfg=JS.SimulationConfig(**cfg))
    tps = TSIM.ProteinSimulation.from_pdb(pdb, log_dir=str(tmp_path / "t"), mode="visnet",
                                          ckpt_path=ckpt, sim_cfg=TS.SimulationConfig(**cfg),
                                          device="cpu")
    assert isinstance(tps.potential, TP.ViSNetPotential) and tps.sim._init_aux is None
    assert tps.potential.cfg.num_layers == 3 and tps.potential.pad_to == 176
    P = jps.prot.positions.astype(np.float32)
    key = jax.random.PRNGKey(1)
    vel = JL.maxwell_boltzmann_velocities(key, jps.prot.masses, 300.0)
    e0, f0 = jps.potential.energy_forces(jnp.asarray(P))
    sj = JL.MDState(jnp.asarray(P), vel, f0, e0, key, jnp.asarray(0, jnp.int32), aux=())
    sj_end = jps.sim._chunk(sj, jnp.asarray(P), jnp.asarray(0.0, jnp.float32), 3)

    st = tps.sim.initial_state(P)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(f0), rtol=0, atol=1e-4)
    assert st.aux is None
    st = TL.MDState(T(P), T(vel), st.forces, st.energy)
    for _ in range(3):
        xi, eta = _jax_noise(key, P.shape)
        key = jax.random.split(key, 3)[0]
        st = TL.langevin_step(tps.sim.full_potential, tps.sim.coeffs, tps.sim.masses, st,
                              xi=T(xi), eta=T(eta))
    assert st.step == 3 and st.aux is None
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj_end.positions), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj_end.forces), rtol=0, atol=1e-4)
    assert float(st.energy) == pytest.approx(float(sj_end.energy), abs=1e-4)


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "ai2bmd_torch", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    """Random tiny weights (seed 7) as a converted checkpoint."""
    cfg = ViSNetConfig(**TINY)
    path = str(tmp_path_factory.mktemp("npz") / "visnet-tiny.npz")
    TC.save_converted(path, init_params(cfg, torch.Generator().manual_seed(7)), cfg)
    return path


def test_cli_visnet_mode_with_a_converted_checkpoint_then_restart(tmp_path, chig, tiny_npz):
    """python -m ai2bmd_torch --mode visnet --ckpt-path <npz>: the ladder (1
    step a stage), 4 recorded steps, the restart file's forces equal to the
    checkpoint's ViSNetPotential at its positions (1e-4 eV/A); then --restart
    for 2 more steps into -restart trajectories, the metrics continued."""
    args = ["--prot-file", conftest.example_pdb("chig"), "--log-dir", str(tmp_path),
            "--device", "cpu", "--model-preset", "tiny", "--timestep", "0.25",
            "--mode", "visnet", "--ckpt-path", tiny_npz]
    run = _cli(*args, "--preeq-steps", "1", "--sim-steps", "4", "--record-per-steps", "2")
    assert run.returncode == 0, run.stderr[-4000:]
    assert "Pre-equilibration finished!" in run.stdout and "Simulation finished!" in run.stdout
    frames = TT.read_dcd(str(tmp_path / "chig-traj.dcd"))
    assert frames.shape == (2, 175, 3) and np.isfinite(frames).all()
    params, cfg = TC.load_converted(tiny_npz)
    pot = TP.ViSNetPotential.build(chig.numbers, ViSNet(cfg, params), cfg, device="cpu")
    with np.load(tmp_path / "chig-restart.npz") as r:
        assert int(r["step"]) == 9 and "aux_0" not in r.files
        _, f = pot.energy_forces(T(r["positions"]))
        np.testing.assert_allclose(f.numpy(), r["forces"], rtol=0, atol=1e-4)

    again = _cli(*args, "--sim-steps", "2", "--record-per-steps", "2", "--restart")
    assert again.returncode == 0, again.stderr[-4000:]
    assert "Re-start simulation for 2 steps" in again.stdout
    assert TT.read_dcd(str(tmp_path / "chig-traj-restart.dcd")).shape == (1, 175, 3)
    rows = (tmp_path / "chig-metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["step", "7", "9", "11"]


def test_cli_replica_ensemble_loads_the_checkpoint(monkeypatch, tmp_path, tiny_npz):
    """--replicas with --ckpt-path: the ensemble is built from the
    checkpoint's weights and config (fragment mode, as in the JAX package)."""
    from ai2bmd_torch import parallel

    seen = {}
    build = parallel.ReplicaEnsemble.build

    def spy(prot, fi, params, cfg, **kw):
        seen.update(params=params, cfg=cfg)
        return build(prot, fi, params, cfg, **kw)

    monkeypatch.setattr(parallel.ReplicaEnsemble, "build", spy)
    rc = TCLI.main(["--prot-file", conftest.example_pdb("chig"), "--device", "cpu",
                    "--timestep", "0.25", "--replicas", "2", "--sim-steps", "2",
                    "--record-per-steps", "2", "--log-dir", str(tmp_path), "--ckpt-path",
                    tiny_npz])
    assert rc == 0
    params, cfg = TC.load_converted(tiny_npz)
    assert seen["cfg"] == cfg
    got, ref = dict(flatten(seen["params"])), dict(flatten(params))
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
    assert TT.read_dcd(str(tmp_path / "chig-r001-traj.dcd")).shape == (1, 175, 3)


def test_full_layer_kernels_refuse_a_whole_molecule():
    """The edge kernels and the full-layer kernels K5/K6 both take any
    A % 8 == 0, with no cap on the slots (abd is 752 slots, a 110-residue
    polyalanine 1,112; the JAX package's dense kernels need only A % 8 ==
    0), at every width of their domain (heads of 64 channels, H = 512);
    their wrappers' checks refuse only a slot count that is not a multiple
    of 8."""
    assert not hasattr(TK, "EDGE_MAXA")
    for A in (752, 1112, 4096):
        for check in (TK.check_shapes, TK.check_layer_shapes):
            check(A, 256, 8, 8)
            check(A, 512, 8, 8)
    TK.check_layer_shapes(176, 256, 8, 4)
    for check in (TK.check_shapes, TK.check_layer_shapes):
        with pytest.raises(ValueError, match="A a multiple of 8; got A=1108"):
            check(1108, 256, 8, 8)


def test_whole_molecule_entry_points_default_to_the_card(monkeypatch, chig, tiny_npz, tmp_path):
    """Given no device, ViSNetPotential.build and ProteinSimulation.from_pdb
    in whole-molecule mode take the card, and without one raise the
    require_cuda error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, cfg = TC.load_converted(tiny_npz)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.ViSNetPotential.build(chig.numbers, ViSNet(cfg, params), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSIM.ProteinSimulation.from_pdb(conftest.example_pdb("chig"), log_dir=str(tmp_path),
                                        mode="visnet", ckpt_path=tiny_npz)
