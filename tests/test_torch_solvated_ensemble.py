"""Solvated replica ensembles in the port (ai2bmd_torch.parallel.
SolvatedReplicaEnsemble, the CLI's --replicas route on a solvated input and
its --solvent route on a bare PDB) against the JAX package on the CPU.

The box is the JAX suite's solvate(build_polyalanine(2), padding=4.0,
seed=0) (251 atoms; tests/test_parallel.py's solvated ensemble runs on it),
the model the CLI's tiny preset (2 layers x 32, 4 heads) with JAX's weights.
On this box QMMMPotential's "auto" route takes the dense pairs (too small
for 3 cells an axis), as JAX's ensemble does by its hard-coded "dense": the
parity test compares dense with dense."""

import os

import jax
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu import preprocess as JP
from ai2bmd_tpu.io import build as JB
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.parallel import SolvatedReplicaEnsemble as JEnsemble
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import preprocess as TP
from ai2bmd_torch.io import build as TB
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.io.pdb import read_pdb, write_pdb
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.parallel import SolvatedReplicaEnsemble, replica_generators
from ai2bmd_torch.physics.qmmm import QMMMPotential
from ai2bmd_torch.potentials import FragmentPotential
from ai2bmd_torch.system import Protein

TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)   # --model-preset tiny
CLI_TINY = ["--device", "cpu", "--model-preset", "tiny", "--timestep", "0.25"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def box():
    jbox = JP.solvate(JB.build_polyalanine(2), padding=4.0, seed=0)
    tbox = TP.solvate(TB.build_polyalanine(2), padding=4.0, seed=0)
    jparams = JV.init_params(jax.random.PRNGKey(0), JV.ViSNetConfig(**TINY))
    return jbox, tbox, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def ensemble(box):
    """The port's ensemble of 2 replicas and its initial state (seed 1)."""
    _, tbox, _, tparams = box
    ens = SolvatedReplicaEnsemble.build(tbox, tparams, TV.ViSNetConfig(**TINY), n_replicas=2,
                                        steps_per_call=2, device="cpu")
    return ens, ens.initial_state(tbox.positions, seed=1)


def test_initial_state_matches_jax(box, ensemble):
    """initial_state of R = 2: one evaluation (cold caps, the QM/MM forces)
    broadcast to every replica, against JAX's SolvatedReplicaEnsemble, both
    in float32, the pair route the dense one on both sides.  Solvent atoms'
    forces within 1e-4 eV/A of JAX's.  Protein atoms and E carry the float32
    spread of the subtractive combiner that both packages share (ROADMAP.md
    Queue 3 entry 4: the excluded pairs' LJ, ~3e4 eV on this box, is added
    in the dense pair sum and taken out again): each package's within 2e-2
    eV/A and 1e-2 eV of the port's own float64 evaluation from the same cold
    caps (JAX's float32 parts from it by 9.4e-3 eV/A and 5.1e-3 eV here, the
    port's by 3.4e-3 and 7.2e-4)."""
    jbox, tbox, jparams, tparams = box
    ens, state = ensemble
    assert ens.qmmm.backend == "dense"
    jens = JEnsemble.build(jbox, jparams, JV.ViSNetConfig(**TINY), n_replicas=2)
    js = jens.initial_state(jbox.positions, seed=1)
    assert state.positions.shape == (2, len(tbox), 3) and state.energy.shape == (2,)
    assert torch.equal(state.forces[0], state.forces[1])
    assert not torch.equal(state.velocities[0], state.velocities[1])
    solvent = np.ones(len(tbox), bool)
    solvent[ens.qm_idx] = False
    f_j, f_t = np.asarray(js.forces), state.forces.numpy()
    np.testing.assert_allclose(f_t[:, solvent], f_j[:, solvent], rtol=0, atol=1e-4)

    full = Protein.from_atoms(tbox)
    cfg = TV.ViSNetConfig(**TINY)
    pot64 = FragmentPotential.build(full.select(ens.qm_idx),
                                    TV.ViSNet(cfg, tparams).to(torch.float64), cfg, device="cpu")
    q64 = QMMMPotential.build(tbox, qm_stateful=lambda Pq, a: pot64.stateful_energy_forces(
        Pq, a, warm_iters=1), qm_init_aux=ens.qmmm.qm_init_aux.double(), device="cpu",
        dtype=torch.float64)
    P64 = state.positions[0].double()
    e64, f64, _ = q64(P64, q64.init_aux(P64))
    for e, f in ((np.asarray(js.energy), f_j), (state.energy.numpy(), f_t)):
        assert np.abs(e - float(e64)).max() <= 1e-2
        assert np.abs(f[:, ~solvent] - f64[~solvent].numpy()).max() <= 2e-2


def test_each_replica_is_a_lone_run_on_its_own_generator(box, ensemble):
    """After 2 calls of 2 steps, each replica equals, bit for bit, 4 lone
    langevin_step calls of the ensemble's QM/MM potential from its start,
    drawing from a fresh replica_generators(1)[r] past its velocity draw;
    the replicas diverge; the caller's state is left as it was."""
    _, tbox, _, _ = box
    ens, state = ensemble
    before = state.positions.clone()
    out = ens.run(state, 2)
    assert out.step == 4 and torch.equal(state.positions, before)
    for r, g in enumerate(replica_generators(1, 2, "cpu")):
        TL.maxwell_boltzmann_velocities(g, tbox.masses, 300.0)
        lone = ens.replica(state, r)
        for _ in range(4):
            lone = TL.langevin_step(ens.qmmm, ens.coeffs, ens.masses, lone, generator=g)
        assert torch.equal(out.positions[r], lone.positions)
        assert torch.equal(out.velocities[r], lone.velocities)
        assert torch.equal(out.forces[r], lone.forces)
        assert torch.equal(out.aux[1][r], lone.aux[1])
    assert (out.positions[0] - out.positions[1]).abs().max() > 1e-5


def test_refuses_a_box_without_solvent_and_a_mesh(box):
    _, _, _, tparams = box
    cfg = TV.ViSNetConfig(**TINY)
    with pytest.raises(ValueError, match="no solvent"):
        SolvatedReplicaEnsemble.build(TB.build_polyalanine(2), tparams, cfg, n_replicas=2,
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        SolvatedReplicaEnsemble.build(box[1], tparams, cfg, n_replicas=2, mesh=object(),
                                      device="cpu")


def _main(*argv):
    return TCLI.main([*CLI_TINY, *argv])


def test_cli_solvated_replicas_and_their_restart(box, tmp_path):
    """--replicas 2 on the solvated box, in process (the port's twin of
    tests/test_cli.py:91-147, which JAX marks slow for its 8-device mesh):
    its QM/MM line, a DCD a replica, the checkpoint with both
    generators and every carry leaf; 4 steps then --restart to 6 equal 6
    straight steps bit for bit on the CPU."""
    pdb = str(tmp_path / "ala2-box.pdb")
    write_pdb(pdb, box[1])
    common = ["--prot-file", pdb, "--replicas", "2", "--record-per-steps", "2"]
    assert _main(*common, "--sim-steps", "6", "--log-dir", str(tmp_path / "a")) == 0
    assert _main(*common, "--sim-steps", "4", "--log-dir", str(tmp_path / "b")) == 0
    b = tmp_path / "b"
    for r in range(2):
        assert TT.read_dcd(str(b / f"ala2-box-r{r:03d}-traj.dcd")).shape == (2, 251, 3)
    with np.load(b / "ala2-box-2x-ensemble-restart.npz") as z:
        assert int(z["step"]) == 4 and z["rng_states"].shape[0] == 2
        assert z["positions"].shape == (2, 251, 3) and z["aux_0"].shape[0] == 2
    assert _main(*common, "--sim-steps", "6", "--log-dir", str(b), "--restart") == 0
    assert TT.read_dcd(str(b / "ala2-box-r001-traj-restart.dcd")).shape == (1, 251, 3)
    log = next(f for f in os.listdir(b) if f.startswith("ala2-box-") and f.endswith(".log"))
    assert "QM/MM: 251 atoms in the box, 32 in the QM region; dense pairs" in (b / log).read_text()
    with np.load(tmp_path / "a" / "2x-ensemble-final.npz") as fa, \
            np.load(b / "2x-ensemble-final.npz") as fb:
        np.testing.assert_array_equal(fa["positions"], fb["positions"])
        np.testing.assert_array_equal(fa["velocities"], fb["velocities"])
        assert not np.array_equal(fa["positions"][0], fa["positions"][1])


def test_cli_solvent_on_a_bare_pdb_finds_the_preprocessed_box(box, tmp_path):
    """--solvent on a bare ala2 PDB whose -preeq outputs exist in --log-dir:
    the preprocessing route finds them (its skip line) and the run goes on
    into solvated production on that box (its QM/MM line, a DCD of the whole
    box)."""
    pdb = str(tmp_path / "ala2.pdb")
    write_pdb(pdb, TB.build_polyalanine(2))
    log_dir = tmp_path / "run"
    log_dir.mkdir()
    write_pdb(str(log_dir / "ala2-preeq.pdb"), box[1])
    write_pdb(str(log_dir / "ala2-preeq-nowat.pdb"), read_pdb(pdb))
    assert _main("--prot-file", pdb, "--solvent", "--log-dir", str(log_dir), "--preeq-steps",
                 "0", "--sim-steps", "2", "--record-per-steps", "1") == 0
    text = "".join((log_dir / f).read_text() for f in os.listdir(log_dir) if f.endswith(".log"))
    assert f"preprocessing outputs exist, skipping ({log_dir / 'ala2-preeq.pdb'})" in text
    assert "QM/MM: 251 atoms in the box, 32 in the QM region" in text
    assert TT.read_dcd(str(log_dir / "ala2-preeq-traj.dcd")).shape == (2, 251, 3)


def test_cli_solvent_with_amoeba_preprocessing_runs_the_box(tmp_path, monkeypatch):
    """--solvent --preprocess-method AMOEBA on a bare ACE-ALA-ALA-NME: the
    CLI preprocesses (the solvent was asked for and the input has none)
    with the AMOEBA minimization (1 cycle), writes the pair, and goes on
    into solvated production on that box (its QM/MM line, a DCD of the whole
    box).  The box is cut to a 4 A padding (251 atoms) by wrapping solvate;
    the CLI itself pads 10 A."""
    conftest.require_examples()
    solvate = TP.solvate
    monkeypatch.setattr(TP, "solvate", lambda atoms, padding, seed: solvate(
        atoms, padding=4.0, seed=seed))
    pdb = str(tmp_path / "ala2.pdb")
    write_pdb(pdb, TB.build_polyalanine(2))
    log_dir = tmp_path / "run"
    log_dir.mkdir()
    assert _main("--prot-file", pdb, "--solvent", "--preprocess-method", "AMOEBA",
                 "--max-cyc", "1", "--log-dir", str(log_dir), "--preeq-steps", "0",
                 "--sim-steps", "2", "--record-per-steps", "1") == 0
    text = "".join((log_dir / f).read_text() for f in os.listdir(log_dir) if f.endswith(".log"))
    assert "AMOEBA minimization" in text and "[1/1] E = " in text
    assert "QM/MM: 251 atoms in the box, 32 in the QM region" in text
    assert read_pdb(str(log_dir / "ala2-preeq-nowat.pdb")).positions.shape == (32, 3)
    assert TT.read_dcd(str(log_dir / "ala2-preeq-traj.dcd")).shape == (2, 251, 3)
