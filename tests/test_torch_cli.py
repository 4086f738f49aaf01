"""The port's user-facing vacuum path (ai2bmd_torch.cli, .simulators) against
the JAX package's (ai2bmd_tpu.cli, .simulators), on the CPU.

Parser parity; ProteinSimulation's cold cap offsets and first forces against
JAX's with JAX's weights bridged in (tiny model); `python -m ai2bmd_torch
--device cpu --model-preset tiny` end to end with --build-frames, then
--restart; the refused routes, each naming its ROADMAP item; a malformed
checkpoint; and the missing card.  The replica ensemble's route:
tests/test_torch_cli_ensemble.py (a file of its own, so that pytest-xdist's
--dist loadfile runs it beside this one); whole-molecule mode and
checkpoints: tests/test_torch_whole_molecule.py; preprocessing and solvated
ensembles: tests/test_torch_solvated_ensemble.py.

The CLI runs step at 0.25 fs: with random weights (no checkpoint ships)
vacuum Chignolin heats past the runaway guard (1.5 x 300 K) within a few fs
at 1 fs a step, in both packages."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu import cli as JCLI
from ai2bmd_tpu import simulators as JSIM
from ai2bmd_tpu.md import simulation as JS
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch import simulators as TSIM
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)   # --model-preset tiny
CLI_TINY = ["--device", "cpu", "--model-preset", "tiny", "--timestep", "0.25"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def test_parser_has_every_jax_option_with_its_default_and_choices():
    jax_opts, port_opts = _options(JCLI.build_parser()), _options(TCLI.build_parser())
    for name, a in jax_opts.items():
        assert name in port_opts, name
        b = port_opts[name]
        if name == "--base-dir":      # os.getcwd() at parser build time in both
            continue
        assert (b.default, b.choices, b.nargs, b.required) == \
               (a.default, a.choices, a.nargs, a.required), name
        assert type(b) is type(a), name
    assert set(port_opts) - set(jax_opts) == {"--device"}
    dev = port_opts["--device"]
    assert dev.default == "cuda" and dev.choices == ["cuda", "cpu"]


def test_matmul_precision_other_than_float32_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as exc:
        TCLI.main(["--prot-file", "x.pdb", "--device", "cpu", "--matmul-precision", "bfloat16"])
    assert exc.value.code == 2 and "float32 only" in capsys.readouterr().err


def test_protein_simulation_matches_jax(monkeypatch, tmp_path):
    """Cold cap offsets (10 L-BFGS iterations) and the first forces (one
    warm iteration from them) of ProteinSimulation on Chignolin with the
    tiny model, JAX's weights in both.  Tolerances: offsets 1e-5 A, forces
    1e-4 eV/A."""
    conftest.require_examples()
    pdb = conftest.example_pdb("chig")
    jps = JSIM.ProteinSimulation.from_pdb(
        pdb, log_dir=str(tmp_path / "j"), model_cfg=JV.ViSNetConfig(**TINY),
        sim_cfg=JS.SimulationConfig(preeq_steps=0))
    jparams, _ = JSIM.load_model(None, JV.ViSNetConfig(**TINY))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    monkeypatch.setattr(TSIM, "load_model", lambda ckpt, cfg=None, seed=0: (tparams, cfg))
    tps = TSIM.ProteinSimulation.from_pdb(
        pdb, log_dir=str(tmp_path / "t"), model_cfg=TV.ViSNetConfig(**TINY),
        sim_cfg=TS.SimulationConfig(preeq_steps=0), device="cpu")
    assert tps.prot_name == "chig" and len(tps.prot) == 175
    np.testing.assert_allclose(tps.sim._init_aux.numpy(), np.asarray(jps.sim._init_aux),
                               rtol=0, atol=1e-5)
    sj = jps.sim.initial_state(jps.prot.positions)
    st = tps.sim.initial_state(tps.prot.positions)
    np.testing.assert_allclose(st.forces.numpy(), np.asarray(sj.forces), rtol=0, atol=1e-4)
    np.testing.assert_allclose(st.aux.numpy(), np.asarray(sj.aux), rtol=0, atol=1e-5)
    assert st.step == 0 and torch.isfinite(st.velocities).all()


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")   # one thread, as one_thread above
    return subprocess.run([sys.executable, "-m", "ai2bmd_torch", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def test_cli_end_to_end_then_restart(tmp_path):
    """The ladder (1 step a stage), 4 recorded steps, frames; then --restart
    for 2 more steps into -restart trajectories, the metrics CSV continued."""
    conftest.require_examples()
    args = ["--prot-file", conftest.example_pdb("chig"), "--log-dir", str(tmp_path), *CLI_TINY]
    run = _cli(*args, "--preeq-steps", "1", "--sim-steps", "4", "--record-per-steps", "2",
               "--build-frames")
    assert run.returncode == 0, run.stderr[-4000:]
    assert "Pre-equilibration finished!" in run.stdout and "Simulation finished!" in run.stdout
    xyz = TT.read_dcd(str(tmp_path / "chig-traj.dcd"))
    assert xyz.shape == (2, 175, 3) and np.isfinite(xyz).all()
    assert sorted(os.listdir(tmp_path / "frames")) == ["structure00007.xyz",
                                                       "structure00009.xyz"]
    assert (tmp_path / "results" / "chig-traj.xyz").exists()
    logs = [f for f in os.listdir(tmp_path) if f.startswith("chig-") and f.endswith(".log")]
    assert logs and "Simulation finished!" in (tmp_path / logs[0]).read_text()

    again = _cli(*args, "--sim-steps", "2", "--record-per-steps", "2", "--restart")
    assert again.returncode == 0, again.stderr[-4000:]
    assert "Re-start simulation for 2 steps" in again.stdout
    assert TT.read_dcd(str(tmp_path / "chig-traj-restart.dcd")).shape == (1, 175, 3)
    rows = (tmp_path / "chig-metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["step", "7", "9", "11"]
    assert TT.read_dcd(str(tmp_path / "chig-traj.dcd")).shape == (2, 175, 3)


def _main(argv):
    return TCLI.main(["--prot-file", conftest.example_pdb("chig"), *CLI_TINY, *argv])


SOLVATED = ["--prot-file", "examples/chig_preprocessed/chig-preeq.pdb"]


# the refused routes' test (its last case, --preprocess-method AMOEBA, item
# 15) became a test of the route below: every route of items 11-15 runs
def test_cli_preprocess_method_amoeba_minimizes_then_runs(tmp_path, monkeypatch):
    """--preprocess --preprocess-method AMOEBA on a bare ACE-ALA-ALA-NME, in
    process: exit 0, the AMOEBA minimization's lines (2 cycles), the
    -preeq pair written, then --no-solvent runs the box's protein in vacuum.
    The box is cut to a 4 A padding (251 atoms) by wrapping solvate; the CLI
    itself pads 10 A."""
    from ai2bmd_torch import preprocess as TP
    from ai2bmd_torch.io import build as TB
    from ai2bmd_torch.io.pdb import read_pdb, write_pdb

    solvate = TP.solvate
    monkeypatch.setattr(TP, "solvate", lambda atoms, padding, seed: solvate(
        atoms, padding=4.0, seed=seed))
    pdb = str(tmp_path / "ala2.pdb")
    write_pdb(pdb, TB.build_polyalanine(2))
    assert TCLI.main(["--prot-file", pdb, *CLI_TINY, "--log-dir", str(tmp_path),
                      "--preprocess", "--preprocess-method", "AMOEBA", "--max-cyc", "2",
                      "--no-solvent", "--preeq-steps", "0", "--sim-steps", "2",
                      "--record-per-steps", "1"]) == 0
    text = "".join((tmp_path / f).read_text() for f in os.listdir(tmp_path)
                   if f.endswith(".log"))
    assert "AMOEBA minimization (mutual polarization, Ewald induction" in text
    assert "[2/2] E = " in text
    assert len(read_pdb(str(tmp_path / "ala2-preeq.pdb"))) == 251
    assert len(read_pdb(str(tmp_path / "ala2-preeq-nowat.pdb"))) == 32
    assert TT.read_dcd(str(tmp_path / "ala2-preeq-traj.dcd")).shape == (2, 32, 3)


@pytest.fixture(scope="module")
def small_box(tmp_path_factory):
    """A small solvated PDB: solvate(build_polyalanine(2), padding=4.0,
    seed=0), 251 atoms (tests/test_torch_solvated_ensemble.py's box)."""
    from ai2bmd_torch import preprocess as TP
    from ai2bmd_torch.io import build as TB
    from ai2bmd_torch.io.pdb import write_pdb

    path = str(tmp_path_factory.mktemp("box") / "ala2-preeq.pdb")
    write_pdb(path, TP.solvate(TB.build_polyalanine(2), padding=4.0, seed=0))
    return path


@pytest.mark.parametrize("argv, route", [
    (["--mm-method", "amoeba"], "AMOEBA"),
    (["--polarizable-mm"], "ff19SB + induced dipoles"),
], ids=["amoeba", "polarizable"])
def test_cli_runs_the_polarizable_solvent_routes(tmp_path, small_box, argv, route):
    """--mm-method amoeba (the AMOEBA solvent, item 15's QM/MM half) and
    --polarizable-mm (the hybrid, item 13b) on a lone solvated run: exit 0
    through the neighbour-list pair route, the QM/MM line naming the MM
    engine, a trajectory of the whole box."""
    run = _cli("--prot-file", small_box, "--log-dir", str(tmp_path), "--preeq-steps", "0",
               "--sim-steps", "2", "--record-per-steps", "1", *CLI_TINY, *argv)
    assert run.returncode == 0, run.stderr[-4000:]
    assert f"nl pairs, {route} MM" in run.stdout, run.stdout[-2000:]
    frames = TT.read_dcd(str(tmp_path / "ala2-preeq-traj.dcd"))
    assert frames.shape == (2, 251, 3) and np.isfinite(frames).all()


@pytest.mark.parametrize("argv, name", [
    (["--ckpt-path", "{tmp}/visnet.ckpt"], "visnet.ckpt"),
    (["--ckpt-path", "{tmp}/visnet.npz", "--mode", "visnet"], "visnet.npz"),
    (["--ckpt-path", "{tmp}", "--ckpt-type", "abc"], "visnet-uni-abc.ckpt"),
])
def test_cli_a_malformed_checkpoint_exits_naming_the_file(tmp_path, argv, name):
    """A checkpoint file that is not one (a Lightning .ckpt, a converted
    .npz, the file --ckpt-path and --ckpt-type join) exits nonzero with a
    message naming it, before any step."""
    conftest.require_examples()
    for f in ("visnet.ckpt", "visnet.npz", "visnet-uni-abc.ckpt"):
        (tmp_path / f).write_bytes(b"not a checkpoint")
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    run = _cli("--prot-file", conftest.example_pdb("chig"), "--log-dir", str(tmp_path),
               "--sim-steps", "2", *CLI_TINY, *argv)
    assert run.returncode != 0
    assert f"{tmp_path / name} is not a" in run.stderr, run.stderr[-2000:]
    assert not any(f.endswith(".dcd") for f in os.listdir(tmp_path))


def test_cli_without_a_card_raises_the_require_cuda_message(tmp_path):
    """No --device cpu and no card: the CLI stops with require_cuda's error
    instead of running on the CPU."""
    code = textwrap.dedent(f"""
        import sys, torch
        torch.cuda.is_available = lambda: False
        from ai2bmd_torch.cli import main
        main(["--prot-file", {conftest.example_pdb("chig")!r}, "--log-dir", {str(tmp_path)!r},
              "--model-preset", "tiny", "--sim-steps", "2"])
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0
    assert "no CUDA device is available" in run.stderr
    assert not any(f.endswith(".dcd") for f in os.listdir(tmp_path))


def test_cli_solvated_ensemble_drops_the_polarizable_flags_with_a_warning(tmp_path, small_box):
    """--replicas 2 on a solvated input runs the fixed-charge ff19SB
    ensemble, as JAX's ensemble route does (ai2bmd_tpu/cli.py:288-302): it
    logs one line each for --mm-method amoeba and --polarizable-mm instead
    of raising, and exits 0."""
    run = _cli("--prot-file", small_box, "--log-dir", str(tmp_path), "--replicas", "2",
               "--sim-steps", "2", "--record-per-steps", "2", "--mm-method", "amoeba",
               "--polarizable-mm", *CLI_TINY)
    assert run.returncode == 0, run.stderr[-4000:]
    text = run.stdout + run.stderr + "".join(
        (tmp_path / f).read_text() for f in os.listdir(tmp_path) if f.endswith(".log"))
    assert "use --replicas 1 for --polarizable-mm" in text
    assert "use --replicas 1 for --mm-method amoeba" in text
    assert "dense pairs" in run.stdout
