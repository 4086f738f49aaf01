"""The port's user-facing vacuum path (ai2bmd_torch.cli, .simulators) against
the JAX package's (ai2bmd_tpu.cli, .simulators), on the CPU.

Parser parity; ProteinSimulation's cold cap offsets and first forces against
JAX's with JAX's weights bridged in (tiny model); `python -m ai2bmd_torch
--device cpu --model-preset tiny` end to end with --build-frames, then
--restart; the replica ensemble and its restart; the refused routes, each
naming its ROADMAP item; a malformed checkpoint; and the missing card.
Whole-molecule mode and checkpoints: tests/test_torch_whole_molecule.py.

The CLI runs step at 0.25 fs: with random weights (no checkpoint ships)
vacuum Chignolin heats past the runaway guard (1.5 x 300 K) within a few fs
at 1 fs a step, in both packages."""

import logging
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
    env["PYTHONPATH"] = REPO
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


def test_cli_replica_ensemble_and_its_restart(tmp_path):
    """--replicas 2 in process: a DCD a replica, the final npz, the
    checkpoint with both generators; 4 steps then --restart to 6 equal 6
    straight steps bitwise on the CPU, and the tee is undone."""
    conftest.require_examples()
    out, err = sys.stdout, sys.stderr
    common = ["--replicas", "2", "--record-per-steps", "2"]
    assert _main([*common, "--sim-steps", "6", "--log-dir", str(tmp_path / "a")]) == 0
    assert _main([*common, "--sim-steps", "4", "--log-dir", str(tmp_path / "b")]) == 0
    assert sys.stdout is out and sys.stderr is err
    b = tmp_path / "b"
    for r in range(2):
        assert TT.read_dcd(str(b / f"chig-r{r:03d}-traj.dcd")).shape == (2, 175, 3)
    with np.load(b / "chig-2x-ensemble-restart.npz") as z:
        assert int(z["step"]) == 4 and z["rng_states"].shape[0] == 2
        assert z["aux"].shape[0] == 2 and z["positions"].shape == (2, 175, 3)
    assert _main([*common, "--sim-steps", "6", "--log-dir", str(b), "--restart"]) == 0
    assert TT.read_dcd(str(b / "chig-r001-traj-restart.dcd")).shape == (1, 175, 3)
    with np.load(tmp_path / "a" / "2x-ensemble-final.npz") as fa, \
            np.load(b / "2x-ensemble-final.npz") as fb:
        np.testing.assert_array_equal(fa["positions"], fb["positions"])
        np.testing.assert_array_equal(fa["velocities"], fb["velocities"])
        assert not np.array_equal(fa["positions"][0], fa["positions"][1])


SOLVATED = ["--prot-file", "examples/chig_preprocessed/chig-preeq.pdb"]


# the ids the cases had beside the two whole-molecule / checkpoint cases,
# which went when those routes were ported, and the pme (12) and solvated
# (13) cases, which became tests of the routes:
# test_torch_pme.py::test_cli_runs_pme_in_fragment_mode and
# test_torch_qmmm.py::test_cli_runs_the_solvated_box_with_explicit_solvent
@pytest.mark.parametrize("argv, item", [
    (["--preprocess"], 14),
    ([*SOLVATED, "--mm-method", "amoeba"], 15),
    ([*SOLVATED, "--polarizable-mm"], "13b"),
], ids=["argv4-14", "amoeba-15", "polarizable-13b"])
def test_cli_refused_routes_name_their_item(tmp_path, argv, item):
    """Each route the port does not have yet exits nonzero naming its
    ROADMAP item (on a solvated input, before any model is built)."""
    conftest.require_examples()
    run = _cli("--prot-file", conftest.example_pdb("chig"), "--log-dir", str(tmp_path),
               "--sim-steps", "2", *CLI_TINY, *argv)
    assert run.returncode != 0
    assert f"Queue 1 item {item}" in run.stderr, run.stderr[-2000:]


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


def test_an_ensemble_mesh_over_several_cards_is_refused(monkeypatch, tmp_path):
    """JAX's mesh arithmetic (cli.py:280-282) with 4 cards gives a 1 x 4
    mesh even at --mesh-dp 1 --mesh-mp 1: refused for item 17 before any
    work; on one card it is 1 x 1."""
    args = TCLI.build_parser().parse_args(["--prot-file", "x.pdb", "--replicas", "8"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TCLI._mesh_devices(args, torch.device("cuda")) == 4
    with pytest.raises(NotImplementedError, match="item 17"):
        TCLI._run_ensemble(args, torch.device("cuda"), None, str(tmp_path), None,
                           logging.getLogger("test"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TCLI._mesh_devices(args, torch.device("cuda")) == 1
    assert TCLI._mesh_devices(args, torch.device("cpu")) == 1


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
