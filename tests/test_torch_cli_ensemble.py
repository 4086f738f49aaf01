"""The CLI's replica-ensemble route of the port (``python -m ai2bmd_torch
--replicas``) on the CPU: the vacuum ensemble and its restart, and the
refused mesh.  Split from tests/test_torch_cli.py so that pytest-xdist's
--dist loadfile runs the two files side by side."""

import logging
import os
import sys

import numpy as np
import pytest
import torch

import conftest
from ai2bmd_torch import cli as TCLI
from ai2bmd_torch.io import trajectory as TT

# test_torch_cli.py's
CLI_TINY = ["--device", "cpu", "--model-preset", "tiny", "--timestep", "0.25"]


def _main(argv):
    return TCLI.main(["--prot-file", conftest.example_pdb("chig"), *CLI_TINY, *argv])


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        assert z["aux_0"].shape[0] == 2 and z["positions"].shape == (2, 175, 3)
    assert _main([*common, "--sim-steps", "6", "--log-dir", str(b), "--restart"]) == 0
    assert TT.read_dcd(str(b / "chig-r001-traj-restart.dcd")).shape == (1, 175, 3)
    with np.load(tmp_path / "a" / "2x-ensemble-final.npz") as fa, \
            np.load(b / "2x-ensemble-final.npz") as fb:
        np.testing.assert_array_equal(fa["positions"], fb["positions"])
        np.testing.assert_array_equal(fa["velocities"], fb["velocities"])
        assert not np.array_equal(fa["positions"][0], fa["positions"][1])


def test_cli_ensemble_no_write_dcd(tmp_path):
    """--replicas 2 --no-write-dcd: no per-replica DCD, the checkpoint and
    the final npz all the same."""
    conftest.require_examples()
    assert _main(["--replicas", "2", "--record-per-steps", "2", "--sim-steps", "2",
                  "--no-write-dcd", "--log-dir", str(tmp_path)]) == 0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".dcd")]
    assert (tmp_path / "2x-ensemble-final.npz").exists()
    assert (tmp_path / "chig-2x-ensemble-restart.npz").exists()


def test_an_ensemble_mesh_over_several_cards_is_refused(monkeypatch, tmp_path):
    """No longer refused: JAX's mesh arithmetic (cli.py:280-282) with 4 cards
    gives a 1 x 4 mesh even at --mesh-dp 1 --mesh-mp 1, and the plan is an
    EnsembleSimulation over a world of 4 ranks, started through the launcher
    (recorded here, not run) with no wall-clock deadline; a solvated input
    runs over dp alone, as JAX's CLI runs it (one card at --mesh-dp 1); on
    one card the mesh is 1 x 1, and with --device cpu it is --mesh-dp x
    --mesh-mp."""
    import importlib

    conftest.require_examples()
    LA = importlib.import_module("ai2bmd_torch.parallel.launch")
    args = TCLI.build_parser().parse_args(
        ["--prot-file", conftest.example_pdb("chig"), "--replicas", "8"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TCLI._mesh_shape(args, torch.device("cuda")) == (1, 4)
    launched = []
    monkeypatch.setattr(LA, "launch", lambda fn, n, device_type, args=(), **kw:
                        launched.append((fn, n, device_type, args, kw)) or [0])
    assert TCLI._run_ensemble(args, torch.device("cuda"), None, str(tmp_path), None,
                              logging.getLogger("test")) == 0
    [(fn, n, device_type, body, kw)] = launched
    assert fn is TCLI._ensemble_body and n == 4 and device_type == "cuda"
    assert body[1] == TCLI.EnsemblePlan(1, 4, "sharded")
    assert kw.get("timeout_s") is None
    cuda = torch.device("cuda")
    assert TCLI._ensemble_plan(args, cuda, True) == TCLI.EnsemblePlan(1, 1, "solvated")
    args.mesh_dp = 2
    assert TCLI._ensemble_plan(args, cuda, True) == TCLI.EnsemblePlan(2, 1, "solvated")
    assert TCLI._ensemble_plan(args, cuda, False) == TCLI.EnsemblePlan(2, 2, "sharded")
    args.mesh_dp, args.mesh_mp = 4, 1
    assert TCLI._ensemble_plan(args, cuda, True) == TCLI.EnsemblePlan(4, 1, "solvated")
    assert TCLI._ensemble_plan(args, cuda, False) == TCLI.EnsemblePlan(4, 1, "replica")
    args.mesh_dp = 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TCLI._mesh_shape(args, torch.device("cuda")) == (1, 1)
    assert TCLI._mesh_shape(args, torch.device("cpu")) == (1, 1)
    args.mesh_dp = 2
    assert TCLI._mesh_shape(args, torch.device("cpu")) == (2, 1)
    assert TCLI._ensemble_plan(args, torch.device("cpu"), True) == TCLI.EnsemblePlan(
        2, 1, "solvated")
