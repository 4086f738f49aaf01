"""The port's trajectory and restart files (ai2bmd_torch.io.trajectory, the
metrics CSV) against the JAX package's: the same bytes for the same frames, each package reads the
other's DCD, restarts round-trip, and a restart the JAX package wrote loads
into the port."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.io import trajectory as JT
from ai2bmd_tpu.utils import logging_utils as JLOG
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import simulation as TS
from ai2bmd_torch.utils import logging_utils as TLOG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBERS = np.array([6, 1, 1, 8, 7, 16, 1, 6])
DCD_TITLE = slice(4 + 84 + 4, 4 + 84 + 4 + 4 + 84 + 4)   # the title record


def _frames(rng, n=3):
    return [rng.normal(scale=5.0, size=(len(NUMBERS), 3)).astype(np.float32) for _ in range(n)]


def _write(mod, cls, path, frames, **kw):
    w = getattr(mod, cls)(path, **kw)
    for k, f in enumerate(frames):
        w.write(f, energy=-1.25 * k, step=10 * k)
    w.close()
    with open(path, "rb") as f:
        return f.read()


def test_xyz_bytes_equal_jax(tmp_path, rng):
    frames = _frames(rng)
    a = _write(TT, "XYZTrajectory", str(tmp_path / "t.xyz"), frames, numbers=NUMBERS)
    b = _write(JT, "XYZTrajectory", str(tmp_path / "j.xyz"), frames, numbers=NUMBERS)
    assert a == b and a.count(b"step=") == 3


@pytest.mark.parametrize("cell", [None, np.array([31.5, 32.25, 30.0])])
def test_dcd_equals_jax_title_aside_and_reads_across(tmp_path, rng, cell):
    """Header and frames byte for byte (the title record names each
    package); each package's read_dcd reads the other's file, cells too."""
    frames = _frames(rng)
    kw = dict(n_atoms=len(NUMBERS), timestep_fs=2.0, save_interval=10, cell=cell)
    a = _write(TT, "DCDTrajectory", str(tmp_path / "t.dcd"), frames, **kw)
    b = _write(JT, "DCDTrajectory", str(tmp_path / "j.dcd"), frames, **kw)
    assert len(a) == len(b)
    assert a[:DCD_TITLE.start] == b[:DCD_TITLE.start] and a[DCD_TITLE.stop:] == b[DCD_TITLE.stop:]
    assert b"ai2bmd-torch" in a[DCD_TITLE]
    for reader, path in ((JT.read_dcd, "t.dcd"), (TT.read_dcd, "j.dcd")):
        got, cells = reader(str(tmp_path / path), return_cells=True)
        np.testing.assert_array_equal(got, np.stack(frames))
        if cell is None:
            assert cells is None
        else:
            np.testing.assert_array_equal(cells, np.tile(cell, (3, 1)))


def test_metrics_csv_bytes_equal_jax(tmp_path):
    rows = [(10, -5.123456789, 2.5, 301.234, 26.1294), (20, -5.0, 2.75, 299.996, 26.0)]
    for mod, name in ((TLOG, "t.csv"), (JLOG, "j.csv")):
        m = mod.MetricsLog(str(tmp_path / name))
        for r in rows:
            m.write(*r)
        m.close()
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_restart_round_trips_with_the_generator_state(tmp_path, rng):
    """save_restart / load_restart keep every array bitwise, and the stored
    generator state continues the noise stream where it stopped."""
    P, V, F = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    aux = rng.normal(size=(2, 8, 3)).astype(np.float32)
    g = torch.Generator().manual_seed(4)
    torch.randn(7, generator=g)
    path = str(tmp_path / "x-restart.npz")
    TT.save_restart(path, torch.as_tensor(P), V, 42, g.get_state(), forces=F,
                    energy=torch.tensor(-3.5), aux=torch.as_tensor(aux))
    pos, vel, step, rng_state, extras = TT.load_restart(path)
    assert step == 42 and sorted(extras) == ["aux", "energy", "forces"]
    for got, want in ((pos, P), (vel, V), (extras["forces"], F), (extras["aux"], aux)):
        np.testing.assert_array_equal(got, want)
    assert float(extras["energy"]) == -3.5
    g2 = torch.Generator().manual_seed(0)
    g2.set_state(rng_state)
    assert torch.equal(torch.randn(5, generator=g2), torch.randn(5, generator=g))
    assert not os.path.exists(path + ".tmp.npz")


def test_jax_restart_loads_into_the_port(tmp_path, rng):
    """A checkpoint written by ai2bmd_tpu.io.trajectory.save_restart (cap
    offsets as its one aux leaf) loads with equal positions, velocities,
    forces, energy and aux, and no generator state: the Simulator then
    resumes from it with a noise stream seeded anew, and says so."""
    n = 6
    P, V, F = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    aux = rng.normal(size=(3, 8, 3)).astype(np.float32)
    path = str(tmp_path / "m-restart.npz")
    JT.save_restart(path, jnp.asarray(P), jnp.asarray(V), 17, jnp.zeros(2, jnp.uint32),
                    forces=jnp.asarray(F), energy=jnp.asarray(-2.0), aux=jnp.asarray(aux))
    pos, vel, step, rng_state, extras = TT.load_restart(path)
    assert step == 17 and rng_state is None
    for got, want in ((pos, P), (vel, V), (extras["forces"], F), (extras["aux"], aux)):
        np.testing.assert_array_equal(got, want)

    pot = lambda x, a: (x.new_zeros(()), torch.zeros_like(x), a)
    cfg = TS.SimulationConfig(seed=5, record_per_steps=2)
    sim = TS.Simulator(pot, np.full(n, 12.0), np.full(n, 6), cfg, str(tmp_path), "m",
                       stateful=True, init_aux=torch.zeros(3, 8, 3), device="cpu")
    logs = []
    s = sim.initial_state(None, restart=path, log=logs.append)
    assert s.step == 17 and torch.equal(s.aux, torch.as_tensor(aux))
    assert torch.equal(s.forces, torch.as_tensor(F)) and float(s.energy) == -2.0
    assert any("noise stream starts anew from seed 5" in line for line in logs)
    assert torch.equal(sim.generator.get_state(), torch.Generator().manual_seed(5).get_state())


def test_load_restart_refuses_several_aux_leaves(tmp_path):
    path = str(tmp_path / "s.npz")
    np.savez(path, positions=np.zeros((2, 3)), velocities=np.zeros((2, 3)), step=1,
             aux_0=np.zeros(2), aux_1=np.zeros(2))
    with pytest.raises(ValueError, match="2 aux leaves"):
        TT.load_restart(path)


def test_traj2dcd_tool_round_trip(tmp_path, rng):
    """The port's copy of tools/traj2dcd converts xyz -> dcd -> xyz."""
    frames = _frames(rng, 2)
    _write(TT, "XYZTrajectory", str(tmp_path / "a.xyz"), frames, numbers=NUMBERS)
    from ai2bmd_torch.tools import traj2dcd

    assert traj2dcd.main([str(tmp_path / "a.xyz"), str(tmp_path / "a.dcd")]) == 0
    np.testing.assert_allclose(TT.read_dcd(str(tmp_path / "a.dcd")), np.stack(frames),
                               rtol=0, atol=5e-7)
    symbols = "C H H O N S H C"
    assert traj2dcd.main([str(tmp_path / "a.dcd"), str(tmp_path / "b.xyz"),
                          "--symbols", symbols]) == 0
    back, syms = traj2dcd.read_xyz(str(tmp_path / "b.xyz"))
    assert syms == symbols.split()
    np.testing.assert_allclose(back, np.stack(frames), rtol=0, atol=1e-6)


def test_tee_output_is_undone(tmp_path):
    """tee_output mirrors both streams into its logfile, and untee_output
    puts the original streams back."""
    out, err = sys.stdout, sys.stderr
    path = TLOG.tee_output(str(tmp_path), "run")
    try:
        print("to the log")
        assert sys.stdout is not out
    finally:
        TLOG.untee_output()
    assert sys.stdout is out and sys.stderr is err
    assert "to the log" in open(path).read()


def test_sigusr2_dumps_the_stacks(tmp_path):
    """The port's copy of the SIGUSR2 stack dumper, in its own process."""
    code = ("import os, signal, sys; sys.path.insert(0, %r)\n"
            "from ai2bmd_torch.utils.signals import register_print_stack_on_sigusr2\n"
            "register_print_stack_on_sigusr2(out_dir=%r)\n"
            "os.kill(os.getpid(), signal.SIGUSR2)\n"
            "print(os.getpid())\n") % (REPO, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    pid = out.stdout.strip()
    assert "SIGUSR2 stack dump" in (tmp_path / f"stacktraces-{pid}.log").read_text()
