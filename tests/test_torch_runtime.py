"""The port's native runtime (ai2bmd_torch.runtime, the C++ background
trajectory writer) against the JAX package's native writer and the port's
Python writers: twins of tests/test_runtime.py and of
tests/test_utils.py::test_native_dcd_unit_cell, the same bytes for the same
frames (the DCD title aside), the guards, IO failures, and where and how the
library is built."""

import glob
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from ai2bmd_tpu import runtime as JR
from ai2bmd_torch import runtime as TR
from ai2bmd_torch.io import trajectory as TT
from test_torch_trajectory import DCD_TITLE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
native = pytest.mark.skipif(not TR.native_available(), reason="no native toolchain")
NUMBERS = np.array([6, 1, 1, 8, 7] * 4, np.int32)


def _frames(rng, n=7, atoms=len(NUMBERS)):
    return [(rng.random((atoms, 3)) * 10).astype(np.float32) for _ in range(n)]


@native
def test_async_writer_roundtrip(tmp_path, rng):
    """tests/test_runtime.py::test_async_writer_roundtrip on the port: the DCD
    read back by the port's read_dcd, the XYZ text."""
    n = len(NUMBERS)
    dcd, xyz = str(tmp_path / "t.dcd"), str(tmp_path / "t.xyz")
    w = TR.AsyncTrajectoryWriter(dcd, xyz, NUMBERS, timestep_fs=2.0, save_interval=5)
    frames = _frames(rng)
    for i, f in enumerate(frames):
        w.write(f, energy=-1.5 * i, step=5 * i)
    w.close()
    back = TT.read_dcd(dcd)
    assert back.shape == (7, n, 3)
    np.testing.assert_array_equal(back, np.stack(frames))
    text = open(xyz).read().splitlines()
    assert text[0].strip() == str(n)
    assert "energy_eV=-1.500000" in text[n + 3]
    assert sum(line.startswith("step=") for line in text) == 7


@native
def test_async_writer_nonblocking(tmp_path):
    """50 submits of 3,000 atoms return within 1 s; close drains them all."""
    numbers = np.full(3000, 8, np.int32)
    w = TR.AsyncTrajectoryWriter(str(tmp_path / "big.dcd"), None, numbers)
    frame = np.zeros((3000, 3), np.float32)
    t0 = time.perf_counter()
    for i in range(50):
        w.write(frame, step=i)
    assert time.perf_counter() - t0 < 1.0
    w.close()
    assert TT.read_dcd(str(tmp_path / "big.dcd")).shape[0] == 50


@native
def test_write_after_close_raises(tmp_path):
    w = TR.AsyncTrajectoryWriter(str(tmp_path / "x.dcd"), None, np.array([6, 6], np.int32))
    w.write(np.zeros((2, 3), np.float32))
    w.close()
    with pytest.raises(RuntimeError):
        w.write(np.zeros((2, 3), np.float32))


@native
def test_native_dcd_unit_cell(tmp_path):
    """tests/test_utils.py::test_native_dcd_unit_cell on the port: the
    per-frame unit-cell records."""
    cell = np.array([25.0, 25.0, 40.0])
    path = str(tmp_path / "n.dcd")
    w = TR.AsyncTrajectoryWriter(path, None, np.array([8, 1, 1]), cell=cell)
    rng = np.random.default_rng(2)
    frames = [rng.random((3, 3)).astype(np.float32) * 10 for _ in range(4)]
    for i, fr in enumerate(frames):
        w.write(fr, step=i)
    w.close()
    back, cells = TT.read_dcd(path, return_cells=True)
    assert back.shape == (4, 3, 3)
    np.testing.assert_array_equal(back[3], frames[3])
    np.testing.assert_allclose(cells, np.tile(cell, (4, 1)))


@native
@pytest.mark.parametrize("cell", [None, np.array([31.5, 32.25, 30.0])])
def test_bytes_equal_jax_native_and_python_writers(tmp_path, rng, cell):
    """The same frames through the port's native writer, the JAX package's
    native writer and the port's Python writers: XYZ bytes equal, DCD bytes
    equal apart from the title record, which names each writer."""
    if not JR.native_available():
        pytest.skip("the JAX package's native runtime is unavailable")
    frames = _frames(rng, n=4)
    kw = dict(timestep_fs=2.0, save_interval=10, cell=cell)
    out = {}
    for name, cls in (("torch", TR.AsyncTrajectoryWriter), ("jax", JR.AsyncTrajectoryWriter)):
        dcd, xyz = str(tmp_path / f"{name}.dcd"), str(tmp_path / f"{name}.xyz")
        w = cls(dcd, xyz, NUMBERS, **kw)
        for k, f in enumerate(frames):
            w.write(f, energy=-1.25 * k, step=10 * k)
        w.close()
        out[name] = (open(dcd, "rb").read(), open(xyz, "rb").read())
    x = TT.XYZTrajectory(str(tmp_path / "py.xyz"), NUMBERS)
    d = TT.DCDTrajectory(str(tmp_path / "py.dcd"), len(NUMBERS), **kw)
    for k, f in enumerate(frames):
        x.write(f, energy=-1.25 * k, step=10 * k)
        d.write(f)
    x.close()
    d.close()
    out["python"] = (open(tmp_path / "py.dcd", "rb").read(), open(tmp_path / "py.xyz", "rb").read())
    dcd, xyz = out["torch"]
    assert xyz.count(b"step=") == 4
    for other in ("jax", "python"):
        o_dcd, o_xyz = out[other]
        assert xyz == o_xyz, other
        assert len(dcd) == len(o_dcd), other
        assert dcd[:DCD_TITLE.start] == o_dcd[:DCD_TITLE.start], other
        assert dcd[DCD_TITLE.stop:] == o_dcd[DCD_TITLE.stop:], other
    assert b"Created by ai2bmd-torch native runtime" in dcd[DCD_TITLE]
    assert b"ai2bmd-tpu native runtime" in out["jax"][0][DCD_TITLE]
    got, cells = TT.read_dcd(str(tmp_path / "torch.dcd"), return_cells=True)
    np.testing.assert_array_equal(got, np.stack(frames))
    assert (cells is None) == (cell is None)


@native
def test_wrong_frame_shape_raises(tmp_path):
    w = TR.AsyncTrajectoryWriter(str(tmp_path / "s.dcd"), None, NUMBERS)
    for bad in (np.zeros((len(NUMBERS) - 1, 3)), np.zeros((len(NUMBERS), 2)),
                np.zeros(3 * len(NUMBERS))):
        with pytest.raises(ValueError, match="frame of shape"):
            w.write(bad)
    w.close()
    assert TT.read_dcd(str(tmp_path / "s.dcd")).shape == (0, len(NUMBERS), 3)


@native
def test_pending_after_close_raises(tmp_path):
    w = TR.AsyncTrajectoryWriter(None, str(tmp_path / "p.xyz"), NUMBERS)
    w.write(np.zeros((len(NUMBERS), 3)))
    assert w.pending() in (0, 1)
    w.close()
    w.close()                    # a second close does nothing
    with pytest.raises(RuntimeError, match="closed"):
        w.pending()


@native
@pytest.mark.skipif(not os.path.exists("/dev/full"), reason="no /dev/full")
def test_io_failure_raises_oserror_as_the_python_writers_do():
    """A device that takes no bytes: the worker's writes fail, close raises
    OSError; the Python DCD writer raises OSError too."""
    w = TR.AsyncTrajectoryWriter("/dev/full", None, NUMBERS)
    w.write(np.zeros((len(NUMBERS), 3)))
    with pytest.raises(OSError, match="failed"):
        w.close()
    with pytest.raises(OSError):
        d = TT.DCDTrajectory("/dev/full", len(NUMBERS))
        d.write(np.zeros((len(NUMBERS), 3)))
        d.close()


@native
@pytest.mark.skipif(not os.path.exists("/dev/full"), reason="no /dev/full")
@pytest.mark.parametrize("target", ["dcd", "xyz"])
def test_io_failure_raises_from_the_next_write(target):
    """A failure shows at the next frame, not only at the end of the run: once
    the worker's write to /dev/full has failed (3,000 atoms a frame overflow
    the stdio buffer), ``write`` raises OSError before ``close``, and
    ``close`` raises too."""
    numbers = np.resize(NUMBERS, 3000)
    paths = ("/dev/full", None) if target == "dcd" else (None, "/dev/full")
    w = TR.AsyncTrajectoryWriter(*paths, numbers)
    frame = np.zeros((len(numbers), 3), np.float32)
    deadline = time.monotonic() + 10.0
    with pytest.raises(OSError, match="failed"):
        while time.monotonic() < deadline:
            w.write(frame)
            time.sleep(0.01)
    with pytest.raises(OSError, match="failed"):
        w.close()


def test_unavailable_library_raises_and_reports(monkeypatch):
    """A failed build: native_available() is False, and the writer raises
    RuntimeError naming the reason (what the Simulator logs)."""
    def fail():
        raise RuntimeError("g++ could not run: not found")

    monkeypatch.setattr(TR, "_lib", None)
    monkeypatch.setattr(TR, "_error", None)
    monkeypatch.setattr(TR, "build", fail)
    assert not TR.native_available()
    with pytest.raises(RuntimeError, match="native runtime unavailable: g\\+\\+ could not run"):
        TR.AsyncTrajectoryWriter(None, None, NUMBERS)


@native
def test_library_lives_under_build(tmp_path):
    """The library is built under build/ai2bmd_torch/ and no shared object
    sits inside the package; processes that build at once each load a whole
    library and leave one file and no temporary."""
    TR.library()
    path = TR.BUILD_INFO["path"]
    assert os.path.dirname(path) == os.path.join(REPO, "build", "ai2bmd_torch")
    assert os.path.basename(path).startswith("libai2bmd_runtime_") and os.path.exists(path)
    pkg = os.path.join(REPO, "ai2bmd_torch")
    assert glob.glob(os.path.join(pkg, "**", "*.so"), recursive=True) == []
    code = textwrap.dedent("""
        import sys
        from pathlib import Path
        import numpy as np
        from ai2bmd_torch import runtime as R
        R.BUILD_DIR = Path(sys.argv[1])
        w = R.AsyncTrajectoryWriter(None, sys.argv[2], np.array([8, 1, 1]))
        w.write(np.ones((3, 3)), step=1)
        w.close()
        print(R.BUILD_INFO["path"])
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "lib"),
                               str(tmp_path / f"{i}.xyz")], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert os.listdir(tmp_path / "lib") == [os.path.basename(outs[0][0].strip())]
    for i in range(3):
        assert (tmp_path / f"{i}.xyz").read_text().startswith("3\nstep=1 energy_eV=0.000000\n")
