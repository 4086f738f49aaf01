"""The JAX package's last top-level functions and their ports (ai2bmd_torch).

``md/constraints.py``: ``TetherRestraint`` and ``with_restraints`` (forces by
autograd), against JAX's in float64 under ``jax.enable_x64``;
``io/trajectory.latest_restart``; ``utils/logging_utils``: ``StepTimer``
(totals, counts and ``report()`` on the same clock readings) and
``profile_trace`` (a ``torch.profiler`` Chrome trace where JAX writes a
``jax.profiler`` one).  Inputs are made with numpy from a seed.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.io import trajectory as JT
from ai2bmd_tpu.md import constraints as JC
from ai2bmd_tpu.utils import logging_utils as JLU
from ai2bmd_torch.io import trajectory as TT
from ai2bmd_torch.md import constraints as TC
from ai2bmd_torch.utils import logging_utils as TLU

N = 40
F64_TOL = 1e-10      # float64, the same sums in another order


def _restraints(rng):
    """A tether over a seeded selection and one-sided springs over seeded
    pairs (some stretched past rt, some not), as numpy."""
    pos = rng.standard_normal((N, 3)) * 3.0
    ref = pos + rng.standard_normal((N, 3)) * 0.2
    weight = (rng.random((N, 1)) < 0.6).astype(np.float64)
    pairs = np.stack([rng.choice(N, 12, replace=False), rng.choice(N, 12, replace=False)], 1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    d = np.linalg.norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], axis=1)
    rt = d * np.where(rng.random(len(d)) < 0.5, 0.8, 1.2)
    return pos, ref, weight, pairs, rt


def _base_jax(P):
    e = jnp.sum(jnp.sin(P) * jnp.cos(0.5 * P))
    return e, -jax.grad(lambda p: jnp.sum(jnp.sin(p) * jnp.cos(0.5 * p)))(P)


def _base_torch(P):
    with torch.enable_grad():
        p = P.detach().requires_grad_(True)
        e = (torch.sin(p) * torch.cos(0.5 * p)).sum()
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


def test_tether_and_with_restraints_match_jax_in_float64(rng):
    """TetherRestraint's E, and with_restraints' (E, F = -dE/dx) over a base
    potential plus a tether and springs, to F64_TOL; no restraints returns
    the potential itself."""
    pos, ref, weight, pairs, rt = _restraints(rng)
    k = 0.7
    with jax.enable_x64(True):
        jt = JC.TetherRestraint(reference=jnp.asarray(ref), k=k, weight=jnp.asarray(weight))
        jb = JC.BondRestraint(pairs=jnp.asarray(pairs, jnp.int32), rt=jnp.asarray(rt),
                              k=jnp.full((len(rt),), 15.0))
        P = jnp.asarray(pos)
        e_tether_j = float(jt.energy(P))
        e_j, f_j = JC.with_restraints(_base_jax, [jt, jb])(P)
        e_j, f_j = float(e_j), np.asarray(f_j)
    tt = TC.TetherRestraint(reference=torch.from_numpy(ref), k=k, weight=torch.from_numpy(weight))
    tb = TC.BondRestraint(pairs=torch.from_numpy(pairs.astype(np.int64)),
                          rt=torch.from_numpy(rt), k=torch.full((len(rt),), 15.0,
                                                                dtype=torch.float64))
    P = torch.from_numpy(pos)
    assert abs(float(tt.energy(P)) - e_tether_j) <= F64_TOL * max(1.0, abs(e_tether_j))
    e_t, f_t = TC.with_restraints(_base_torch, [tt, tb])(P)
    assert f_t.dtype == torch.float64
    assert abs(float(e_t) - e_j) <= F64_TOL * max(1.0, abs(e_j))
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=F64_TOL)
    assert TC.with_restraints(_base_torch, []) is _base_torch
    assert JC.with_restraints(_base_jax, []) is _base_jax


@pytest.mark.parametrize("exists", [True, False], ids=["present", "absent"])
def test_latest_restart_matches_jax(tmp_path, exists):
    if exists:
        (tmp_path / "chig-restart.npz").write_bytes(b"")
    got = TT.latest_restart(str(tmp_path), "chig")
    assert got == JT.latest_restart(str(tmp_path), "chig")
    assert got == (str(tmp_path / "chig-restart.npz") if exists else None)


def test_step_timer_matches_jax_on_the_same_clock(monkeypatch):
    """The same stages on the same clock readings: equal totals and counts,
    and report() byte for byte (stages by total time, largest first)."""
    readings = [0.0, 1.5, 2.0, 2.25, 3.0, 3.125, 10.0, 10.5]
    timers = {}
    for name, mod in (("jax", JLU), ("torch", TLU)):
        clock = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer()
        for stage in ("force", "stitch", "stitch", "force"):
            with t.time(stage):
                pass
        timers[name] = t
    monkeypatch.undo()
    jt, tt = timers["jax"], timers["torch"]
    assert tt.totals == jt.totals == {"force": 2.0, "stitch": 0.375}
    assert tt.counts == jt.counts == {"force": 2, "stitch": 2}
    assert tt.report() == jt.report() == ("force: 2.000s total, 1000.00 ms/call x2\n"
                                          "stitch: 0.375s total, 187.50 ms/call x2")


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU: the block's host events, as a Chrome trace under
    log_dir/trace."""
    with TLU.profile_trace(str(tmp_path)) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]
