"""Rank programs of tests/test_torch_parallel.py, tests/test_torch_mesh.py and
tests/test_torch_precision.py.

A spawned rank imports the module of its function afresh, and
tests/conftest.py imports JAX, so the functions the ranks run live here, in
a module that imports torch and the port only.  Each returns what the tests
assert on; ``parallel.launch`` brings it back to the test process (tensors as
numpy arrays).  The model is the JAX tests' 2 layers x 16 (TINY), its weights
passed in as the JAX parameter tree in numpy.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ai2bmd_torch.frag import hydrogen as HY
from ai2bmd_torch.frag import runtime as RT
from ai2bmd_torch.host import build_fragment_index, example_pdb, load_protein
from ai2bmd_torch.io import build as TB
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.models.visnet import ViSNetConfig
from ai2bmd_torch.parallel import (EnsembleSimulation, ReplicaEnsemble, ShardedPotential,
                                   SolvatedReplicaEnsemble, make_mesh)
from ai2bmd_torch.preprocess import solvate
from ai2bmd_torch.utils.collectives import all_gather_cat

TINY = dict(hidden_channels=16, num_heads=2, num_layers=2, num_rbf=4)
OPT_ITERS = 2        # the cold cap solve of JAX's tests/test_parallel.py
N_REPLICAS = 4
STEPS = 3
SEED = 7
# the most a test's world may take before it is failed (s)
WORLD_S = 600


def chig():
    prot = load_protein(example_pdb("chig"))
    return prot, build_fragment_index(prot.atoms)


def solvated_box():
    """The 251-atom box of tests/test_torch_solvated_ensemble.py."""
    return solvate(TB.build_polyalanine(2), padding=4.0, seed=0)


def perturbed_rows(rt: RT.FragmentRuntime, prot) -> torch.Tensor:
    """Placed cap rows of Chignolin moved by N(0, 0.05 A), seed 3: a start
    the L-BFGS has work to do from."""
    P = torch.as_tensor(prot.positions, dtype=torch.float32)
    noise = np.random.default_rng(3).normal(0.0, 0.05, size=tuple(rt.valid.shape) + (3,))
    return RT.build_row_positions(rt, P) + torch.as_tensor(noise, dtype=torch.float32)


def world_of_two(rank, jparams) -> dict:
    """Meshes 1 x 2 and 2 x 1 over two ranks: the all-reduced cap solve on
    split rows, ShardedPotential.energy_forces, ReplicaEnsemble and
    SolvatedReplicaEnsemble over dp."""
    params, cfg = params_from_jax(jparams), ViSNetConfig(**TINY)
    prot, fi = chig()
    P = torch.as_tensor(prot.positions, dtype=torch.float32)
    out = {}

    mp = make_mesh(1, 2)
    rt = RT.FragmentRuntime.build(fi, device="cpu", row_multiple=2)
    r_loc = rt.valid.shape[0] // 2
    rows = slice(rank.rank * r_loc, (rank.rank + 1) * r_loc)
    pos = HY.optimize_caps(rt.ht.rows(rows), perturbed_rows(rt, prot)[rows], n_iter=10,
                           group=mp.get_group("mp"))
    out["caps_split"] = all_gather_cat(pos, mp.get_group("mp"))

    sp = ShardedPotential.build(prot, fi, params, cfg, mp, opt_iters=OPT_ITERS, device="cpu")
    out["sp_e"], out["sp_f"] = sp.energy_forces(P)

    dp = make_mesh(2, 1)
    ens = ReplicaEnsemble.build(prot, fi, params, cfg, N_REPLICAS, steps_per_call=STEPS,
                                replica_chunk=2, device="cpu", mesh=dp)
    state = ens.run(ens.initial_state(prot.positions, seed=SEED, opt_iters=OPT_ITERS), 1)
    every = ens.gather(state)
    out["replica"] = {k: getattr(every, k) for k in ("positions", "velocities", "forces",
                                                      "energy", "aux")}

    box = solvated_box()
    sens = SolvatedReplicaEnsemble.build(box, params, cfg, n_replicas=2, mesh=dp,
                                         steps_per_call=2, device="cpu")
    sstate = sens.run(sens.initial_state(box.positions, seed=1), 1)
    every = sens.gather(sstate)
    out["solvated"] = {k: getattr(every, k) for k in ("positions", "velocities", "forces")}
    out["solvated_step"] = sstate.step
    out["imports"] = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "ai2bmd_tpu"})
    return out


def world_of_four(rank, jparams) -> dict:
    """ShardedPotential over a 1 x 4 mesh (its bucket 0 padded with empty
    rows), and EnsembleSimulation over 2 x 2: the cold start, STEPS steps of
    N_REPLICAS replicas, every replica gathered and this rank's own copy."""
    params, cfg = params_from_jax(jparams), ViSNetConfig(**TINY)
    prot, fi = chig()
    P = torch.as_tensor(prot.positions, dtype=torch.float32)
    out = {}
    sp = ShardedPotential.build(prot, fi, params, cfg, make_mesh(1, 4), opt_iters=OPT_ITERS,
                                device="cpu")
    out["sp_e"], out["sp_f"] = sp.energy_forces(P)
    out["layout"] = sp.layout

    mesh = make_mesh(2, 2)
    ens = EnsembleSimulation.build(prot, fi, params, cfg, mesh, N_REPLICAS,
                                   steps_per_call=STEPS, opt_iters=OPT_ITERS, device="cpu")
    start = ens.initial_state(prot.positions, seed=SEED)
    first = ens.gather(start)
    out["initial_e"], out["initial_f"] = first.energy, first.forces
    state = ens.run(start, 1)
    every = ens.gather(state)
    out["step"] = state.step
    out["positions"], out["forces"] = every.positions, every.forces
    out["local_positions"] = state.positions
    out["dp"] = mesh.get_local_rank("dp")
    return out


def precision_of_a_rank(rank) -> dict:
    """What a spawned rank runs its products at: torch's float32 matmul
    precision, the --matmul-precision value it was given, the kernels' mode,
    and the mode's plain product of two fixed operands."""
    from ai2bmd_torch.ops import _build, tf32x3, vismp  # noqa: F401  (vismp reads the mode)
    from ai2bmd_torch.utils.device import chosen_matmul_precision

    x = torch.linspace(-1.0, 1.0, 64).reshape(8, 8) / 3.0
    return dict(rank=rank.rank, torch=torch.get_float32_matmul_precision(),
                chosen=chosen_matmul_precision(), mode=_build.MM_MODE,
                product=tf32x3.plain_mm()(x, x.T))
