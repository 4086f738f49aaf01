"""A dry run of the mesh on CPU gloo ranks, the counterpart of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:69-107``).

    python -c "from ai2bmd_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

On n ranks: one ``EnsembleSimulation`` step of ``build_polyalanine(6)`` with a
2-layer x 16 ViSNet (random weights from seed 0) over a 2 x n/2 mesh (1 x n
for odd n), 2 replicas a dp index; then the solvated ensemble of
``solvate(build_polyalanine(6), padding=4.0)`` over an n x 1 mesh, one
replica a rank.  Each must step to finite positions.
"""

from __future__ import annotations

import numpy as np
import torch

from ai2bmd_torch.parallel.launch import launch

TINY = dict(hidden_channels=16, num_heads=2, num_layers=2, num_rbf=4)


def dryrun_multichip(n_ranks: int = 4, device_type: str = "cpu",
                     timeout_s: float | None = None) -> dict:
    """Both runs on a world of ``n_ranks`` (failed after ``timeout_s``, if
    given); every replica's final positions (rank 0's gather):
    ``{"sharded": [2 n_dp, N, 3], "solvated": [n, M, 3]}``."""
    return launch(_dryrun_rank, n_ranks, device_type, timeout_s=timeout_s)[0]


def _dryrun_rank(rank) -> dict:
    from ai2bmd_torch.host import Protein, build_fragment_index
    from ai2bmd_torch.io.build import build_polyalanine
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.parallel import EnsembleSimulation, SolvatedReplicaEnsemble, make_mesh
    from ai2bmd_torch.preprocess import solvate

    atoms = build_polyalanine(6)
    prot = Protein.from_atoms(atoms)
    cfg = ViSNetConfig(**TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0))

    n = rank.world_size
    n_dp = 2 if n % 2 == 0 else 1
    ens = EnsembleSimulation.build(prot, build_fragment_index(atoms), params, cfg,
                                   make_mesh(n_dp, n // n_dp), n_replicas=2 * n_dp,
                                   steps_per_call=1, opt_iters=2, device=rank.device)
    state = ens.run(ens.initial_state(prot.positions, seed=0), 1)
    pos = ens.gather(state).positions
    if not bool(torch.isfinite(pos).all()):
        raise RuntimeError("the sharded ensemble step produced non-finite positions")
    if state.step != 1:
        raise RuntimeError(f"the sharded ensemble is at step {state.step}, not 1")

    # solvated QM/MM replicas over every rank on dp, the production sampling layout
    box = solvate(atoms, padding=4.0, seed=0)
    sens = SolvatedReplicaEnsemble.build(box, params, cfg, n_replicas=n, mesh=make_mesh(n, 1),
                                         steps_per_call=1, device=rank.device)
    sstate = sens.run(sens.initial_state(box.positions, seed=0), 1)
    spos = sens.gather(sstate).positions
    if not bool(torch.isfinite(spos).all()):
        raise RuntimeError("the solvated dp step produced non-finite positions")
    if sstate.step != 1:
        raise RuntimeError(f"the solvated ensemble is at step {sstate.step}, not 1")
    return {"sharded": np.asarray(pos.cpu()), "solvated": np.asarray(spos.cpu())}
