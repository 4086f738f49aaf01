"""dp x mp meshes of ranks (port of ``ai2bmd_tpu/parallel/mesh.py``).

One rank a card.  Two axes of parallelism:

  * dp — replica ensembles: independent MD trajectories, a block of replicas
    a dp index, no communication between blocks
  * mp — fragment parallelism inside one replica: the dipeptide rows and
    ACE-NME units are split in blocks over the mp ranks, and the stitched
    energy and forces are all-reduced over them (``ShardedPotential``)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
("dp", "mp") over the ranks of the world, which must be started first
(``parallel.launch``).  ``mesh_layout`` is its arithmetic alone, with no
world: rank ``dp * n_mp + mp`` sits at (dp, mp), as JAX's devices do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("dp", "mp")


def mesh_layout(n_dp: int = 1, n_mp: int | None = None, n_ranks: int = 1,
                ranks=None) -> np.ndarray:
    """The [n_dp, n_mp] array of ranks: ``ranks`` (default 0 .. n_ranks-1)
    in row-major order.  ``n_mp`` None takes every rank left."""
    ranks = np.arange(n_ranks) if ranks is None else np.asarray(ranks)
    if n_mp is None:
        n_mp = len(ranks) // n_dp
    if n_dp * n_mp != len(ranks):
        raise ValueError(f"mesh {n_dp}x{n_mp} does not match {len(ranks)} devices")
    return ranks.reshape(n_dp, n_mp)


def mesh_of(layout: np.ndarray, device_type: str | None = None) -> DeviceMesh:
    """A ("dp", "mp") DeviceMesh over ``layout`` [n_dp, n_mp] of the world's
    ranks.  A collective call: every rank of the world makes it, with the same
    layout.  ``device_type`` None: "cuda" under NCCL, else "cpu"."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.as_tensor(np.asarray(layout)), mesh_dim_names=DIMS)


def make_mesh(n_dp: int = 1, n_mp: int | None = None, ranks=None,
              device_type: str | None = None) -> DeviceMesh:
    """The dp x mp mesh over every rank of the world (in ``ranks``' order
    when given); raises when n_dp x n_mp is not the world's size."""
    return mesh_of(mesh_layout(n_dp, n_mp, dist.get_world_size(), ranks), device_type)
