"""The reference's device strategies as mesh shapes (port of
``ai2bmd_tpu/parallel/device_strategy.py``).

The reference assigns GPUs to calculator roles and partitions fragments into
per-device chunks by hand (src/Calculators/device_strategy.py:143-265).  Here
those choices become the shape of a dp x mp mesh:

  excess-compute  -> replica throughput: dp = n, mp = 1
  small-molecule  -> one trajectory's latency: dp = 1, mp = n
  large-molecule  -> mp as large as the fragment count supports (halved
                     until it is no larger), the rest of the ranks in dp
"""

from __future__ import annotations

import torch.distributed as dist

from ai2bmd_torch.parallel.mesh import make_mesh


def strategy_shape(strategy: str, n: int, n_fragments: int | None = None) -> tuple[int, int]:
    """(n_dp, n_mp) of ``strategy`` over n ranks."""
    if strategy == "excess-compute":
        return n, 1
    if strategy == "small-molecule":
        return 1, n
    if strategy == "large-molecule":
        mp = n
        if n_fragments:
            while mp > 1 and n_fragments < mp:
                mp //= 2
        return n // mp, mp
    raise ValueError(f"unknown device strategy {strategy!r}")


def mesh_for_strategy(strategy: str, n_fragments: int | None = None, ranks=None,
                      device_type: str | None = None):
    """The mesh of ``strategy`` over the world's ranks (``device_strategy.py:
    25-42``)."""
    n = dist.get_world_size() if ranks is None else len(ranks)
    n_dp, n_mp = strategy_shape(strategy, n, n_fragments)
    return make_mesh(n_dp, n_mp, ranks, device_type)
