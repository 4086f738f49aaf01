"""The collectives of the mesh (``parallel``): sums and gathers over a
process group of ``torch.distributed``, the counterparts of JAX's
``lax.psum`` and ``lax.all_gather`` inside ``shard_map``.

NCCL takes CUDA tensors and gloo CPU tensors.  Gloo also takes CUDA tensors
for these collectives (it copies them through the host itself), which is how
two ranks share one card in ``chip_smoke.py``'s rehearsal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, the same bits on every
    rank (a new tensor; ``t`` is left as it was)."""
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in the group's rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)
