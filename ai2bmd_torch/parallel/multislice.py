"""Ensemble placement over several hosts (port of
``ai2bmd_tpu/parallel/multislice.py``).

A TPU pod slice is a block of chips joined by ICI, and slices are joined only
by the data-center network.  On GPUs a "slice" is a host: its cards are
joined by NVLink, and hosts only by the network.  Replicas never communicate
while they step, so the replica axis (dp) may span hosts, while the fragment
axis (mp), whose all-reduce and all-gather run every step, stays inside one
host.  ``make_hybrid_mesh`` builds a ("dp", "mp") mesh with that guarantee:

  * on several hosts (the ranks' hostnames, all-gathered, name more than
    one) the hosts are the slices: dp crosses hosts on its outermost stride
    and each mp row lies inside one host; an mp axis larger than a host is
    an error, not a silent fallback;
  * on one host, ``n_slices`` emulates slices by contiguous grouping of the
    ranks, as JAX's emulation groups its devices (the invariant is still
    checked, ``assert_mp_slice_local``).

``hybrid_layout`` is the arithmetic alone: the [n_dp, n_mp] array of ranks,
with no world.
"""

from __future__ import annotations

import socket

import numpy as np
import torch.distributed as dist

from ai2bmd_torch.parallel.mesh import mesh_of


def group_by_host(hostnames: list[str]) -> dict[int, list[int]]:
    """Ranks grouped by their hostname ``hostnames[rank]``; slices numbered in
    the order of their first rank.  One host -> {0: every rank}."""
    order: dict[str, int] = {}
    groups: dict[int, list[int]] = {}
    for rank, host in enumerate(hostnames):
        groups.setdefault(order.setdefault(host, len(order)), []).append(rank)
    return groups


def detect_slices(group=None) -> dict[int, list[int]]:
    """The world's ranks grouped by host (a collective call: the hostnames
    are all-gathered)."""
    names: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(names, socket.gethostname(), group=group)
    return group_by_host(names)


def hybrid_layout(n_dp: int, n_mp: int, slices: dict[int, list[int]],
                  n_slices: int | None = None) -> tuple[np.ndarray, dict[int, list[int]]]:
    """([n_dp, n_mp] array of ranks, the slices it was laid out over).

    ``slices`` maps each slice to its ranks (``detect_slices``).  With more
    than one, they are the slices, and ``n_slices`` must match their count;
    with one, ``n_slices`` (default 1) emulates slices by contiguous grouping.
    n_dp is the total replica axis, a multiple of the slice count."""
    ranks = [r for s in sorted(slices) for r in slices[s]]
    if len(slices) > 1:
        if n_slices is not None and n_slices != len(slices):
            raise ValueError(f"requested {n_slices} slices but hardware has {len(slices)}")
        n_slices = len(slices)
    else:
        n_slices = n_slices or 1
        per = len(ranks) // n_slices
        if per * n_slices != len(ranks):
            raise ValueError(f"{len(ranks)} devices do not split into {n_slices} slices")
        slices = {s: ranks[s * per:(s + 1) * per] for s in range(n_slices)}

    sizes = {len(g) for g in slices.values()}
    if len(sizes) != 1:
        raise ValueError(f"unequal slice sizes {sorted(sizes)}")
    per_slice = sizes.pop()
    if n_dp % n_slices:
        raise ValueError(f"dp={n_dp} does not divide over {n_slices} slices")
    dp_per_slice = n_dp // n_slices
    if n_mp > per_slice:
        raise ValueError(
            f"mp={n_mp} exceeds the {per_slice}-device slice: the fragment all-reduce and "
            "all-gather would cross hosts over the network (the DCN of a TPU pod), not "
            "NVLink. Shard replicas (dp) across slices instead.")
    if dp_per_slice * n_mp != per_slice:
        raise ValueError(f"per-slice mesh {dp_per_slice}x{n_mp} != {per_slice} devices")
    layout = np.concatenate([np.asarray(slices[s]).reshape(dp_per_slice, n_mp)
                             for s in sorted(slices)])
    assert_mp_slice_local(layout, slices)
    return layout, slices


def make_hybrid_mesh(n_dp: int, n_mp: int, n_slices: int | None = None,
                     device_type: str | None = None):
    """A ("dp", "mp") mesh of the world whose mp axis never leaves a slice
    (``multislice.py:51-124``); a collective call."""
    layout, _ = hybrid_layout(n_dp, n_mp, detect_slices(), n_slices)
    return mesh_of(layout, device_type)


def assert_mp_slice_local(layout, slices: dict[int, list[int]]) -> None:
    """Every mp row of ``layout`` (a [n_dp, n_mp] array of ranks, or a mesh)
    lies inside one slice of ``slices``."""
    if hasattr(layout, "mesh"):
        layout = layout.mesh
    slice_of = {r: s for s, rs in slices.items() for r in rs}
    for row, ranks in enumerate(np.asarray(layout).tolist()):
        found = {slice_of[r] for r in ranks}
        if len(found) > 1:
            raise AssertionError(f"mp row {row} spans slices {sorted(found)}: the "
                                 "intra-replica collectives would cross hosts")
