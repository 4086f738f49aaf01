"""Fixed-shape neighbour lists under periodic boundaries.

Port of ``ai2bmd_tpu/ops/neighbors.py:33-226``: [N, K] Verlet lists within a
cutoff (the reference uses torch_cluster's radius_graph, src/ViSNet/model/
utils.py:252-276, src/Calculators/pme.py:164):

  * ``build_neighbor_list``: a tiled dense distance pass, [tile, N] at a
    time, keeping the K nearest neighbours within the cutoff by top-k; an
    atom with more than K reports ``overflow``;
  * ``build_neighbor_list_cells``: the same list from a periodic cell
    decomposition (one [M, 27M] block a cell, ``CELL_CHUNK`` cells a
    pass), O(N) for large boxes;
  * the list is full (each pair in both rows), so a force sums its own row;
  * ``needs_rebuild``: the Verlet-skin criterion on the displacement since
    the build; ``rebuild``: a fresh list with the overflow flag kept, which
    the QM/MM step calls every step (no host decision, so it is captured).

Neither build reads anything back to the host.

Ties between equal distances may order a row's slots differently from JAX's
top-k; the pair set is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# cells a pass of build_neighbor_list_cells: bounds the [chunk, M, 27M]
# blocks and the captured graph's node count (cellpair.py chunks its blocks
# by 18 cells alike)
CELL_CHUNK = 18


class NeighborList(NamedTuple):
    idx: torch.Tensor       # [N, K] int64 neighbour indices (N = padding)
    valid: torch.Tensor     # [N, K] bool
    ref_pos: torch.Tensor   # positions at build time (for displacement checks)
    overflow: torch.Tensor  # 0-d bool: some atom had > K neighbours (list incomplete)


class _GatherRows(torch.autograd.Function):
    """x[idx] whose backward sums the gradient rows back with one
    ``index_add`` accumulated in float64 (for float32 inputs): the atomic
    adds of CUDA then round to the same float32 sum whatever their order,
    where advanced indexing's backward sorts the indices first (93% of a
    step's device time at [N, K] = 17,882 x 640 on an H100).  The backward
    is plain tensor algebra, so it differentiates again (create_graph)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.float64 if g.dtype == torch.float32 else g.dtype
        flat = g.reshape(-1, *g.shape[idx.dim():]).to(acc)
        out = flat.new_zeros((ctx.n_rows, *flat.shape[1:])).index_add(0, idx.reshape(-1), flat)
        return out.to(g.dtype), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] ([*idx.shape, *x.shape[1:]]), its backward one index_add
    accumulated in float64 (``_GatherRows``)."""
    return _GatherRows.apply(x, idx)


def _pbc_diff(vec: torch.Tensor, cell) -> torch.Tensor:
    """Minimum image with floor(x + 0.5) (``neighbors.py:41-46``)."""
    if cell is None:
        return vec
    return vec - cell * torch.floor(vec / cell + 0.5)


def _top_within(d2: torch.Tensor, within: torch.Tensor, k_max: int):
    """(idx, valid, count) of each row's k_max nearest slots within the cutoff."""
    score = torch.where(within, -d2, torch.full_like(d2, -torch.inf))
    idx = torch.topk(score, k_max, dim=1).indices
    return idx, torch.gather(within, 1, idx), within.sum(1)


def build_neighbor_list(P: torch.Tensor, cutoff: float, k_max: int, cell=None,
                        tile: int = 512) -> NeighborList:
    """Exact [N, K] within-cutoff list via a tiled dense pass."""
    n = P.shape[0]
    k_max = min(k_max, n)
    cols = torch.arange(n, device=P.device)
    idxs, valids, counts = [], [], []
    for start in range(0, n, tile):
        block = P[start:start + tile]
        vec = _pbc_diff(P[None, :, :] - block[:, None, :], cell)
        d2 = (vec * vec).sum(-1)                                   # [tile, N]
        rows = torch.arange(start, start + block.shape[0], device=P.device)
        within = (d2 < cutoff * cutoff) & (cols[None, :] != rows[:, None])
        idx, valid, count = _top_within(d2, within, k_max)
        idxs.append(idx)
        valids.append(valid)
        counts.append(count)
    valid = torch.cat(valids)
    idx = torch.where(valid, torch.cat(idxs), n)
    return NeighborList(idx=idx, valid=valid, ref_pos=P,
                        overflow=(torch.cat(counts) > k_max).any())


def needs_rebuild(nl: NeighborList, P: torch.Tensor, skin: float, cell=None) -> torch.Tensor:
    disp = _pbc_diff(P - nl.ref_pos, cell)
    return (disp * disp).sum(-1).max() > (0.5 * skin) ** 2


def rebuild(nl: NeighborList, P: torch.Tensor, build) -> NeighborList:
    """A fresh list at P from ``build(P)``, with ``nl``'s overflow flag kept
    (sticky), so that an overflow at any step stays visible in the carry.
    Rebuilding every step gives the skin-triggered list's pair set within
    the cutoff, and a captured step needs no branch on device data."""
    new = build(P)
    return new._replace(overflow=new.overflow | nl.overflow)


# ---------------------------------------------------------------------------
# cell-list build: an O(N) rebuild for large periodic boxes
# ---------------------------------------------------------------------------

def cell_grid(cell_np, cutoff: float, n_atoms: int, max_occ: int | None = None):
    """Static cell-grid geometry for ``build_neighbor_list_cells``: (nc [3]
    ints, max_occ), or None when the box holds fewer than 3 cells on some
    axis (callers then take the tiled dense build).  max_occ defaults to ~2x
    the mean occupancy at uniform density, rounded up to a multiple of 8."""
    cell_np = np.asarray(cell_np, np.float64)
    nc = np.floor(cell_np / cutoff).astype(int)
    if np.any(nc < 3):
        return None
    if max_occ is None:
        mean_occ = n_atoms / float(np.prod(nc))
        max_occ = max(16, int(np.ceil(2.0 * mean_occ / 8.0)) * 8)
    return tuple(int(x) for x in nc), int(max_occ)


def max_cell_occupancy(positions, cell_np, nc: tuple) -> int:
    """The fullest cell's atom count at these positions (host numpy), binned
    as ``build_neighbor_list_cells`` bins them."""
    frac = np.asarray(positions, np.float64) / np.asarray(cell_np, np.float64)
    cid3 = np.minimum(((frac - np.floor(frac)) * np.asarray(nc)).astype(int), np.asarray(nc) - 1)
    cid = (cid3[:, 0] * nc[1] + cid3[:, 1]) * nc[2] + cid3[:, 2]
    return int(np.bincount(cid).max())


def cell_plan(cell_np, positions, cutoff: float, device):
    """(grid, nbr_cells) for ``build_list``: the cell build's (nc, max_occ)
    and its [C, 27] neighbourhoods on ``device`` where the box holds 3 cells
    an axis at ``cutoff`` and the input's cells fit max_occ, else (None,
    None): an input far from liquid-like density (a crowded cell) takes the
    tiled dense build, the same pair set with no cell to overflow."""
    grid = cell_grid(cell_np, cutoff, len(positions))
    if grid is None or max_cell_occupancy(positions, cell_np, grid[0]) > grid[1]:
        return None, None
    return grid, torch.as_tensor(neighbor_cells(grid[0]), device=device)


def build_list(P: torch.Tensor, cutoff: float, k_max: int, cell: torch.Tensor, grid,
               nbr_cells) -> NeighborList:
    """The [N, K] list within ``cutoff`` by the cell build on ``cell_plan``'s
    grid, or by the tiled dense build where it gave none."""
    if grid is not None:
        nc, max_occ = grid
        return build_neighbor_list_cells(P, cutoff, k_max, cell, nc, max_occ,
                                         nbr_cells=nbr_cells)
    return build_neighbor_list(P, cutoff, k_max, cell)


def neighbor_cells(nc: tuple) -> np.ndarray:
    """[C, 27] ids of each cell's 3x3x3 periodic neighbourhood (dx, dy, dz
    each in -1, 0, 1, x slowest)."""
    ncx, ncy, ncz = nc
    ids = np.arange(ncx * ncy * ncz)
    cz, cy, cx = ids % ncz, (ids // ncz) % ncy, ids // (ncy * ncz)
    offs = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)])
    nbx = (cx[:, None] + offs[None, :, 0]) % ncx
    nby = (cy[:, None] + offs[None, :, 1]) % ncy
    nbz = (cz[:, None] + offs[None, :, 2]) % ncz
    return (nbx * ncy + nby) * ncz + nbz


def build_neighbor_list_cells(P: torch.Tensor, cutoff: float, k_max: int, cell: torch.Tensor,
                              nc: tuple, max_occ: int,
                              nbr_cells: torch.Tensor | None = None) -> NeighborList:
    """Exact [N, K] within-cutoff list via a periodic cell decomposition
    (``neighbors.py:124-226``): atoms binned into cells of side >= cutoff,
    one dense [M, 27M] distance block a cell, ``CELL_CHUNK`` cells a pass (JAX
    maps over the cells one at a time).  Same contract as
    ``build_neighbor_list``: the pair set, idx == N on dead slots; overflow
    flags an over-full cell or K row.  Nothing is read back to the host and
    every shape is fixed, so the build runs inside a captured step, given
    ``nbr_cells`` (``neighbor_cells(nc)`` on the device: made here when
    None, a copy from the host that a capture cannot hold)."""
    n = P.shape[0]
    dev = P.device
    k_max = min(k_max, n)
    ncx, ncy, ncz = nc
    C, M = ncx * ncy * ncz, max_occ
    if nbr_cells is None:
        nbr_cells = torch.as_tensor(neighbor_cells(nc), device=dev)        # [C, 27]

    frac = P / cell
    frac = frac - torch.floor(frac)
    cid3 = [torch.clamp((frac[:, a] * nc[a]).long(), max=nc[a] - 1) for a in range(3)]
    cid = (cid3[0] * ncy + cid3[1]) * ncz + cid3[2]

    # occupancy table: rank within the cell from the sorted order
    order = torch.argsort(cid, stable=True)
    scid = cid[order]
    first = torch.searchsorted(scid, scid, side="left")
    rank_sorted = torch.arange(n, device=dev) - first
    occ_overflow = (rank_sorted >= M).any()
    slot_sorted = torch.clamp(rank_sorted, max=M - 1)
    occ_idx = torch.full((C * M,), n, dtype=torch.long, device=dev)
    occ_idx[scid * M + slot_sorted] = order
    occ_idx = occ_idx.reshape(C, M)
    Ppad = torch.cat([P, torch.full((1, 3), 1e6, dtype=P.dtype, device=dev)])
    occ_P = Ppad[occ_idx]                                              # [C, M, 3]

    idx_c, valid_c, count_c = [], [], []
    for c0 in range(0, C, CELL_CHUNK):
        nb = nbr_cells[c0:c0 + CELL_CHUNK]                             # [c, 27]
        cj = occ_idx[nb].reshape(nb.shape[0], 1, 27 * M)               # [c, 1, 27M]
        Pj = occ_P[nb].reshape(nb.shape[0], 1, 27 * M, 3)
        ci = occ_idx[c0:c0 + CELL_CHUNK, :, None]                      # [c, M, 1]
        Pi = occ_P[c0:c0 + CELL_CHUNK, :, None, :]
        d2 = sum(_pbc_diff(Pj[..., a] - Pi[..., a], cell[a]) ** 2 for a in range(3))
        within = (d2 < cutoff * cutoff) & (cj != ci) & (cj < n)        # [c, M, 27M]
        score = torch.where(within, -d2, torch.full_like(d2, -torch.inf))
        kidx = torch.topk(score, k_max, dim=-1).indices
        valid = torch.gather(within, -1, kidx)
        idx_c.append(torch.where(valid, torch.gather(cj.expand(-1, M, -1), -1, kidx), n))
        valid_c.append(valid)
        count_c.append(within.sum(-1))

    # back to atom order: atom i lives at (cid[i], rank[i])
    rank = torch.zeros(n, dtype=torch.long, device=dev)
    rank[order] = slot_sorted
    row = cid * M + rank
    idx = torch.cat(idx_c).reshape(C * M, k_max)[row]
    valid = torch.cat(valid_c).reshape(C * M, k_max)[row]
    counts = torch.cat(count_c).reshape(C * M)[row]
    return NeighborList(idx=idx, valid=valid, ref_pos=P,
                        overflow=occ_overflow | (counts > k_max).any())
