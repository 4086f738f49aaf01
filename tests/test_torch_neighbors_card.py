"""The neighbour list the port rebuilds inside the captured step, against the
JAX package's skin-triggered list, on the CPU.

QMMMPotential's nl route (ai2bmd_torch.physics.qmmm) rebuilds the full
box's [N, K] list on every call (ops/neighbors.rebuild: no host decision, so
the step is one CUDA graph on the card), by the cell build wherever the box
holds 3 cells an axis at cutoff + skin.  JAX rebuilds under lax.cond when
an atom moved more than skin/2 (ai2bmd_tpu/physics/qmmm.py:443-448).  Every
consumer masks pairs by r < cutoff, so the two must give the same pair set
within the cutoff at every step; the overflow flag stays set in the carry
from the step that overflowed.  The box: tests/test_cellpair.py's uniform
random one (600 atoms, L = 21 A), random-walked for five steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.ops import neighbors as JNL
from ai2bmd_torch.ops import neighbors as TNL

CUTOFF, SKIN, K = 5.5, 1.5, 128


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(rng, n=600, L=21.0, steps=5, sigma=0.08):
    P = rng.uniform(0, L, size=(n, 3))
    out = [P]
    for _ in range(steps):
        P = P + rng.normal(0.0, sigma, size=P.shape)
        out.append(P)
    return np.array([L, L, L]), out


def _within(P, cell, rows, cutoff):
    """{(i, j)} of a list's slots whose minimum-image distance is < cutoff."""
    idx, valid = (np.asarray(a) for a in rows)
    i = np.repeat(np.arange(len(P)), idx.shape[1])[valid.reshape(-1)]
    j = idx.reshape(-1)[valid.reshape(-1)]
    d = P[j] - P[i]
    d -= cell * np.floor(d / cell + 0.5)
    keep = (d * d).sum(-1) < cutoff * cutoff
    return set(zip(i[keep].tolist(), j[keep].tolist()))


def test_every_step_list_gives_jax_skin_triggered_pair_set(rng):
    """Five random-walk steps: the port's list rebuilt every step by the cell
    build (the grid QMMMPotential takes at cutoff + skin) and by the tiled
    dense build, against JAX's list rebuilt only when needs_rebuild fires:
    the same pairs within the cutoff at every step, and JAX did reuse a
    stale list on some step."""
    cell, path = _walk(rng)
    grid = TNL.cell_grid(cell, CUTOFF + SKIN, len(path[0]))
    assert grid is not None and grid[0] == (3, 3, 3)
    nbr = torch.as_tensor(TNL.neighbor_cells(grid[0]))
    cell_j = jnp.asarray(cell, jnp.float32)
    cell_t = torch.as_tensor(cell, dtype=torch.float32)
    build_j = jax.jit(lambda P: JNL.build_neighbor_list(P, CUTOFF + SKIN, K, cell_j))
    needs = jax.jit(lambda nl, P: JNL.needs_rebuild(nl, P, SKIN, cell_j))
    cells = lambda P: TNL.build_neighbor_list_cells(P, CUTOFF + SKIN, K, cell_t, *grid,
                                                    nbr_cells=nbr)
    dense = lambda P: TNL.build_neighbor_list(P, CUTOFF + SKIN, K, cell_t)
    P0 = jnp.asarray(path[0], jnp.float32)
    nl_j = build_j(P0)
    nl_c = cells(torch.as_tensor(path[0], dtype=torch.float32))
    reused = 0
    for P in path[1:]:
        Pj, Pt = jnp.asarray(P, jnp.float32), torch.as_tensor(P, dtype=torch.float32)
        if bool(needs(nl_j, Pj)):
            nl_j = build_j(Pj)
        else:
            reused += 1
        nl_c = TNL.rebuild(nl_c, Pt, cells)
        nl_d = dense(Pt)
        want = _within(P, cell, (nl_j.idx, nl_j.valid), CUTOFF)
        assert want, "no pairs within the cutoff"
        for nl in (nl_c, nl_d):
            assert not bool(nl.overflow)
            assert torch.equal(nl.ref_pos, Pt)
            assert (nl.idx[~nl.valid] == len(P)).all()
            assert _within(P, cell, (nl.idx, nl.valid), CUTOFF) == want
    assert reused > 0


def test_overflow_flag_stays_set_after_the_step_that_overflowed(rng):
    """A step whose rows hold more than K neighbours (the box squeezed) sets
    the flag; the next rebuild at sound positions keeps it (sticky), for the
    cell build and for the tiled dense build; a fresh build there has none.
    An over-full cell flags overflow too."""
    cell, path = _walk(rng, steps=1)
    cell_t = torch.as_tensor(cell, dtype=torch.float32)
    grid = TNL.cell_grid(cell, CUTOFF + SKIN, len(path[0]))
    builds = [lambda P: TNL.build_neighbor_list_cells(P, CUTOFF + SKIN, K, cell_t, *grid),
              lambda P: TNL.build_neighbor_list(P, CUTOFF + SKIN, K, cell_t)]
    P = torch.as_tensor(path[1], dtype=torch.float32)
    crowded = cell_t / 2 + 0.3 * (P - cell_t / 2)
    for build in builds:
        nl = build(P)
        assert not bool(nl.overflow)
        nl = TNL.rebuild(nl, crowded, build)
        assert bool(nl.overflow)
        nl = TNL.rebuild(nl, P, build)
        assert bool(nl.overflow) and not bool(build(P).overflow)
    lumped = P.clone()
    lumped[: grid[1] + 1] = cell_t / 2 + 0.01 * torch.arange(grid[1] + 1)[:, None]
    full = TNL.build_neighbor_list_cells(lumped, CUTOFF + SKIN, 600, cell_t, *grid)
    assert bool(full.overflow)
    assert TNL.max_cell_occupancy(lumped.numpy(), cell, grid[0]) > grid[1]
