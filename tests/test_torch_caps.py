"""Port parity: cap placement, the cap AMBER gradient and the cap L-BFGS
(ai2bmd_torch vs ai2bmd_tpu) on Chignolin's real dipeptide rows, float32 CPU.

The port's plain cap gradient (K4's plain version: autograd of the plain
energy) is held against jax.grad of the JAX energy and against the JAX
Pallas cap kernel in interpret mode, as tests/test_fused_caps.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu.frag import hydrogen as JH
from ai2bmd_tpu.frag import runtime as JR
from ai2bmd_tpu.frag.indexer import build_fragment_index
from ai2bmd_tpu.io.pdb import read_pdb
from ai2bmd_tpu.io.reorder import normalize_atom_order
from ai2bmd_tpu.ops.pallas.caps import CapKernelTables
from ai2bmd_tpu.ops.pallas.caps import amber_grad_rows as pallas_cap_grad
from ai2bmd_torch import host as THost
from ai2bmd_torch.frag import hydrogen as TH
from ai2bmd_torch.frag import runtime as TR
from ai2bmd_torch.ops import caps as TC

T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def chig():
    conftest.require_examples()
    atoms = normalize_atom_order(read_pdb(conftest.example_pdb("chig")))
    fi = build_fragment_index(atoms)
    P = np.asarray(atoms.positions, np.float32)
    return JR.FragmentRuntime.build(fi), TR.FragmentRuntime.build(fi, device="cpu"), P


def _rows(chig, perturb):
    jrt, trt, P = chig
    pos = np.asarray(JR.build_row_positions(jrt, jnp.asarray(P)))
    if perturb:
        pos = pos + np.random.default_rng(3).normal(0.0, perturb, pos.shape).astype(np.float32)
    return pos


def test_row_positions_match(chig):
    jrt, trt, P = chig
    ref = np.asarray(JR.build_row_positions(jrt, jnp.asarray(P)))
    np.testing.assert_allclose(TR.build_row_positions(trt, T(P)).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("perturb", [0.0, 0.05], ids=["template", "perturbed"])
def test_cap_energy_and_gradient_match_jax(chig, perturb):
    """Energy and plain gradient against jax.grad.  Tolerance 1e-5 of the
    largest gradient: both are float32 autograd of the same formula
    (observed 4e-7 to 1.3e-6 relative)."""
    jrt, trt, _ = chig
    pos = _rows(chig, perturb)
    e_ref = float(JH.amber_energy(jrt.ht, jnp.asarray(pos)))
    assert float(TH.amber_energy(trt.ht, T(pos))) == pytest.approx(e_ref, rel=1e-6)
    g_ref = np.asarray(jax.jit(jax.grad(lambda p: JH.amber_energy(jrt.ht, p)))(jnp.asarray(pos)))
    g = TC.amber_grad_rows(trt.ht.caps, T(pos)).numpy()
    scale = max(float(np.abs(g_ref).max()), 1.0)
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("perturb", [0.0, 0.05], ids=["template", "perturbed"])
def test_cap_gradient_matches_pallas_kernel(chig, perturb):
    """Against the Pallas kernel in interpret mode.  Tolerance 2e-4 of the
    largest gradient, as tests/test_fused_caps.py: the TPU kernel evaluates
    atan2 by polynomial and n*phi by recurrence (observed ~7e-7 relative)."""
    jrt, trt, _ = chig
    pos = _rows(chig, perturb)
    ct = CapKernelTables.build(jrt.ht.tables, np.asarray(jrt.ht.type_id), S=pos.shape[1],
                               scee=jrt.ht.scee, scnb=jrt.ht.scnb, interpret=True)
    g_ref = np.asarray(pallas_cap_grad(ct, jnp.asarray(pos)))
    g = TC.amber_grad_rows(trt.ht.caps, T(pos)).numpy()
    scale = max(float(np.abs(g_ref).max()), 1.0)
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("n_iter", [1, 10], ids=["warm1", "cold10"])
def test_optimize_caps_iterates_match_jax(chig, n_iter):
    """The L-BFGS cap positions.  Tolerance 1e-5 A: float32 iterates of the
    same recursion (observed 0 after one iteration, 2e-6 A after ten)."""
    jrt, trt, _ = chig
    pos = _rows(chig, 0.0)
    ref = np.asarray(JH.optimize_caps(jrt.ht, jnp.asarray(pos), n_iter=n_iter))
    got = TH.optimize_caps(trt.ht, T(pos), n_iter=n_iter).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    moved = np.abs(got - pos).max()
    assert moved > 1e-3        # the caps really moved


def test_cap_kernel_tables_fold_scalings(chig):
    """K4's tables are the plain tables with 1/scnb and 1/scee folded in."""
    _, trt, _ = chig
    ct = trt.ht.caps
    nb_a, nb_b, nb_q, nb_mask = ct.kernel[11:15]
    np.testing.assert_allclose(nb_a.numpy(), (ct.nb_acoef / ct.scnb).numpy(), rtol=1e-6)
    np.testing.assert_allclose(nb_b.numpy(), (ct.nb_bcoef / ct.scnb).numpy(), rtol=1e-6)
    np.testing.assert_allclose(nb_q.numpy(), (ct.nb_qq / ct.scee).numpy(), rtol=1e-6)
    assert torch.equal(nb_mask.bool(), ct.nb_mask)
    assert all(t.dtype in (torch.int32, torch.float32) for t in ct.kernel)


def _walk_slots(ct, r):
    """[(atom, carries force)] of every (term, endpoint) slot of row r in K4's
    numbering (bonds, angles, dihedrals, pairs; term-major), by a walk over
    the terms: a slot carries force unless its pair is masked out or all its
    term's endpoints are one atom."""
    out = []
    for tab, mask in ((ct.bond_ij, None), (ct.angle_ijk, None), (ct.dih_ijkl, None),
                      (ct.nb_ij, ct.nb_mask)):
        for m, ends in enumerate(tab[r].tolist()):
            live = len(set(ends)) > 1 and (mask is None or bool(mask[r, m]))
            out += [(a, live) for a in ends]
    return out


@pytest.mark.parametrize("name", ["chig", "trpcage", "ww", "abd"])
def test_cap_slot_lists(name):
    """K4's per-atom slot lists (ops/caps.slot_lists) on each bundled
    protein: every slot that can carry force appears exactly once, under the
    atom its index table names, in ascending slot order; the slots left out
    are those of masked-out pairs and of one-atom (padding) terms.  And the
    lists' per-atom float32 sums, in list order, equal bitwise a scan over
    every slot in slot order that adds the slots of each atom (the sum K4
    took before the lists), when the left-out slots carry +-0.0 as K4 writes
    them; a scan in the reverse order does not, so the order is tested."""
    conftest.require_examples()
    prot = THost.load_protein(THost.example_pdb(name))
    rt = TR.FragmentRuntime.build(THost.build_fragment_index(prot.atoms), device="cpu")
    ct = rt.ht.caps
    ptr, idx = ct.kernel[-2].numpy(), ct.kernel[-1].numpy()
    R, S = rt.gather_idx.shape
    NB, NA, ND, NP = ct.sizes
    NE = 2 * NB + 3 * NA + 4 * ND + 2 * NP
    assert ptr.shape == (R, S + 1) and idx.shape == (R, NE)
    assert ptr.dtype == idx.dtype == np.int32
    rng = np.random.default_rng(0)
    reordered = 0
    for r in range(R):
        slots = _walk_slots(ct, r)
        assert len(slots) == NE
        assert ptr[r, 0] == 0 and (np.diff(ptr[r]) >= 0).all()
        assert sorted(idx[r, :ptr[r, S]].tolist()) == [e for e, (_, live) in enumerate(slots)
                                                       if live]
        # slot forces of many magnitudes (so the order of a sum shows), +-0.0
        # where a slot carries none
        f = (rng.normal(size=(NE, 3)) * 10.0 ** rng.uniform(-3, 3, (NE, 1))).astype(np.float32)
        for e, (_, live) in enumerate(slots):
            if not live:
                f[e] = np.float32(-0.0) if e % 2 else np.float32(0.0)
        scan = np.zeros((S, 3), np.float32)
        back = np.zeros((S, 3), np.float32)
        for e, (a, _) in enumerate(slots):
            scan[a] += f[e]
        for e, (a, _) in reversed(list(enumerate(slots))):
            back[a] += f[e]
        lists = np.zeros((S, 3), np.float32)
        for a in range(S):
            mine = idx[r, ptr[r, a]:ptr[r, a + 1]]
            assert all(slots[e][0] == a for e in mine) and (np.diff(mine) > 0).all()
            for e in mine:
                lists[a] += f[e]
        assert np.array_equal(lists, scan) and np.array_equal(np.signbit(lists),
                                                              np.signbit(scan))
        reordered += int((back != scan).sum())
    assert reordered > 0
