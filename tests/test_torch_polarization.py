"""The induced-dipole hybrid (ai2bmd_torch.physics.polarization, the
``polarizable=True`` term of the ff19SB engine's nl route) against the JAX
package's, on the CPU in float64.

The box: the JAX suite's solvate(build_polyalanine(2), padding=4.0, seed=0)
(251 atoms; tests/test_torch_solvated_ensemble.py's), cutoff 6 A.  JAX runs
under jax.enable_x64 with its float32 tables widened (values unchanged), so
that its sums run in float64 as the port's do on float64 tensors (the port
rounds its tables through float32 as JAX builds them).  Tolerances: energies
1e-8 relative, forces 1e-7 of the largest component."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu import preprocess as JP
from ai2bmd_tpu.io import build as JB
from ai2bmd_tpu.physics import mm as JMM
from ai2bmd_tpu.physics import polarization as JPOL
from ai2bmd_tpu.physics import qmmm as JQ
from ai2bmd_torch import preprocess as TP
from ai2bmd_torch.io import build as TB
from ai2bmd_torch.ops import neighbors as TNL
from ai2bmd_torch.physics import mm as TMM
from ai2bmd_torch.physics import polarization as TPOL
from ai2bmd_torch.physics import qmmm as TQ

CUTOFF, K = 6.0, 256


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _widened(cls, monkeypatch):
    """cls.build with every float32 table widened to float64."""
    build = cls.build.__func__

    def build64(c, *a, **k):
        m = build(c, *a, **k)
        wide = {f.name: getattr(m, f.name).astype(jnp.float64) for f in dataclasses.fields(m)
                if getattr(getattr(m, f.name), "dtype", None) == jnp.float32}
        return dataclasses.replace(m, **wide)

    monkeypatch.setattr(cls, "build", classmethod(build64))


@pytest.fixture(scope="module")
def box():
    return (JP.solvate(JB.build_polyalanine(2), padding=4.0, seed=0),
            TP.solvate(TB.build_polyalanine(2), padding=4.0, seed=0))


def test_polarizable_qmmm_step_matches_jax(box, monkeypatch):
    """QMMMPotential.build(polarizable=True) with a zero QM term takes the
    nl route in both packages (the full box's list, the protein's fresh
    list; the hybrid on both MM evaluations): E and F of one call, and the
    term alone (polarization_energy_forces on the full box's list)."""
    jbox, tbox = box
    _widened(JMM.MMSystem, monkeypatch)
    _widened(JPOL.PolarizationParams, monkeypatch)
    zero_t = lambda P: (P.sum() * 0, torch.zeros_like(P))
    tq = TQ.QMMMPotential.build(tbox, zero_t, cutoff=CUTOFF, k_neighbors=K, polarizable=True,
                                device="cpu", dtype=torch.float64)
    assert tq.backend == "nl" and tq.mm_full.polarization is not None
    P = torch.as_tensor(tbox.positions, dtype=torch.float64)
    aux = tq.init_aux(P)
    e_t, f_t, (nl, _) = tq(P, aux)
    e_p, f_p = TPOL.polarization_energy_forces(tq.mm_full.polarization, P, nl, tq.mm_full.cell)
    with jax.enable_x64(True):
        jq = JQ.QMMMPotential.build(jbox, lambda P: (jnp.sum(P) * 0, jnp.zeros_like(P)),
                                    cutoff=CUTOFF, k_neighbors=K, polarizable=True)
        assert not jq.dense and jq.cp is None
        Pj = jnp.asarray(jbox.positions, jnp.float64)
        e_j, f_j, _ = jax.jit(jq.__call__)(Pj, jq.init_aux(Pj))
        pol = JPOL.PolarizationParams.build(jbox.numbers, tq.top.charges, tq.top.excl_pairs,
                                            cutoff=CUTOFF)
        nl_j = JQ.NL.NeighborList(jnp.asarray(nl.idx.numpy()), jnp.asarray(nl.valid.numpy()), Pj,
                                  jnp.asarray(False))
        ep_j, fp_j = jax.jit(lambda p: JPOL.polarization_energy_forces(
            pol, p, nl_j, jnp.asarray(tbox.cell, jnp.float32)))(Pj)
        e_j, f_j, ep_j, fp_j = float(e_j), np.asarray(f_j), float(ep_j), np.asarray(fp_j)
    assert f_j.dtype == np.float64
    assert float(e_t) == pytest.approx(e_j, rel=1e-8)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-7 * np.abs(f_j).max())
    assert abs(ep_j) > 1e-3
    assert float(e_p) == pytest.approx(ep_j, rel=1e-8)
    np.testing.assert_allclose(f_p.numpy(), fp_j, rtol=0, atol=1e-7 * np.abs(fp_j).max())


def test_dense_route_refuses_the_hybrid(box):
    """The dense pair route has no polarization term: the MM engine raises
    JAX's message (ai2bmd_tpu/physics/mm.py:547-551), and so does
    QMMMPotential.build on an explicit dense route."""
    _, tbox = box
    with pytest.raises(ValueError, match="dense path does not support the legacy polarization"):
        TQ.QMMMPotential.build(tbox, lambda P: (P.sum() * 0, torch.zeros_like(P)),
                               polarizable=True, pair_backend="dense", device="cpu")
    tq = TQ.QMMMPotential.build(tbox, lambda P: (P.sum() * 0, torch.zeros_like(P)),
                                polarizable=True, device="cpu")
    with pytest.raises(ValueError, match="dense path does not support the legacy polarization"):
        TMM.mm_energy_forces_dense(tq.mm_full, torch.as_tensor(tbox.positions).float())
    assert isinstance(tq.init_aux(torch.as_tensor(tbox.positions).float())[0],
                      TNL.NeighborList)
