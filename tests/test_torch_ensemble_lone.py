"""ReplicaEnsemble of the port against lone replicas of the port with the
same generators, on Chignolin with a small ViSNet (3 layers x 32, 4 heads),
float32, CPU; and its refusals.  Split from tests/test_torch_ensemble.py,
whose ``ens`` fixture it takes, so that pytest-xdist's --dist loadfile runs
the two files side by side."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import conftest
from ai2bmd_torch import potentials as TP
from ai2bmd_torch.md import langevin as TL
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.parallel import ReplicaEnsemble, replica_generators
from test_torch_ensemble import ens  # noqa: F401  (the module-scoped fixture)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("remat", [False, True], ids=["stash", "remat"])
def test_replica_ensemble_matches_lone_replicas(ens, chig_protein, remat):
    """ReplicaEnsemble of 2 replicas on the CPU against two lone
    langevin_step runs of FragmentPotential, each with the replica's own
    generator: the same cold-then-warm start and 3 steps.  Tolerance 1e-5 A
    (only the cap L-BFGS inner products are summed in another order)."""
    cfg = dataclasses.replace(ens["tcfg"], remat=remat)
    e = ReplicaEnsemble.build(chig_protein, ens["fi"], ens["tparams"], cfg, n_replicas=2,
                              steps_per_call=3, replica_chunk=1, device="cpu")
    s = e.run(e.initial_state(chig_protein.positions, seed=11), 1)
    assert s.step == 3 and s.positions.shape == (2, len(chig_protein), 3)
    assert not torch.equal(s.positions[0], s.positions[1])

    pot = TP.FragmentPotential.build(chig_protein, TV.ViSNet(cfg, ens["tparams"]), cfg,
                                     device="cpu")
    P = torch.as_tensor(chig_protein.positions, dtype=torch.float32)
    m = torch.as_tensor(chig_protein.masses, dtype=torch.float32)
    coeffs = TL.LangevinCoeffs.build(chig_protein.masses, 1.0, 300.0, 0.001, device="cpu")
    for r, g in enumerate(replica_generators(11, 2, "cpu")):
        v = TL.maxwell_boltzmann_velocities(g, chig_protein.masses, 300.0)
        e0, f0, aux = pot.stateful_energy_forces(P, pot.init_cap_delta(P))
        lone = TL.MDState(P, v, f0, e0, aux=aux)
        for _ in range(3):
            lone = TL.langevin_step(pot.stateful_energy_forces, coeffs, m, lone, generator=g)
        np.testing.assert_allclose(s.positions[r].numpy(), lone.positions.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(s.forces[r].numpy(), lone.forces.numpy(), rtol=0, atol=1e-4)


def test_replica_ensemble_refuses_a_mesh_and_a_missing_card(ens, chig_protein, monkeypatch):
    """A mesh whose dp axis does not divide the replicas is refused with
    JAX's message (sharding.py:408-411; a mesh that does is taken,
    tests/test_torch_parallel.py), and without device= the ensemble takes
    the card, raising without one."""
    conftest.require_examples()
    with pytest.raises(ValueError, match="3 replicas do not shard over dp=2"):
        ReplicaEnsemble.build(chig_protein, ens["fi"], ens["tparams"], ens["tcfg"], n_replicas=3,
                              device="cpu", mesh=SimpleNamespace(size=lambda dim: (2, 1)[dim]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaEnsemble.build(chig_protein, ens["fi"], ens["tparams"], ens["tcfg"], n_replicas=2)
    e = ReplicaEnsemble.build(chig_protein, ens["fi"], ens["tparams"], ens["tcfg"], n_replicas=2,
                              device="cpu")
    with pytest.raises(ValueError, match="initial_state"):
        e.run(None, 1)
