"""The mesh of the port (``ai2bmd_torch.parallel``) against the JAX package's
(``ai2bmd_tpu.parallel``), on the CPU: the row padding and the bucketed row
order, the mesh arithmetic (plain, by strategy, over slices), and a world of
two gloo ranks (``parallel.launch``): the cap solve with all-reduced scalars
on split rows, ``ShardedPotential`` at 1 x 2 against JAX's on the same mesh
and against the lone path, and ``ReplicaEnsemble`` / ``SolvatedReplicaEnsemble``
over dp = 2 against their one-rank runs.  The world of four ranks, the CLI
and the dry run are in tests/test_torch_mesh.py.  Chignolin at JAX's 2 layers
x 16 (tests/test_parallel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
import torch_mesh_ranks as MR
from ai2bmd_torch import potentials as TP
from ai2bmd_torch.frag import hydrogen as THY
from ai2bmd_torch.frag import runtime as TRT
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.parallel import (ReplicaEnsemble, SolvatedReplicaEnsemble, bucket_shard_order,
                                   hybrid_layout, mesh_layout, strategy_shape)
from ai2bmd_torch.parallel.launch import launch
from ai2bmd_tpu.frag import runtime as JRT
from ai2bmd_tpu.frag.indexer import build_fragment_index as j_build_fragment_index
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.parallel import ShardedPotential as JShardedPotential
from ai2bmd_tpu.parallel import make_hybrid_mesh as j_make_hybrid_mesh
from ai2bmd_tpu.parallel import make_mesh as j_make_mesh
from ai2bmd_tpu.parallel import sharding as JS
from ai2bmd_tpu.parallel.device_strategy import mesh_for_strategy as j_mesh_for_strategy

FI_FIELDS = ("n_rows", "row_type", "row_prmtop", "row_natom", "row_z", "valid", "is_cap",
             "gather_idx", "cap_dir_idx", "cap_radius", "dip_row", "ace_rows", "ace_slots")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for every test here (see test_torch_qmmm.py's): under
    pytest-xdist the workers share the cores (each rank takes one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chig():
    """Both packages' fragment index of Chignolin and the JAX weights at
    JAX's TINY (numpy tree and the port's tensors)."""
    conftest.require_examples()
    prot, fi = MR.chig()
    jfi = j_build_fragment_index(prot.atoms)
    jparams = jax.tree.map(np.asarray, JV.init_params(jax.random.PRNGKey(0),
                                                      JV.ViSNetConfig(**MR.TINY)))
    return prot, fi, jfi, jparams, params_from_jax(jparams)


def _same_index(port, jax_fi):
    for k in FI_FIELDS:
        a, b = getattr(port, k), getattr(jax_fi, k)
        if isinstance(a, list):
            assert a == b, k
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)


def test_pad_rows_and_row_multiple_match_jax_and_leave_the_physics(chig):
    """_pad_rows(fi, 8) gives JAX's arrays; FragmentRuntime.build(row_multiple=8)
    pads the runtime's row and ACE-NME axes as JAX's does, and its E/F equal
    row_multiple=1's within 1e-5 (the port's twin of JAX's
    test_padded_rows_do_not_change_physics: the empty rows fall in no
    bucket, the dummy units are masked)."""
    prot, fi, jfi, _, params = chig
    _same_index(TRT._pad_rows(fi, 8), JRT._pad_rows(jfi, 8))
    rt1 = TRT.FragmentRuntime.build(fi, opt_iters=2, device="cpu")
    rt8 = TRT.FragmentRuntime.build(fi, opt_iters=2, device="cpu", row_multiple=8)
    jrt8 = JRT.FragmentRuntime.build(jfi, opt_iters=2, row_multiple=8)
    assert tuple(rt8.valid.shape) == tuple(jrt8.valid.shape) and rt8.valid.shape[0] % 8 == 0
    assert rt8.ace_rows.shape[0] == jrt8.ace_rows.shape[0] and rt8.ace_rows.shape[0] % 8 == 0
    np.testing.assert_array_equal(rt8.ace_valid.numpy() > 0, np.asarray(jrt8.ace_valid))
    np.testing.assert_array_equal(rt8.pad_pos.numpy(), np.asarray(jrt8.pad_pos))
    assert [b.width for b in rt8.dip_buckets] == [b[0] for b in jrt8.dip_buckets]
    cfg = TV.ViSNetConfig(**MR.TINY)
    P = torch.as_tensor(prot.positions, dtype=torch.float32)
    e1, f1 = TRT.fragment_energy_forces(params, rt1, P, cfg)
    e8, f8 = TRT.fragment_energy_forces(params, rt8, P, cfg)
    np.testing.assert_allclose(float(e8), float(e1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(f8.numpy(), f1.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_mp", [2, 4, 8])
def test_bucket_shard_order_matches_jax(chig, n_mp):
    """The permuted, padded rows and the (width, offset, rows) layout are
    JAX's; every rank's block holds the layout's rows of each bucket (or
    padding rows, natom 0)."""
    _, fi, jfi, _, _ = chig
    fi_p, layout = bucket_shard_order(fi, n_mp)
    jfi_p, jlayout = JS.bucket_shard_order(jfi, n_mp)
    assert layout == jlayout
    _same_index(fi_p, jfi_p)
    assert fi_p.n_rows % n_mp == 0
    r_loc = fi_p.n_rows // n_mp
    for d in range(n_mp):
        natom = fi_p.row_natom[d * r_loc:(d + 1) * r_loc]
        lo = -1
        for w, off, r in layout:
            part = natom[off:off + r]
            assert np.all(((part > lo) & (part <= w)) | (part == 0))
            lo = w


def test_an_empty_padded_row_gives_finite_zero_terms(chig):
    """A padded row (natom 0: every slot invalid, parked 200 A apart) through
    ViSNet's plain versions: finite energy, zero forces, so the selection of
    row_has_atoms leaves E as it was."""
    _, fi, _, _, params = chig
    fi_p, layout = bucket_shard_order(fi, 4)
    rt = TRT.FragmentRuntime.build(fi_p, device="cpu")
    empty = np.flatnonzero(fi_p.row_natom == 0)
    assert len(empty) == 2 and layout[0][0] == 24
    w = layout[0][0]
    pos = rt.pad_pos[empty][:, :w]
    e, f = TV.energy_and_forces(params, torch.as_tensor(fi_p.row_z[empty][:, :w]), pos,
                                rt.valid[empty][:, :w], TV.ViSNetConfig(**MR.TINY))
    assert torch.isfinite(e).all() and torch.equal(f, torch.zeros_like(f))


def test_make_mesh_arithmetic_matches_jax():
    """Rank dp * n_mp + mp at (dp, mp), as JAX lays its devices; n_mp None
    takes every rank left; a shape that does not match raises JAX's message."""
    devices = jax.devices()
    for n_dp, n_mp in ((1, 8), (2, 4), (4, 2), (8, 1), (2, None)):
        ids = np.vectorize(lambda d: d.id)(j_make_mesh(n_dp, n_mp).devices)
        np.testing.assert_array_equal(mesh_layout(n_dp, n_mp, len(devices)), ids)
    with pytest.raises(ValueError) as jerr:
        j_make_mesh(3, 2)
    with pytest.raises(ValueError, match="mesh 3x2 does not match 8 devices") as terr:
        mesh_layout(3, 2, 8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("strategy", ["excess-compute", "small-molecule", "large-molecule"])
def test_strategy_shapes_match_jax(strategy):
    """mesh_for_strategy's (dp, mp) shapes are JAX's at 1, 2, 4 and 8 ranks
    (large-molecule with and without a fragment count)."""
    devices = jax.devices()
    for n in (1, 2, 4, 8):
        for n_fragments in ((None, 3, 5) if strategy == "large-molecule" else (None,)):
            want = j_mesh_for_strategy(strategy, n_fragments, devices[:n]).shape
            assert strategy_shape(strategy, n, n_fragments) == (want["dp"], want["mp"])
    with pytest.raises(ValueError, match="unknown device strategy"):
        strategy_shape("gpu-heavy", 2)


@pytest.mark.parametrize("n_slices,n_dp,n_mp", [(2, 2, 4), (2, 4, 2), (4, 4, 2), (2, 8, 1)])
def test_hybrid_layout_matches_jax(n_slices, n_dp, n_mp):
    """tests/test_multislice.py's cases on 8 ranks of one host: the ranks
    of JAX's device ids, every mp row inside one emulated slice."""
    layout, slices = hybrid_layout(n_dp, n_mp, {0: list(range(8))}, n_slices=n_slices)
    ids = np.vectorize(lambda d: d.id)(j_make_hybrid_mesh(n_dp, n_mp, n_slices=n_slices).devices)
    np.testing.assert_array_equal(layout, ids)
    assert len(slices) == n_slices


def test_hybrid_layout_over_hosts_and_its_refusals():
    """Two hosts of 4 ranks are the slices (the hostnames say so, whatever
    their rank order); mp never leaves a host; JAX's refusals
    (tests/test_multislice.py:58-66)."""
    from ai2bmd_torch.parallel import assert_mp_slice_local
    from ai2bmd_torch.parallel.multislice import group_by_host

    hosts = group_by_host(["a", "b", "a", "b", "a", "b", "a", "b"])
    assert hosts == {0: [0, 2, 4, 6], 1: [1, 3, 5, 7]}
    layout, _ = hybrid_layout(4, 2, hosts)
    np.testing.assert_array_equal(layout, [[0, 2], [4, 6], [1, 3], [5, 7]])
    with pytest.raises(ValueError, match="requested 4 slices but hardware has 2"):
        hybrid_layout(4, 2, hosts, n_slices=4)
    with pytest.raises(ValueError, match="exceeds the 4-device slice"):
        hybrid_layout(2, 8, {0: list(range(8))}, n_slices=2)
    with pytest.raises(ValueError, match="does not divide over 2 slices"):
        hybrid_layout(3, 2, {0: list(range(8))}, n_slices=2)
    with pytest.raises(ValueError, match="per-slice mesh 1x2 != 4 devices"):
        hybrid_layout(2, 2, {0: list(range(8))}, n_slices=2)
    with pytest.raises(AssertionError, match="spans slices"):
        assert_mp_slice_local(np.array([[0, 1], [2, 3]]), {0: [0, 2], 1: [1, 3]})


@pytest.fixture(scope="module")
def world_of_two(chig):
    """One world of two gloo ranks (torch_mesh_ranks.world_of_two), started
    once; both ranks' results."""
    conftest.require_examples()
    return launch(MR.world_of_two, 2, "cpu", args=(chig[3],), timeout_s=MR.WORLD_S)


def test_cap_solve_with_all_reduced_scalars_equals_the_joint_solve(chig, world_of_two):
    """10 L-BFGS iterations of Chignolin's perturbed cap rows, split over two
    ranks with every scalar all-reduced, against the joint solve on one:
    within 1e-6 A (the sums' order differs), the same on both ranks."""
    _, fi, _, _, _ = chig
    rt = TRT.FragmentRuntime.build(fi, device="cpu", row_multiple=2)
    prot, _ = MR.chig()
    joint = THY.optimize_caps(rt.ht, MR.perturbed_rows(rt, prot), n_iter=10)
    for out in world_of_two:
        np.testing.assert_allclose(out["caps_split"], joint.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(world_of_two[0]["caps_split"], world_of_two[1]["caps_split"])


def test_sharded_potential_1x2_matches_jax_and_the_lone_path(chig, world_of_two):
    """ShardedPotential.energy_forces on a 1 x 2 mesh (cold caps, 2 L-BFGS
    iterations) against JAX's ShardedPotential on the same mesh and the
    port's lone FragmentPotential: within 1e-4 eV and eV/A, JAX's own bar
    (tests/test_parallel.py:58-81); bitwise the same on both ranks."""
    prot, fi, jfi, jparams, params = chig
    jsp = JShardedPotential.build(prot, jfi, jax.tree.map(jnp.asarray, jparams),
                                  JV.ViSNetConfig(**MR.TINY),
                                  j_make_mesh(1, 2, jax.devices()[:2]), opt_iters=MR.OPT_ITERS)
    je, jf = jsp.energy_forces(jnp.asarray(prot.positions, jnp.float32))
    cfg = TV.ViSNetConfig(**MR.TINY)
    lone = TP.FragmentPotential.build(prot, TV.ViSNet(cfg, params), cfg, opt_iters=MR.OPT_ITERS,
                                      device="cpu")
    le, lf = lone.energy_forces(torch.as_tensor(prot.positions, dtype=torch.float32))
    for out in world_of_two:
        for e, f in ((float(je), np.asarray(jf)), (float(le), lf.numpy())):
            np.testing.assert_allclose(float(out["sp_e"]), e, atol=1e-4)
            np.testing.assert_allclose(out["sp_f"], f, atol=1e-4)
    np.testing.assert_array_equal(world_of_two[0]["sp_f"], world_of_two[1]["sp_f"])


def test_replica_ensemble_over_dp_equals_the_one_card_ensemble(chig, world_of_two):
    """ReplicaEnsemble over dp = 2 (two replicas a rank, chunks of 2) against
    the same ensemble on one rank with chunks of 2: every replica's state
    and cap offsets after 3 steps bitwise equal."""
    prot, fi, _, _, params = chig
    ens = ReplicaEnsemble.build(prot, fi, params, TV.ViSNetConfig(**MR.TINY), MR.N_REPLICAS,
                                steps_per_call=MR.STEPS, replica_chunk=2, device="cpu")
    state = ens.run(ens.initial_state(prot.positions, seed=MR.SEED, opt_iters=MR.OPT_ITERS), 1)
    got = world_of_two[0]["replica"]
    for k in ("positions", "velocities", "forces", "energy", "aux"):
        np.testing.assert_array_equal(got[k], getattr(state, k).numpy(), err_msg=k)
    assert not np.array_equal(got["positions"][0], got["positions"][1])


def test_solvated_ensemble_over_dp_equals_its_one_card_run(chig, world_of_two):
    """SolvatedReplicaEnsemble over dp = 2 (one replica a rank) on the
    251-atom box of tests/test_torch_solvated_ensemble.py, 2 steps: each
    replica bitwise its one-rank run's."""
    _, _, _, _, params = chig
    box = MR.solvated_box()
    ens = SolvatedReplicaEnsemble.build(box, params, TV.ViSNetConfig(**MR.TINY), n_replicas=2,
                                        steps_per_call=2, device="cpu")
    state = ens.run(ens.initial_state(box.positions, seed=1), 1)
    got = world_of_two[0]["solvated"]
    assert world_of_two[0]["solvated_step"] == 2
    for k in ("positions", "velocities", "forces"):
        np.testing.assert_array_equal(got[k], getattr(state, k).numpy(), err_msg=k)
    assert np.abs(got["positions"][0] - got["positions"][1]).max() > 1e-5



def test_ranks_import_neither_jax_nor_the_jax_package(world_of_two):
    """A spawned rank imports its function's module afresh: the ranks of a
    world started from this JAX-importing test process hold neither."""
    assert [out["imports"] for out in world_of_two] == [[], []]


def test_mesh_entry_points_default_to_the_card(chig, monkeypatch):
    """ShardedPotential.build and EnsembleSimulation.build take the card when
    given no device, and raise without one; a mesh whose dp does not divide
    the replicas raises JAX's message first."""
    from types import SimpleNamespace

    from ai2bmd_torch.parallel import EnsembleSimulation, ShardedPotential

    prot, fi, _, _, params = chig
    cfg = TV.ViSNetConfig(**MR.TINY)
    mesh = SimpleNamespace(size=lambda dim: (1, 1)[dim], get_local_rank=lambda dim: 0,
                           get_group=lambda dim: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedPotential.build(prot, fi, params, cfg, mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnsembleSimulation.build(prot, fi, params, cfg, mesh, n_replicas=2)
    with pytest.raises(ValueError, match="3 replicas do not shard over dp=2"):
        EnsembleSimulation.build(prot, fi, params, cfg,
                                 SimpleNamespace(size=lambda dim: (2, 1)[dim]), n_replicas=3)
