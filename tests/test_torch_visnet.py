"""Port parity: ViSNet and the ViS-MP edge core (ai2bmd_torch vs ai2bmd_tpu).

The same inputs, made with numpy from a seed, go through both packages on
the CPU in float32.  The JAX side is the pure-jnp path (fused=False) and, for
the edge core, the Pallas kernels in interpret mode as
tests/test_pallas_vismp.py runs them.  The port side is its plain PyTorch
path, and FusedVisMP (kernels' plain versions) for the backward, on both
of its routes: the stash (K2/K3) and recompute (K7/K8, ``remat``) routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu.frag.indexer import build_fragment_index
from ai2bmd_tpu.frag.runtime import FragmentRuntime, build_row_positions
from ai2bmd_tpu.io.pdb import read_pdb
from ai2bmd_tpu.io.reorder import normalize_atom_order
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.ops.pallas import vismp as JK
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import flatten, init_params, params_from_jax
from ai2bmd_torch.ops import vismp as TK

SMALL = dict(hidden_channels=32, num_heads=4, num_layers=3, num_rbf=8, max_z=20)
T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def models():
    jcfg = JV.ViSNetConfig(**SMALL)
    jparams = JV.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, TV.ViSNetConfig(**SMALL), tparams


@pytest.fixture(scope="module")
def chig_batches():
    """Chignolin's real fragment batches: the three dipeptide size buckets
    (2x24, 4x32, 4x40) and the ACE-NME batch (9x16), caps placed."""
    conftest.require_examples()
    atoms = normalize_atom_order(read_pdb(conftest.example_pdb("chig")))
    rt = FragmentRuntime.build(build_fragment_index(atoms))
    pos = np.asarray(build_row_positions(rt, jnp.asarray(atoms.positions, jnp.float32)))
    out = [(np.asarray(z), pos[np.asarray(idx), :w], np.asarray(valid))
           for w, idx, z, valid, _, _ in rt.dip_buckets]
    ace = np.pad(pos[np.asarray(rt.ace_rows), np.asarray(rt.ace_slots)], ((0, 0), (0, 4), (0, 0)))
    mask16 = np.asarray(rt.ace_mask16)
    out.append((np.asarray(rt.ace_z16), np.where(mask16[..., None], ace, np.asarray(rt.ace_park)),
                mask16))
    return out


@pytest.mark.parametrize("batch", range(4), ids=["dip24", "dip32", "dip40", "ace16"])
def test_energy_and_forces_match_jax(models, chig_batches, batch):
    """E and F of one fragment batch.  Tolerance 1e-4 eV and eV/A: float32
    rounding of three layers summed in another order (observed ~1e-6)."""
    jcfg, jparams, tcfg, tparams = models
    z, pos, mask = chig_batches[batch]
    e_j, f_j = jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, jcfg))(
        jparams, z, pos, mask)
    e_t, f_t = TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask), tcfg)
    assert f_t.shape == (len(z), z.shape[1], 3)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


def test_module_round_trip(models, chig_batches):
    """The nn.Module holds the same tree and gives the same energies."""
    _, _, tcfg, tparams = models
    module = TV.ViSNet(tcfg, tparams)
    for (pa, a), (pb, b) in zip(flatten(module.params()), flatten(tparams)):
        assert pa == pb and torch.equal(a, b)
    z, pos, mask = chig_batches[0]
    e_fn = TV.energy(tparams, T(z).long(), T(pos), T(mask), tcfg)
    assert torch.equal(module(T(z).long(), T(pos), T(mask)), e_fn)


def test_init_params_layout_matches_jax(models):
    """Same tree, shapes and dtypes as the JAX initializer; xavier bounds."""
    jcfg, jparams, tcfg, _ = models
    mine = init_params(tcfg, torch.Generator().manual_seed(0))
    key = lambda leaf: tuple(map(str, leaf[0]))
    ref = sorted(flatten(params_from_jax(jax.tree.map(np.asarray, jparams))), key=key)
    got = sorted(flatten(mine), key=key)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    w = mine["layers"][0]["s_proj"]["w"]
    assert float(w.abs().max()) <= (6.0 / (32 + 64)) ** 0.5
    # linspace rounds the last bit differently in the two libraries
    np.testing.assert_allclose(mine["rbf"]["means"].numpy(), np.asarray(jparams["rbf"]["means"]),
                               rtol=1e-6)


def _edge_inputs(rng, B=2, A=24, H=32, S=8):
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    pos = (rng.random((B, A, 3)) * 6).astype(np.float32)
    vecp = pos[:, None, :, :] - pos[:, :, None, :]
    dist = np.sqrt((vecp ** 2).sum(-1) + 1e-12).astype(np.float32)
    return dict(
        q=f(B, A, H), k=f(B, A, H), v=f(B, A, H), vec=f(B, A, S, H),
        wt=f(B, A, S, H), wsrc=f(B, A, S, H), edge=f(B, A, A, H), d_sh=f(B, A, A, S),
        dist=dist, adj=(dist < 5.0).astype(np.float32),
        w_dkv=f(H, 2 * H) * 0.2, b_dkv=f(2 * H) * 0.1, w_s=f(H, 2 * H) * 0.2,
        b_s=f(2 * H) * 0.1, w_f=f(H, H) * 0.2, b_f=f(H) * 0.1,
    )


# Tolerance for comparisons with the Pallas kernels: their default in-kernel
# products use a 3-pass bf16 split (vismp.py:43-97), ~2^-16 relative per
# product, against full float32 in the port.
PALLAS_TOL = 2e-4


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, float(np.abs(b).max())))


# (B, A, H, heads): a fragment batch, and one molecule of 64 slots, past the
# 48 of a fragment, where the card's edge kernels walk the sources in chunks
FRAGMENT, PAST_48 = (2, 24, 32, 4), (1, 64, 64, 2)


@pytest.mark.parametrize("last, shape", [(False, FRAGMENT), (True, FRAGMENT),
                                         (False, PAST_48), (True, PAST_48)],
                         ids=["update", "last", "update-A64", "last-A64"])
def test_edge_core_and_vjp_match_pallas(rng, last, shape):
    """Plain edge core (K1's plain version) and FusedVisMP's backward (K2/K3's
    plain versions) against fused_vis_mp in interpret mode, values and VJP."""
    B, A, H, nh = shape
    a = _edge_inputs(rng, B=B, A=A, H=H)
    cutoff = 5.0
    names = (["q", "k", "v", "vec", "edge", "d_sh", "dist", "adj", "w_dkv", "b_dkv", "w_s", "b_s"]
             if last else
             ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist", "adj",
              "w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"])
    core = JK.fused_vis_mp(cutoff, nh, last, interpret=True)
    outs_j, vjp = jax.vjp(core, *[jnp.asarray(a[n]) for n in names])
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs_j]
    grads_j = dict(zip(names, vjp(tuple(jnp.asarray(c) for c in cts))))

    diff = ["q", "k", "v", "vec", "edge", "d_sh", "dist"] + ([] if last else ["wt", "wsrc"])
    t = {n: T(a[n]).requires_grad_(n in diff) for n in a}
    upd = {} if last else dict(wt=t["wt"], wsrc=t["wsrc"], w_f=t["w_f"], b_f=t["b_f"])
    x_agg, vec_agg, df = TK.edge_fwd_plain(
        t["q"], t["k"], t["v"], t["vec"], t["edge"], t["d_sh"], t["dist"], t["adj"],
        t["w_dkv"], t["b_dkv"], t["w_s"], t["b_s"], cutoff, nh, **upd)[:3]
    for mine, ref in zip([x_agg, vec_agg] + ([] if last else [df]), outs_j):
        _close(mine.detach(), ref, PALLAS_TOL)

    fused_args = [t[n] if n in t else None for n in
                  ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist", "adj",
                   "w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"]]
    if last:
        fused_args[4] = fused_args[5] = fused_args[14] = fused_args[15] = None
    outs_t = TK.FusedVisMP.apply(*fused_args, cutoff, nh)
    for mine, ref in zip(outs_t, outs_j):
        _close(mine.detach(), ref, PALLAS_TOL)
    grads_t = torch.autograd.grad(outs_t, [t[n] for n in diff],
                                  grad_outputs=[T(c) for c in cts])
    for n, g in zip(diff, grads_t):
        _close(g, grads_j[n], PALLAS_TOL)


@pytest.mark.parametrize("recompute", [False, True], ids=["stash", "recompute"])
def test_fused_vjp_matches_plain_autograd(rng, recompute):
    """FusedVisMP's hand-written backward, on the stash route (K2/K3's plain
    versions) and the recompute route (K7/K8's), where K3/K8 add the update's
    edge gradient into the message path's in place, equals autograd through
    the plain forward (float64, so the comparison sees the math, not
    rounding)."""
    a = _edge_inputs(rng, B=2, A=16)
    nh, cutoff = 4, 5.0
    diff = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist"]
    t = {n: T(a[n]).double().requires_grad_(n in diff) for n in a}
    order = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist", "adj",
             "w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"]
    outs_f = TK.FusedVisMP.apply(*[t[n] for n in order], cutoff, nh, recompute)
    outs_p = TK.edge_fwd_plain(
        t["q"], t["k"], t["v"], t["vec"], t["edge"], t["d_sh"], t["dist"], t["adj"],
        t["w_dkv"], t["b_dkv"], t["w_s"], t["b_s"], cutoff, nh,
        t["wt"], t["wsrc"], t["w_f"], t["b_f"])[:3]
    cts = [torch.randn(o.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
           for o in outs_f]
    g_f = torch.autograd.grad(outs_f, [t[n] for n in diff], grad_outputs=cts)
    g_p = torch.autograd.grad(outs_p, [t[n] for n in diff], grad_outputs=cts)
    for n, x, y in zip(diff, g_f, g_p):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-10, err_msg=n)


def _sphere_major(x):
    """[B,A,S,H] -> [B,S,A,H] (and back: the same swap)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


def test_recompute_message_backward_matches_pallas(rng):
    """K7's plain version against the recompute-mode Pallas kernel
    ``_bwd_msg_call`` (vismp.py:987) in interpret mode, on the sphere-major
    layout it takes.  Tolerance PALLAS_TOL of the largest reference value."""
    _check_recompute_message_backward(rng, *FRAGMENT)


def test_recompute_message_backward_matches_pallas_past_48_slots(rng):
    """As test_recompute_message_backward_matches_pallas, at one molecule of
    64 slots."""
    _check_recompute_message_backward(rng, *PAST_48)


def _check_recompute_message_backward(rng, B, A, H, nh):
    a = _edge_inputs(rng, B=B, A=A, H=H)
    cutoff = 5.0
    S = a["vec"].shape[2]
    g_x = rng.standard_normal((B, A, H)).astype(np.float32)
    g_va = rng.standard_normal((B, A, S, H)).astype(np.float32)
    ref = JK._bwd_msg_call(
        *(jnp.asarray(x) for x in (a["q"], a["k"], a["v"], _sphere_major(a["vec"]), a["edge"],
                                   np.transpose(a["d_sh"], (0, 3, 1, 2)), a["dist"], a["adj"],
                                   a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], g_x,
                                   _sphere_major(g_va))),
        cutoff=cutoff, nh=nh, interpret=True)
    g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist = (np.asarray(r) for r in ref)
    ref = [g_q, g_k, g_v, _sphere_major(g_vec), g_edge, np.transpose(g_dsh, (0, 2, 3, 1)), g_dist]
    got = TK.edge_bwd_msg_rc_plain(
        *(T(a[n]) for n in ("q", "k", "v", "vec", "edge", "d_sh", "dist", "adj",
                            "w_dkv", "b_dkv", "w_s", "b_s")), T(g_x), T(g_va), cutoff, nh)
    for mine, r in zip(got, ref):
        _close(mine, r, PALLAS_TOL)


def test_recompute_update_backward_matches_pallas(rng):
    """K8's plain version against the recompute-mode Pallas kernel
    ``_bwd_upd_call`` (vismp.py:1060) in interpret mode."""
    _check_recompute_update_backward(rng, *FRAGMENT)


def test_recompute_update_backward_matches_pallas_past_48_slots(rng):
    """As test_recompute_update_backward_matches_pallas, at one molecule of
    64 slots."""
    _check_recompute_update_backward(rng, *PAST_48)


def _check_recompute_update_backward(rng, B, A, H, nh):
    a = _edge_inputs(rng, B=B, A=A, H=H)
    g_df = (rng.standard_normal(a["edge"].shape) * a["adj"][..., None]).astype(np.float32)
    ref = JK._bwd_upd_call(
        *(jnp.asarray(x) for x in (a["edge"], a["adj"], _sphere_major(a["wt"]),
                                   _sphere_major(a["wsrc"]), a["w_f"], a["b_f"], g_df)),
        interpret=True)
    g_edge, g_wt, g_wsrc = (np.asarray(r) for r in ref)
    got = TK.edge_bwd_upd_rc_plain(*(T(a[n]) for n in ("edge", "adj", "wt", "wsrc", "w_f", "b_f")),
                                   T(g_df))
    for mine, r in zip(got, [g_edge, _sphere_major(g_wt), _sphere_major(g_wsrc)]):
        _close(mine, r, PALLAS_TOL)


@pytest.mark.parametrize("last, df_only", [
    pytest.param(False, False, id="update"), pytest.param(True, False, id="last"),
    pytest.param(False, True, id="update-df-only")])
def test_recompute_route_matches_stash_route(rng, last, df_only):
    """FusedVisMP with recompute=True (K1 without a stash, K7/K8's plain
    versions) against recompute=False (K1's stash, K2/K3's plain versions),
    float64: the same outputs and input gradients to 1e-10.  ``df_only``
    gives x_agg and vec_agg a zero cotangent, so the edge gradient is the
    update's alone, summed by K3/K8 into the message path's zeros."""
    a = _edge_inputs(rng, B=2, A=16)
    nh, cutoff = 4, 5.0
    diff = ["q", "k", "v", "vec", "edge", "d_sh", "dist"] + ([] if last else ["wt", "wsrc"])
    t = {n: T(a[n]).double().requires_grad_(n in diff) for n in a}
    if last:
        for n in ("wt", "wsrc", "w_f", "b_f"):
            t[n] = None
    order = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist", "adj",
             "w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"]
    outs = {rc: TK.FusedVisMP.apply(*[t[n] for n in order], cutoff, nh, rc) for rc in (False, True)}
    gen = torch.Generator().manual_seed(1)
    cts = [torch.randn(o.shape, dtype=torch.float64, generator=gen) for o in outs[False]]
    if df_only:
        cts[0], cts[1] = torch.zeros_like(cts[0]), torch.zeros_like(cts[1])
    grads = {rc: torch.autograd.grad(outs[rc], [t[n] for n in diff], grad_outputs=cts)
             for rc in outs}
    for x, y in zip(outs[True], outs[False]):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=1e-10)
    for n, x, y in zip(diff, grads[True], grads[False]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-10, err_msg=n)


@pytest.mark.parametrize("rc", [False, True], ids=["K3", "K8"])
def test_update_backward_sums_into_the_given_g_edge(rng, rc):
    """The plain K3/K8 with the optional g_edge: the edge gradient is added
    into that tensor in place, and it equals the output without it plus the
    separate add that FusedVisMP's backward used to make, bitwise."""
    a = {n: T(v) for n, v in _edge_inputs(rng, B=2, A=16).items()}
    g_df = torch.randn(a["edge"].shape, generator=torch.Generator().manual_seed(2))
    g0 = torch.randn(a["edge"].shape, generator=torch.Generator().manual_seed(3))
    if rc:
        call = lambda **kw: TK.edge_bwd_upd_rc(a["edge"], a["adj"], a["wt"], a["wsrc"], a["w_f"],
                                               a["b_f"], g_df, **kw)
    else:
        zf = a["edge"] @ a["w_f"] + a["b_f"]
        call = lambda **kw: TK.edge_bwd_upd(a["adj"], a["wt"], a["wsrc"], a["w_f"], zf, g_df, **kw)
    alone = call()
    buf = g0.clone()
    summed = call(g_edge=buf)
    assert summed[0] is buf
    assert torch.equal(summed[0], g0 + alone[0])
    for x, y in zip(summed[1:], alone[1:]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("weight", ["w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"])
def test_recompute_route_refuses_weight_gradients(rng, weight):
    """edge_core with recompute takes FusedVisMP, which gives the weights no
    gradient: a weight that needs one raises instead of losing it silently,
    while the plain route (recompute off, CPU) still differentiates it, and
    the recompute route runs where no gradient is recorded."""
    a = _edge_inputs(rng, B=2, A=16)
    t = {n: T(a[n]) for n in a}
    t[weight].requires_grad_(True)
    names = ["q", "k", "v", "vec", "edge", "d_sh", "dist", "adj",
             "w_dkv", "b_dkv", "w_s", "b_s"]
    upd = dict(wt=t["wt"], wsrc=t["wsrc"], w_f=t["w_f"], b_f=t["b_f"])
    call = lambda rc: TK.edge_core(*[t[n] for n in names], 5.0, 4, **upd, recompute=rc)
    with pytest.raises(ValueError, match="no gradient"):
        call(True)
    x_agg, vec_agg, df = call(False)
    (g,) = torch.autograd.grad(x_agg.sum() + vec_agg.sum() + df.sum(), [t[weight]])
    assert float(g.abs().max()) > 0
    with torch.no_grad():
        got = call(True)
    for x, y in zip(got, (x_agg, vec_agg, df)):
        np.testing.assert_allclose(x.numpy(), y.detach().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch", range(4), ids=["dip24", "dip32", "dip40", "ace16"])
def test_remat_energy_and_forces_match_jax(models, chig_batches, batch):
    """ViSNetConfig(remat=True) in both packages: the port's recompute route
    (FusedVisMP with K7/K8's plain versions) against JAX's jax.checkpoint
    of each layer.  Tolerance as test_energy_and_forces_match_jax."""
    jcfg, jparams, tcfg, tparams = models
    jcfg, tcfg = dataclasses.replace(jcfg, remat=True), dataclasses.replace(tcfg, remat=True)
    z, pos, mask = chig_batches[batch]
    e_j, f_j = jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, jcfg))(
        jparams, z, pos, mask)
    e_t, f_t = TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask), tcfg)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)
