"""Port parity at the edge kernels' wide shapes (ai2bmd_torch vs ai2bmd_tpu).

The edge kernels K1-K3, K7 and K8 take every H whose head count divides it,
as JAX's kernels do: heads of 8, 16, 32 or 64 channels with H a multiple of
32 up to 256 in their narrow instantiations, every other shape in their
wide ones (``ops/vismp.narrow_shapes``).  On the CPU the wrappers run their plain
versions, which are shape-generic; these tests hold them, at wide shapes
(heads of 24 and 160 channels, H = 48 and 320), against the JAX package's
Pallas kernels in interpret mode, and the whole model against its jnp path
(tests/test_torch_past_1024.py does so past 1,024 channels).
The same inputs, made with numpy from a seed, go through both packages in
float32.  They also hold the routing: on the card a wide silu model takes
the edge kernels, or the full-layer kernels K5/K6 when it asks for them
(tests/test_torch_wide_layer.py holds their plain versions at wide shapes).
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
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import vismp as TK

T = lambda a: torch.as_tensor(np.array(a))
# the Pallas kernels' default in-kernel products are a 3-pass bf16 split,
# ~2^-16 relative per product, against full float32 in the port (as
# tests/test_torch_visnet.py)
PALLAS_TOL = 2e-4
# (B, A, H, heads): two heads of 24 channels (H not a multiple of 32), and
# two of 160 (H past 256)
H48, H320 = (2, 16, 48, 2), (1, 8, 320, 2)
QUEUE_2 = "ROADMAP.md, Queue 2"


def _edge_inputs(rng, B, A, H, S=8):
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


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, float(np.abs(b).max())))


def _sphere_major(x):
    """[B,A,S,H] -> [B,S,A,H] (and back: the same swap)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


@pytest.mark.parametrize("shape", [H48, H320], ids=["H48-dh24", "H320-dh160"])
def test_edge_core_and_vjp_match_pallas_at_wide_heads(rng, shape):
    """K1's plain version and FusedVisMP's backward (K2/K3's plain versions)
    against fused_vis_mp in interpret mode, values and VJP, with the edge
    update (layers 1-8)."""
    check_edge_core(rng, shape)


def check_edge_core(rng, shape):
    """The body of test_edge_core_and_vjp_match_pallas_at_wide_heads at
    ``shape`` = (B, A, H, heads); tests/test_torch_past_1024.py runs it past
    1,024 channels."""
    B, A, H, nh = shape
    assert not TK.narrow_shapes(H, nh)
    a = _edge_inputs(rng, B, A, H)
    cutoff = 5.0
    names = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist", "adj",
             "w_dkv", "b_dkv", "w_s", "b_s", "w_f", "b_f"]
    core = JK.fused_vis_mp(cutoff, nh, False, interpret=True)
    outs_j, vjp = jax.vjp(core, *[jnp.asarray(a[n]) for n in names])
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs_j]
    grads_j = dict(zip(names, vjp(tuple(jnp.asarray(c) for c in cts))))

    diff = ["q", "k", "v", "vec", "edge", "d_sh", "dist", "wt", "wsrc"]
    t = {n: T(a[n]).requires_grad_(n in diff) for n in a}
    plain = TK.edge_fwd_plain(
        t["q"], t["k"], t["v"], t["vec"], t["edge"], t["d_sh"], t["dist"], t["adj"],
        t["w_dkv"], t["b_dkv"], t["w_s"], t["b_s"], cutoff, nh,
        wt=t["wt"], wsrc=t["wsrc"], w_f=t["w_f"], b_f=t["b_f"])[:3]
    for mine, ref in zip(plain, outs_j):
        _close(mine.detach(), ref, PALLAS_TOL)
    outs_t = TK.FusedVisMP.apply(*[t[n] for n in names], cutoff, nh)
    for mine, ref in zip(outs_t, outs_j):
        _close(mine.detach(), ref, PALLAS_TOL)
    grads_t = torch.autograd.grad(outs_t, [t[n] for n in diff], grad_outputs=[T(c) for c in cts])
    for n, g in zip(diff, grads_t):
        _close(g, grads_j[n], PALLAS_TOL)


def test_recompute_backward_matches_pallas_at_wide_heads(rng):
    """K7's and K8's plain versions against the recompute-mode Pallas
    kernels ``_bwd_msg_call`` and ``_bwd_upd_call`` in interpret mode, on
    the sphere-major layout they take, at H = 320 with two heads of 160."""
    check_recompute(rng, H320)


def check_recompute(rng, shape):
    """The body of test_recompute_backward_matches_pallas_at_wide_heads at
    ``shape`` = (B, A, H, heads)."""
    B, A, H, nh = shape
    a = _edge_inputs(rng, B, A, H)
    cutoff, S = 5.0, a["vec"].shape[2]
    g_x = rng.standard_normal((B, A, H)).astype(np.float32)
    g_va = rng.standard_normal((B, A, S, H)).astype(np.float32)
    ref = JK._bwd_msg_call(
        *(jnp.asarray(x) for x in (a["q"], a["k"], a["v"], _sphere_major(a["vec"]), a["edge"],
                                   np.transpose(a["d_sh"], (0, 3, 1, 2)), a["dist"], a["adj"],
                                   a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], g_x,
                                   _sphere_major(g_va))),
        cutoff=cutoff, nh=nh, interpret=True)
    g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist = (np.asarray(r) for r in ref)
    got = TK.edge_bwd_msg_rc_plain(
        *(T(a[n]) for n in ("q", "k", "v", "vec", "edge", "d_sh", "dist", "adj",
                            "w_dkv", "b_dkv", "w_s", "b_s")), T(g_x), T(g_va), cutoff, nh)
    for mine, r in zip(got, [g_q, g_k, g_v, _sphere_major(g_vec), g_edge,
                             np.transpose(g_dsh, (0, 2, 3, 1)), g_dist]):
        _close(mine, r, PALLAS_TOL)

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


WIDE_MODEL = dict(hidden_channels=48, num_heads=2, num_layers=2, num_rbf=8, max_z=20)


@pytest.fixture(scope="module")
def wide_models():
    jcfg = JV.ViSNetConfig(**WIDE_MODEL)
    jparams = JV.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, TV.ViSNetConfig(**WIDE_MODEL), tparams


@pytest.fixture(scope="module")
def chig_batches():
    """Two of Chignolin's real fragment batches, caps placed: the 4 x 40
    dipeptide bucket and the 9 x 16 ACE-NME batch."""
    conftest.require_examples()
    atoms = normalize_atom_order(read_pdb(conftest.example_pdb("chig")))
    rt = FragmentRuntime.build(build_fragment_index(atoms))
    pos = np.asarray(build_row_positions(rt, jnp.asarray(atoms.positions, jnp.float32)))
    w, idx, z, valid, _, _ = rt.dip_buckets[-1]
    ace = np.pad(pos[np.asarray(rt.ace_rows), np.asarray(rt.ace_slots)], ((0, 0), (0, 4), (0, 0)))
    mask16 = np.asarray(rt.ace_mask16)
    return [(np.asarray(z), pos[np.asarray(idx), :w], np.asarray(valid)),
            (np.asarray(rt.ace_z16), np.where(mask16[..., None], ace, np.asarray(rt.ace_park)),
             mask16)]


@pytest.mark.parametrize("batch", range(2), ids=["dip40", "ace16"])
def test_wide_model_energy_and_forces_match_jax(wide_models, chig_batches, batch):
    """E and F of a 2-layer model of 48 channels with two heads of 24, on
    one fragment batch, against the JAX package's jnp path within 1e-4 eV
    and eV/A: the port's plain path, and its remat route (FusedVisMP
    through K1 without a stash and K7/K8's plain versions)."""
    jcfg, jparams, tcfg, tparams = wide_models
    z, pos, mask = chig_batches[batch]
    e_j, f_j = jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, jcfg))(
        jparams, z, pos, mask)
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=True)):
        e_t, f_t = TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask), cfg)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("H, nh", [(256, 2), (256, 1), (384, 8), (512, 4), (48, 2), (40, 5),
                                   (1024, 8), (1280, 8), (2048, 16), (4096, 16), (8192, 32)],
                         ids=["dh128", "dh256", "H384", "H512-dh128", "H48-dh24", "H40-dh8",
                              "H1024", "H1280-dh160", "H2048-dh128", "H4096-dh256",
                              "H8192-dh256"])
def test_wide_silu_models_route_to_the_edge_kernels(monkeypatch, H, nh):
    """On the card a silu model at a wide shape resolves to the edge kernels
    K1-K3 (neither the plain edge core nor K5/K6), which check_shapes takes
    at a fragment and a whole molecule; asking for the full-layer kernels,
    by fused_layer or AI2BMD_FUSED_LAYER=1, takes K5/K6's wide
    instantiations, which check_layer_shapes takes there too."""
    monkeypatch.delenv("AI2BMD_FUSED_LAYER", raising=False)
    cfg = TV.ViSNetConfig(hidden_channels=H, num_heads=nh)
    got = TV.resolve_config(cfg, "cuda")
    assert got == cfg and not got.plain_edge_core and not got.fused_layer
    for A in (40, 752, 1112):
        TK.check_shapes(A, H, cfg.n_sphere, nh)
        TK.check_layer_shapes(A, H, cfg.n_sphere, nh)
    fused = dataclasses.replace(cfg, fused_layer=True)
    assert TV.resolve_config(fused, "cuda") is fused
    monkeypatch.setenv("AI2BMD_FUSED_LAYER", "1")
    assert TV.resolve_config(cfg, "cuda") == fused
    assert TV.resolve_config(cfg, "cpu") is cfg


def test_what_the_edge_kernels_still_refuse(monkeypatch):
    """lmax 3 (S = 15), which no model of either package builds, and a head
    count that does not divide H raise, in the edge and the full-layer
    kernels' checks alike, with AI2BMD_FUSED_LAYER=1 too; H past 1024
    (1,280 with 8 heads) is taken on either path; a narrow model with
    AI2BMD_FUSED_LAYER=1 still takes K5/K6."""
    monkeypatch.delenv("AI2BMD_FUSED_LAYER", raising=False)
    with pytest.raises(ValueError, match="no model of either package builds S > 8"):
        TV.resolve_config(TV.ViSNetConfig(lmax=3), "cuda")
    for check in (TK.check_shapes, TK.check_layer_shapes):
        with pytest.raises(ValueError, match=QUEUE_2):
            check(40, 256, 15, 8)
        with pytest.raises(ValueError, match=QUEUE_2):
            check(40, 48, 8, 5)
        check(40, 1280, 8, 8)
    cfg = TV.ViSNetConfig(hidden_channels=1280, num_heads=8)
    assert TV.resolve_config(cfg, "cuda") is cfg
    fused = dataclasses.replace(cfg, fused_layer=True)
    assert TV.resolve_config(fused, "cuda") is fused
    with pytest.raises(ValueError, match="not a multiple of num_heads"):
        TV.resolve_config(TV.ViSNetConfig(hidden_channels=48, num_heads=5), "cuda")
    monkeypatch.setenv("AI2BMD_FUSED_LAYER", "1")
    assert TV.resolve_config(TV.ViSNetConfig(), "cuda").fused_layer
    assert TV.resolve_config(cfg, "cuda") == fused


@pytest.mark.parametrize("H, nh, msg, upd, remat, label", [
    (256, 8, True, True, False, ""),
    (256, 2, False, True, False, " (wide instantiations: K1, K2)"),
    (256, 1, False, True, True, " (wide instantiations: K1, K7)"),
    (512, 4, False, False, False, " (wide instantiations: K1, K2, K3)"),
    (48, 2, False, False, True, " (wide instantiations: K1, K7, K8)"),
    (1280, 8, False, False, False, " (wide instantiations: K1, K2, K3)"),
    (2048, 16, False, False, True, " (wide instantiations: K1, K7, K8)"),
    (4096, 16, False, False, False, " (wide instantiations: K1, K2, K3)"),
    (8192, 32, False, False, True, " (wide instantiations: K1, K7, K8)"),
], ids=["H256-dh32", "dh128", "dh256-remat", "H512-dh128", "H48-dh24-remat", "H1280-dh160",
        "H2048-dh128-remat", "H4096-dh256", "H8192-dh256-remat"])
def test_each_kernel_family_picks_its_instantiation(H, nh, msg, upd, remat, label):
    """K1, K2, K7, K5 and K6 sum heads and pick by (H, heads)
    (``narrow_shapes``); K3 and K8 sum none and pick by H
    (``narrow_update``), as the launchers in csrc/common.cuh and
    csrc/vislayer.cuh do; K5/K6 take the edge kernels' domain
    (``layer_shapes``, S <= 8).  The CLI's model line names the kernels
    that run wide."""
    from ai2bmd_torch.cli import _model_line

    assert TK.narrow_shapes(H, nh) is msg and TK.narrow_update(H) is upd
    assert TK.layer_shapes(H, nh, 8) and not TK.layer_shapes(H, nh, 15)
    cfg = TV.ViSNetConfig(hidden_channels=H, num_heads=nh, remat=remat)
    path = "edge-core kernels K1, K7/K8 (remat)" if remat else "edge-core kernels K1-K3"
    assert _model_line(cfg, torch.device("cuda")) == f"ViSNet 9 x {H}, {nh} heads: {path}{label}"
    fused = "" if msg else " (wide instantiations: K5, K6)"
    assert _model_line(dataclasses.replace(cfg, fused_layer=True), torch.device("cuda")) == \
        f"ViSNet 9 x {H}, {nh} heads: full-layer kernels K5/K6{fused}"


def test_wide_weights_are_padded_once_per_model(rng):
    """At H % 32 != 0 a layer's W_dkv, W_s and W_f are zero-padded to
    wide_width(H) a half once, and the same tensors come back while the
    weights are unchanged; an in-place change or a new tensor pads again."""
    H = 48
    Hp = TK.wide_width(H)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    lp = {k: {"w": f(H, n * H)} for k, n in (("dk_proj", 1), ("dv_proj", 1), ("s_proj", 2),
                                              ("f_proj", 1))}
    w_dkv, w_s, w_f = TV._padded_edge_weights(lp, H, last=False)
    assert (w_dkv.shape, w_s.shape, w_f.shape) == ((Hp, 2 * Hp), (Hp, 2 * Hp), (Hp, Hp))
    dkv = torch.cat([lp["dk_proj"]["w"], lp["dv_proj"]["w"]], dim=1)
    for got, w, halves in ((w_dkv, dkv, 2), (w_s, lp["s_proj"]["w"], 2),
                           (w_f, lp["f_proj"]["w"], 1)):
        got = got.view(Hp, halves, Hp)
        assert torch.equal(got[:H, :, :H], w.view(H, halves, H))
        assert not got[H:].any() and not got[:, :, H:].any()
    again = TV._padded_edge_weights(lp, H, last=False)
    assert all(a is b for a, b in zip(again, (w_dkv, w_s, w_f)))
    lp["dk_proj"]["w"].mul_(2.0)
    redone = TV._padded_edge_weights(lp, H, last=False)
    assert redone[0] is not w_dkv and torch.equal(redone[0][:H, :H], 2 * w_dkv[:H, :H])
    lp["f_proj"]["w"] = f(H, H)
    assert TV._padded_edge_weights(lp, H, last=False)[2] is not w_f
    assert TV._padded_edge_weights(lp, H, last=True)[2] is None
