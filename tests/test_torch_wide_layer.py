"""Port parity of the full-layer kernels' wide shapes and of a molecule past
1,024 slots (ai2bmd_torch vs ai2bmd_tpu), on the CPU.

K5/K6 take every H whose head count divides it: their narrow
instantiations heads of 8, 16, 32 or 64 channels with H a multiple of 32 up
to 256, their wide ones every other shape, with every weight zero-padded to
a multiple of 32 channels a segment (``ops.vislayer.padded_layer_weights``).
On the CPU the wrappers run their plain versions, which are shape-generic
and take the weights padded or not.  These tests hold the plain versions at
wide shapes (heads of 24, 96 and 96 channels; H = 48, 96 and 288) against
the JAX package's Pallas full-layer kernels in interpret mode, a 2 x 48
model with ``fused_layer`` against JAX's full-layer model, and a 1,112-atom
polyalanine as one molecule against JAX's whole-molecule jnp path; and the
routes.  The same inputs, made with numpy from a seed, go through both
packages in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu.frag.indexer import build_fragment_index
from ai2bmd_tpu.frag.runtime import FragmentRuntime, build_row_positions
from ai2bmd_tpu.io.build import build_polyalanine
from ai2bmd_tpu.io.pdb import read_pdb
from ai2bmd_tpu.io.reorder import normalize_atom_order
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.ops.pallas import vislayer as JL
from ai2bmd_tpu.potentials import ViSNetPotential as JVP
from ai2bmd_torch import potentials as TP
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import init_params, params_from_jax
from ai2bmd_torch.ops import vislayer as TL
from ai2bmd_torch.ops import vismp as TK

B, A, S = 2, 16, 8
CUTOFF = 5.0
ORDER = ("x", "vec", "edge", "d_sh", "dist", "adj")
# (H, heads): two heads of 24 (H % 32 != 0), one of 96, three of 96 (H
# past 256)
WIDTHS = dict(argnames="H, nh", argvalues=[(48, 2), (96, 1), (288, 3)],
              ids=["H48-dh24", "H96-dh96", "H288-dh96"])
LAST = dict(argnames="last", argvalues=[False, True], ids=["update", "last"])
# the Pallas products are a 3-pass bf16 split (~2^-16 relative), the port's
# plain versions full float32: as tests/test_torch_vislayer.py
FWD_TOL, VJP_TOL = 2e-5, 5e-5
T = lambda a: torch.as_tensor(np.array(a))


def _close(mine, ref, tol, name):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _params(H, nh):
    """Both packages' parameters of a 2-layer model (JAX's init, seed 0)."""
    cfg = JV.ViSNetConfig(hidden_channels=H, num_heads=nh, num_layers=2)
    jparams = JV.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _layer(H, nh, last, rng):
    """Both packages' weights of one layer and the layer's inputs: one
    fragment batch, the second fragment's last 3 slots masked, the streams
    sphere-major."""
    cfg, jparams, tparams = _params(H, nh)
    li = 1 if last else 0
    jw = JL.layer_weights(jparams["layers"][li], H, nh, last)
    tw = TL.layer_weights(tparams["layers"][li], H, nh, last)
    pos = (rng.normal(size=(B, A, 3)) * 2.0).astype(np.float32)
    mask = np.ones((B, A), bool)
    mask[1, A - 3:] = False
    adj, _, dist, d_sh = JV.dense_graph(jnp.asarray(pos), jnp.asarray(mask), cfg)
    adj = np.asarray(adj, np.float32)
    a = dict(x=(rng.normal(size=(B, A, H)) * 0.5).astype(np.float32),
             vec=(rng.normal(size=(B, S, A, H)) * 0.3).astype(np.float32),
             edge=(rng.normal(size=(B, A, A, H)) * 0.2).astype(np.float32) * adj[..., None],
             d_sh=np.ascontiguousarray(np.transpose(np.asarray(d_sh), (0, 3, 1, 2))),
             dist=np.asarray(dist), adj=adj)
    return jw, tw, a


@pytest.mark.parametrize(**LAST)
@pytest.mark.parametrize(**WIDTHS)
def test_wide_layer_matches_pallas(rng, H, nh, last):
    """K5's plain version (x', vec', edge', x_agg) and K6's through
    FusedLayer (g_x, g_vec, g_edge, g_d_sh, g_dist) against the Pallas
    forward and VJP in interpret mode, within 2e-5 and 5e-5 abs and rel;
    then again on the padded weights the model hands the kernels, which
    must give the unpadded result bit for bit."""
    check_layer(rng, H, nh, last)


def check_layer(rng, H, nh, last):
    """The body of test_wide_layer_matches_pallas at width H with nh heads;
    tests/test_torch_past_1024.py runs it past 1,024 channels."""
    assert not TK.narrow_shapes(H, nh) and TK.layer_shapes(H, nh, S)
    jw, tw, a = _layer(H, nh, last, rng)
    outs_j = JL._fwd_call(*[jnp.asarray(a[n]) for n in ORDER], jw, CUTOFF, nh, last,
                          interpret=True)
    cts = [rng.normal(size=a[n].shape).astype(np.float32) for n in ("x", "vec", "edge")]
    jop = JL.fused_layer(CUTOFF, nh, last, interpret=True)

    @jax.jit
    def pallas_vjp(ins, cts):
        _, vjp = jax.vjp(lambda *i: jop(*i, jnp.asarray(a["adj"]), *jw), *ins)
        return vjp(cts)

    grads_j = pallas_vjp(tuple(jnp.asarray(a[n]) for n in ORDER[:5]),
                         tuple(jnp.asarray(c) for c in cts))

    top = TL.fused_layer(CUTOFF, nh, last)
    results = []
    for w in (tw, TL.padded_layer_weights(tw, H)):
        outs = TL.vislayer_fwd(*[T(a[n]) for n in ORDER], w, CUTOFF, nh, last)
        ins = [T(a[n]).requires_grad_(True) for n in ORDER[:5]]
        grads = torch.autograd.grad(top(*ins, T(a["adj"]), *w), ins, [T(c) for c in cts])
        results.append((*outs, *grads))
    for name, mine, ref in zip(("x", "vec", "edge", "x_agg"), results[0], outs_j):
        assert mine.shape == ref.shape, name
        _close(mine, ref, FWD_TOL, name)
    for name, mine, ref in zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"), results[0][4:],
                               grads_j):
        assert mine.shape == ref.shape, name
        _close(mine, ref, VJP_TOL, name)
    assert all(torch.equal(p, u) for p, u in zip(results[1], results[0]))


@pytest.mark.parametrize("H, nh", [(48, 2), (288, 3), (1064, 8)],
                         ids=["H48", "H288", "H1064-dh133"])
def test_padded_layer_weights(H, nh):
    """padded_layer_weights zero-pads every weight and bias to
    wide_width(H) a segment (the head pool as it is), takes a tuple padded
    already, and unpadded_layer_weights gives the weights back bit for
    bit; at H % 32 == 0 both return the weights themselves."""
    cfg = TV.ViSNetConfig(hidden_channels=H, num_heads=nh, num_layers=2)
    w = TL.layer_weights(init_params(cfg, torch.Generator().manual_seed(1))["layers"][0], H, nh,
                         False)
    Hp = TK.wide_width(H)
    padded = TL.padded_layer_weights(w, H)
    if Hp == H:
        assert all(p is u for p, u in zip(padded, w))
        return
    for name, p, u in zip(TL.WEIGHT_NAMES, padded, w):
        if name == "pool":
            assert p is u
            continue
        k = TL.SEGMENTS[name]
        if u.dim() == 2:
            assert p.shape == (Hp, k * Hp), name
            blocks = p.view(Hp, k, Hp)
            assert torch.equal(blocks[:H, :, :H].reshape(H, k * H), u), name
            assert not blocks[H:].any() and not blocks[:, :, H:].any(), name
        else:
            assert p.shape == (k * Hp,), name
            assert torch.equal(p.view(k, Hp)[:, :H].reshape(-1), u), name
            assert not p.view(k, Hp)[:, H:].any(), name
    assert all(p is q for p, q in zip(TL.padded_layer_weights(padded, H), padded))
    assert all(torch.equal(a, b) for a, b in zip(TL.unpadded_layer_weights(padded, H), w))


MODEL = dict(hidden_channels=48, num_heads=2, num_layers=2, num_rbf=8, max_z=20)


@pytest.fixture(scope="module")
def models():
    jcfg = JV.ViSNetConfig(**MODEL, fused_layer_interpret=True)
    jparams = JV.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, TV.ViSNetConfig(**MODEL, fused_layer=True), tparams


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
def test_wide_fused_layer_model_matches_pallas(models, chig_batches, batch):
    """energy_and_forces of a 2 x 48 model with two heads of 24 and
    fused_layer=True against the JAX package's full-layer kernels in
    interpret mode, on Chignolin's real batches, within 1e-4 eV and eV/A."""
    jcfg, jparams, tcfg, tparams = models
    z, pos, mask = chig_batches[batch]
    e_j, f_j = jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, jcfg))(
        jparams, z, pos, mask)
    e_t, f_t = TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask), tcfg)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


LONG = dict(hidden_channels=16, num_heads=2, num_layers=2, num_rbf=8, max_z=20)


@pytest.fixture(scope="module")
def polyalanine():
    """ACE-(ALA)110-NME as an alpha helix (1,112 atoms: 1,112 slots, past the
    1,024 the kernels once took) and JAX's whole-molecule E and F at 2 x 16
    through its jnp path."""
    atoms = build_polyalanine(110, phi=-57.0, psi=-47.0)
    numbers = np.asarray(atoms.numbers)
    P = np.asarray(atoms.positions, np.float32)
    jcfg = JV.ViSNetConfig(**LONG)
    jparams = JV.init_params(jax.random.PRNGKey(5), jcfg)
    jpot = JVP.build(numbers, jparams, jcfg)
    e_j, f_j = jax.jit(jpot.energy_forces)(jnp.asarray(P))
    return numbers, P, params_from_jax(jax.tree.map(np.asarray, jparams)), np.asarray(e_j), \
        np.asarray(f_j)


@pytest.mark.parametrize("fused", [False, True], ids=["per-layer", "fused-layer"])
def test_molecule_past_1024_slots_matches_jax(polyalanine, fused):
    """The port's ViSNetPotential on the CPU for the 1,112-atom polyalanine
    (one molecule of 1,112 slots), through the per-layer path and through
    fused_layer, against JAX's whole-molecule energy and forces within 1e-4
    eV and eV/A."""
    numbers, P, tparams, e_j, f_j = polyalanine
    assert len(numbers) == 1112
    cfg = TV.ViSNetConfig(**LONG, fused_layer=fused)
    pot = TP.ViSNetPotential.build(numbers, TV.ViSNet(cfg, tparams), cfg, device="cpu")
    assert pot.pad_to == 1112
    e_t, f_t = pot.energy_forces(T(P))
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("H, nh", [(512, 4), (48, 2), (1024, 8), (1280, 8), (2048, 16),
                                   (4096, 16), (8192, 32)],
                         ids=["H512-dh128", "H48-dh24", "H1024-dh128", "H1280-dh160",
                              "H2048-dh128", "H4096-dh256", "H8192-dh256"])
def test_wide_models_keep_the_full_layer_kernels(monkeypatch, H, nh):
    """check_shapes and check_layer_shapes take 1,112 slots at these widths
    and still refuse a slot count that is not a multiple of 8; on the card
    resolve_config keeps fused_layer for a wide silu model, asked for by
    fused_layer or by AI2BMD_FUSED_LAYER=1."""
    monkeypatch.delenv("AI2BMD_FUSED_LAYER", raising=False)
    for check in (TK.check_shapes, TK.check_layer_shapes):
        check(1112, H, S, nh)
        with pytest.raises(ValueError, match="A a multiple of 8"):
            check(1110, H, S, nh)
    cfg = TV.ViSNetConfig(hidden_channels=H, num_heads=nh, fused_layer=True)
    assert TV.resolve_config(cfg, "cuda") is cfg
    monkeypatch.setenv("AI2BMD_FUSED_LAYER", "1")
    got = TV.resolve_config(dataclasses.replace(cfg, fused_layer=False), "cuda")
    assert got == cfg


def test_what_the_full_layer_kernels_refuse(monkeypatch):
    """A head count that does not divide H and S > 8 raise, in
    check_layer_shapes and in resolve_config with fused_layer, naming
    ROADMAP.md Queue 2 (S > 8: no model of either package builds it); H
    past 1024 (1,056 with 8 heads) is taken there and resolves to K5/K6."""
    monkeypatch.setenv("AI2BMD_FUSED_LAYER", "1")
    for H, nh, S_ in ((48, 5, 8), (256, 8, 15)):
        with pytest.raises(ValueError, match="ROADMAP.md, Queue 2"):
            TK.check_layer_shapes(40, H, S_, nh)
    TK.check_layer_shapes(40, 1056, 8, 8)
    cfg = TV.ViSNetConfig(hidden_channels=1056, num_heads=8, fused_layer=True)
    assert TV.resolve_config(cfg, "cuda") is cfg
    with pytest.raises(ValueError, match="not a multiple of num_heads"):
        TV.resolve_config(TV.ViSNetConfig(hidden_channels=48, num_heads=5, fused_layer=True),
                          "cuda")
    with pytest.raises(ValueError, match="no model of either package builds S > 8"):
        TV.resolve_config(TV.ViSNetConfig(lmax=3, fused_layer=True), "cuda")
