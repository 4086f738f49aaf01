"""The full-layer path (ops/vislayer.py, K5/K6's plain versions) past 48
slots, where the card's K5/K6 walk each centre's sources in chunks of 48
rows, against the JAX package on the CPU: one layer at A = 56 (two chunks)
against ai2bmd_tpu.ops.pallas.vislayer in interpret mode, and a whole
molecule (Chignolin, A = 176) through ViSNetPotential with fused_layer
against the port's per-layer path and JAX's ViSNetPotential.  Inputs are
made with numpy from a seed; CPU, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from ai2bmd_tpu.models import visnet as JV
from ai2bmd_tpu.ops.pallas import vislayer as JL
from ai2bmd_tpu.potentials import ViSNetPotential as JVP
from ai2bmd_torch import potentials as TP
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import vislayer as TL

B, A, H, NH, S = 1, 56, 64, 2, 8      # A = 56: a chunk of 48 source rows and one of 8
CUTOFF = 5.0
ORDER = ("x", "vec", "edge", "d_sh", "dist", "adj")
T = lambda a: torch.as_tensor(np.array(a))
# the Pallas products use a 3-pass bf16 split (~2^-16 relative), the port's
# plain versions full float32: the tolerances of tests/test_torch_vislayer.py,
# abs and rel, for the forward and for the VJP
FWD_TOL, VJP_TOL = 2e-5, 5e-5


@pytest.fixture(scope="module")
def layer_params():
    cfg = JV.ViSNetConfig(hidden_channels=H, num_heads=NH, num_layers=2)
    jparams = JV.init_params(jax.random.PRNGKey(4), cfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams)), cfg


def _inputs(rng, cfg):
    """One molecule of A slots (the last 5 masked), spread so that some
    source pairs lie beyond the cutoff; the streams sphere-major."""
    pos = (rng.normal(size=(B, A, 3)) * 3.0).astype(np.float32)
    mask = np.ones((B, A), bool)
    mask[0, A - 5:] = False
    adj, _, dist, d_sh = JV.dense_graph(jnp.asarray(pos), jnp.asarray(mask), cfg)
    adj = np.asarray(adj, np.float32)
    return dict(
        x=(rng.normal(size=(B, A, H)) * 0.5).astype(np.float32),
        vec=(rng.normal(size=(B, S, A, H)) * 0.3).astype(np.float32),
        edge=(rng.normal(size=(B, A, A, H)) * 0.2).astype(np.float32) * adj[..., None],
        d_sh=np.ascontiguousarray(np.transpose(np.asarray(d_sh), (0, 3, 1, 2))),
        dist=np.asarray(dist), adj=adj)


def _close(mine, ref, tol, name):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=name)


def _weights(layer_params, last):
    jparams, tparams, _ = layer_params
    li = 1 if last else 0
    return (JL.layer_weights(jparams["layers"][li], H, NH, last),
            TL.layer_weights(tparams["layers"][li], H, NH, last))


@pytest.mark.parametrize("last", [False, True], ids=["update", "last"])
def test_layer_forward_past_48_slots_matches_pallas(layer_params, rng, last):
    """(x', vec', edge', x_agg) of K5's plain version at A = 56 against the
    Pallas forward in interpret mode."""
    jw, tw = _weights(layer_params, last)
    a = _inputs(rng, layer_params[2])
    assert float(a["adj"].mean()) < 0.9            # pairs beyond the cutoff are masked
    outs_j = JL._fwd_call(*[jnp.asarray(a[n]) for n in ORDER], jw, CUTOFF, NH, last,
                          interpret=True)
    outs_t = TL.vislayer_fwd(*[T(a[n]) for n in ORDER], tw, CUTOFF, NH, last)
    for name, mine, ref in zip(("x", "vec", "edge", "x_agg"), outs_t, outs_j):
        assert mine.shape == ref.shape
        _close(mine, ref, FWD_TOL, name)


@pytest.mark.parametrize("last", [False, True], ids=["update", "last"])
def test_layer_vjp_past_48_slots_matches_pallas(layer_params, rng, last):
    """The layer VJP at A = 56 (K6's plain version through FusedLayer)
    against the Pallas backward in interpret mode: g_x, g_vec, g_edge,
    g_d_sh, g_dist."""
    jw, tw = _weights(layer_params, last)
    a = _inputs(rng, layer_params[2])
    cts = [rng.normal(size=a[n].shape).astype(np.float32) for n in ("x", "vec", "edge")]
    jop = JL.fused_layer(CUTOFF, NH, last, interpret=True)

    @jax.jit
    def pallas_vjp(ins, cts):
        _, vjp = jax.vjp(lambda *i: jop(*i, jnp.asarray(a["adj"]), *jw), *ins)
        return vjp(cts)

    grads_j = pallas_vjp(tuple(jnp.asarray(a[n]) for n in ORDER[:5]),
                         tuple(jnp.asarray(c) for c in cts))
    ins = [T(a[n]).requires_grad_(True) for n in ORDER[:5]]
    outs_t = TL.fused_layer(CUTOFF, NH, last)(*ins, T(a["adj"]), *tw)
    grads_t = torch.autograd.grad(outs_t, ins, [T(c) for c in cts])
    for name, mine, ref in zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"), grads_t, grads_j):
        assert mine.shape == ref.shape
        _close(mine, ref, VJP_TOL, name)


# the CLI's tiny preset: 2 layers x 32, 4 heads of 8 channels
TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)


@pytest.fixture(scope="module")
def chig_whole():
    """Chignolin as one molecule (176 slots) in both packages, the same
    weights (JAX's, bridged), and JAX's E and F at the PDB positions."""
    conftest.require_examples()
    from ai2bmd_torch.host import example_pdb, load_protein

    prot = load_protein(example_pdb("chig"))
    jcfg = JV.ViSNetConfig(**TINY)
    jparams = JV.init_params(jax.random.PRNGKey(11), jcfg)
    jpot = JVP.build(prot.numbers, jparams, jcfg)
    P = prot.positions.astype(np.float32)
    e_j, f_j = jax.jit(jpot.energy_forces)(jnp.asarray(P))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return prot, tparams, P, float(e_j), np.asarray(f_j)


def test_whole_molecule_through_the_full_layer_path(chig_whole):
    """ViSNetPotential with fused_layer=True (the path AI2BMD_FUSED_LAYER=1
    selects on the card) on Chignolin as one molecule of 176 slots, against
    the port's per-layer path and JAX's ViSNetPotential.  Tolerance 1e-4 eV
    and eV/A (float32 sums over 176 sources in other orders)."""
    prot, tparams, P, e_j, f_j = chig_whole
    cfg = TV.ViSNetConfig(**TINY, fused_layer=True)
    fused = TP.ViSNetPotential.build(prot.numbers, TV.ViSNet(cfg, tparams), cfg, device="cpu")
    per_layer_cfg = dataclasses.replace(cfg, fused_layer=False)
    per_layer = TP.ViSNetPotential.build(prot.numbers, TV.ViSNet(per_layer_cfg, tparams),
                                         per_layer_cfg, device="cpu")
    assert fused.pad_to == 176 and fused.cfg.fused_layer and not per_layer.cfg.fused_layer
    e_f, f_f = fused.energy_forces(T(P))
    e_p, f_p = per_layer.energy_forces(T(P))
    assert f_f.shape == (175, 3) and float(np.abs(f_j).max()) > 1e-3
    for e, f in ((e_p, f_p), (e_j, f_j)):
        np.testing.assert_allclose(float(e_f), float(e), rtol=0, atol=1e-4)
        np.testing.assert_allclose(f_f.numpy(), np.asarray(f), rtol=0, atol=1e-4)
