"""Port parity of the full ViS-MP layer (ai2bmd_torch.ops.vislayer, kernels
K5/K6's plain versions) against ai2bmd_tpu.ops.pallas.vislayer in interpret
mode, as tests/test_pallas_vislayer.py runs it, and of the model's
full-layer path.  Inputs are made with numpy from a seed; CPU, float32.
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
from ai2bmd_tpu.ops.pallas import vislayer as JL
from ai2bmd_torch.models import visnet as TV
from ai2bmd_torch.models.params import params_from_jax
from ai2bmd_torch.ops import vislayer as TL

B, A, H, NH, S = 2, 16, 64, 2, 8
CUTOFF = 5.0
LAYER_CFG = JV.ViSNetConfig(hidden_channels=H, num_heads=NH, num_layers=2)
MODEL = dict(hidden_channels=64, num_heads=2, num_layers=3, num_rbf=8, max_z=20)
T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def layer_params():
    jparams = JV.init_params(jax.random.PRNGKey(0), LAYER_CFG)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _layer_inputs(rng):
    """One fragment batch, the second fragment's last 3 slots masked; the
    streams sphere-major, as fused_layer takes them."""
    pos = (rng.normal(size=(B, A, 3)) * 2.0).astype(np.float32)
    mask = np.ones((B, A), bool)
    mask[1, A - 3:] = False
    adj, _, dist, d_sh = JV.dense_graph(jnp.asarray(pos), jnp.asarray(mask), LAYER_CFG)
    adj = np.asarray(adj, np.float32)
    return dict(
        x=(rng.normal(size=(B, A, H)) * 0.5).astype(np.float32),
        vec=(rng.normal(size=(B, S, A, H)) * 0.3).astype(np.float32),
        edge=(rng.normal(size=(B, A, A, H)) * 0.2).astype(np.float32) * adj[..., None],
        d_sh=np.ascontiguousarray(np.transpose(np.asarray(d_sh), (0, 3, 1, 2))),
        dist=np.asarray(dist), adj=adj)


ORDER = ("x", "vec", "edge", "d_sh", "dist", "adj")


def _ops(layer_params, last):
    jparams, tparams = layer_params
    li = 1 if last else 0
    jw = JL.layer_weights(jparams["layers"][li], H, NH, last)
    tw = TL.layer_weights(tparams["layers"][li], H, NH, last)
    return (JL.fused_layer(CUTOFF, NH, last, interpret=True), jw,
            TL.fused_layer(CUTOFF, NH, last), tw)


def _close(mine, ref, tol, name):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=name)


@pytest.mark.parametrize("last", [False, True], ids=["update", "last"])
def test_layer_forward_matches_pallas(layer_params, rng, last):
    """(x', vec', edge') of K5's plain version against the Pallas forward in
    interpret mode.  Tolerance 2e-5 abs and rel: the Pallas products use a
    3-pass bf16 split (~2^-16 relative), the port full float32."""
    jop, jw, top, tw = _ops(layer_params, last)
    a = _layer_inputs(rng)
    # the Pallas forward's fourth output, x_agg, is what its backward reads
    outs_j = JL._fwd_call(*[jnp.asarray(a[n]) for n in ORDER], jw, CUTOFF, NH, last,
                          interpret=True)
    outs_t = TL.vislayer_fwd(*[T(a[n]) for n in ORDER], tw, CUTOFF, NH, last)
    for name, mine, ref in zip(("x", "vec", "edge", "x_agg"), outs_t, outs_j):
        assert mine.shape == ref.shape
        _close(mine, ref, 2e-5, name)
    # and the autograd entry returns the first three
    for mine, ref in zip(top(*[T(a[n]) for n in ORDER], *tw), outs_t):
        assert torch.equal(mine, ref)


@pytest.mark.parametrize("last", [False, True], ids=["update", "last"])
def test_layer_vjp_matches_pallas(layer_params, rng, last):
    """The layer VJP (K6's plain version through FusedLayer) against the
    Pallas backward in interpret mode, for g_x, g_vec, g_edge, g_dist and
    g_dsh.  Tolerance 5e-5 abs and rel (the bf16 split, as above)."""
    jop, jw, top, tw = _ops(layer_params, last)
    a = _layer_inputs(rng)
    cts = [rng.normal(size=a[n].shape).astype(np.float32) for n in ("x", "vec", "edge")]

    @jax.jit
    def pallas_vjp(ins, cts):
        _, vjp = jax.vjp(lambda *i: jop(*i, jnp.asarray(a["adj"]), *jw), *ins)
        return vjp(cts)

    grads_j = pallas_vjp(tuple(jnp.asarray(a[n]) for n in ORDER[:5]),
                         tuple(jnp.asarray(c) for c in cts))

    ins = [T(a[n]).requires_grad_(True) for n in ORDER[:5]]
    outs_t = top(*ins, T(a["adj"]), *tw)
    grads_t = torch.autograd.grad(outs_t, ins, [T(c) for c in cts])
    for name, mine, ref in zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"), grads_t, grads_j):
        assert mine.shape == ref.shape
        _close(mine, ref, 5e-5, name)


def test_layer_weights_match_jax(layer_params):
    """layer_weights from params_from_jax: the JAX tuple, bit for bit."""
    jparams, tparams = layer_params
    for li, last in ((0, False), (1, True)):
        jw = JL.layer_weights(jparams["layers"][li], H, NH, last)
        tw = TL.layer_weights(tparams["layers"][li], H, NH, last)
        assert len(tw) == len(jw) == len(TL.WEIGHT_NAMES)
        for name, mine, ref in zip(TL.WEIGHT_NAMES, tw, jw):
            assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape, name
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=name)


@pytest.fixture(scope="module")
def models():
    jcfg = JV.ViSNetConfig(**MODEL, fused_layer_interpret=True)
    jparams = JV.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, TV.ViSNetConfig(**MODEL, fused_layer=True), tparams


@pytest.fixture(scope="module")
def chig_batches():
    """Chignolin's four ViSNet batches (dipeptides 2x24, 4x32, 4x40, ACE-NME
    9x16), caps placed, from the JAX package's runtime."""
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


BATCHES = dict(argnames="batch", argvalues=range(4), ids=["dip24", "dip32", "dip40", "ace16"])


@pytest.mark.parametrize(**BATCHES)
def test_fused_layer_model_matches_pallas(models, chig_batches, batch):
    """energy_and_forces with fused_layer=True (3 layers x 64) against the
    JAX package's full-layer kernels in interpret mode, on Chignolin's real
    batches.  Tolerance 1e-4 eV and 1e-4 eV/A."""
    jcfg, jparams, tcfg, tparams = models
    z, pos, mask = chig_batches[batch]
    e_j, f_j = jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, jcfg))(
        jparams, z, pos, mask)
    e_t, f_t = TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask), tcfg)
    assert f_t.shape == (len(z), z.shape[1], 3) and torch.isfinite(f_t).all()
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize(**BATCHES)
def test_fused_layer_model_matches_per_layer_path(models, chig_batches, batch):
    """The port's full-layer path against its own per-layer path (the edge
    core of K1-K3's plain versions), same tolerance."""
    _, _, tcfg, tparams = models
    z, pos, mask = chig_batches[batch]
    args = (tparams, T(z).long(), T(pos), T(mask))
    e_f, f_f = TV.energy_and_forces(*args, tcfg)
    e_p, f_p = TV.energy_and_forces(*args, dataclasses.replace(tcfg, fused_layer=False))
    np.testing.assert_allclose(e_f.numpy(), e_p.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f_f.numpy(), f_p.numpy(), rtol=0, atol=1e-4)


def test_fused_layer_refuses_what_its_kernels_cannot_run(models, chig_batches):
    """No quiet switch to the per-layer path: a slot count that is not a
    multiple of 8, or another activation, raises."""
    _, _, tcfg, tparams = models
    z, pos, mask = chig_batches[0]
    args = (tparams, T(z[:, :20]).long(), T(pos[:, :20]), T(mask[:, :20]))
    with pytest.raises(ValueError, match="fused_layer needs"):
        TV.energy_and_forces(*args, tcfg)
    with pytest.raises(ValueError, match="fused_layer needs"):
        TV.energy_and_forces(tparams, T(z).long(), T(pos), T(mask),
                             dataclasses.replace(tcfg, activation="tanh"))
