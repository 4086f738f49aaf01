"""Port parity: the mixed-precision mode (``ViSNetConfig.edge_dtype``),
ai2bmd_torch vs ai2bmd_tpu.

The same inputs, made with numpy from a seed, go through both packages on
the CPU.  In the mixed-precision mode the JAX side runs the route it takes
on the TPU: its Pallas kernels on bfloat16 refs, in interpret mode
(``fused=True, fused_interpret=True, edge_dtype=jnp.bfloat16``).  The port
side runs the plain versions of the bfloat16 instantiations of K1-K3, K7
and K8 (``ops.vismp.edge_fwd_bf16_plain`` and its siblings), which model
what those kernels compute on bfloat16 (the rounding rules are listed in
ops/vismp.py).  Each JAX evaluation runs once, in a module fixture.

Bounds: each output of a kernel within 2^-7 x max|ref| of its own scale,
about one bfloat16 step of its largest value (several outputs here are well
below 1, so this is tighter than the 2^-7 x max(1, max|ref|) that
chip_smoke.py holds the card's kernels to); a whole model's forces within half of
JAX's own mixed-vs-float32 shift on the same input, so that the port
follows JAX's mixed path and not merely float32.
"""

import dataclasses
import logging

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

BF = jnp.bfloat16
SMALL = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8, max_z=20)
B, A, H, NH, S, CUTOFF = 2, 16, 32, 4, 8, 5.0
KERNEL_TOL = 2.0 ** -7
# the edge core's arguments in the JAX kernels' order
CORE = ["q", "k", "v", "vec", "edge", "d_sh", "dist", "adj", "w_dkv", "b_dkv", "w_s", "b_s"]
UPD = ["wt", "wsrc", "w_f", "b_f"]


def _t(a):
    """A JAX array as a torch tensor of its type (bfloat16 via float32)."""
    a = jnp.asarray(a)
    out = torch.as_tensor(np.array(a.astype(jnp.float32)))
    return out.to(torch.bfloat16) if a.dtype == BF else out


def _sm(x):
    """[B,A,S,H] <-> [B,S,A,H]."""
    return jnp.swapaxes(x, 1, 2)


def _close(got, ref, name):
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert g.shape == r.shape, name
    err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
    assert scale > 0, f"{name}: the reference is all zeros"
    bound = KERNEL_TOL * scale
    assert err <= bound, f"{name}: max|d| {err:.3e} > {bound:.3e} (max|ref| {scale:.3e})"


@pytest.fixture(scope="module")
def edge():
    """bfloat16 edge-core inputs on a random geometry (unit spherical
    features), cotangents, and JAX's forward kernels and VJP on them."""
    rng = np.random.default_rng(20)
    f = lambda *s, sc=0.3: jnp.asarray(rng.standard_normal(s).astype(np.float32) * sc).astype(BF)
    pos = (rng.random((B, A, 3)) * 6).astype(np.float32)
    d = pos[:, None] - pos[:, :, None]
    dist = np.sqrt((d ** 2).sum(-1))
    unit = d / np.where(dist > 0, dist, 1.0)[..., None]
    adj = (dist < CUTOFF).astype(np.float32)
    d_sh = np.asarray(JV.spherical_harmonics(jnp.asarray(unit), 2))
    a = dict(q=f(B, A, H), k=f(B, A, H), v=f(B, A, H), vec=f(B, A, S, H), wt=f(B, A, S, H),
             wsrc=f(B, A, S, H), edge=f(B, A, A, H) * jnp.asarray(adj, BF)[..., None],
             d_sh=jnp.asarray(d_sh, BF), dist=jnp.asarray(dist, BF), adj=jnp.asarray(adj, BF),
             w_dkv=f(H, 2 * H, sc=0.25), b_dkv=f(2 * H, sc=0.1), w_s=f(H, 2 * H, sc=0.25),
             b_s=f(2 * H, sc=0.1), w_f=f(H, H, sc=0.25), b_f=f(H, sc=0.1))
    names = CORE[:4] + UPD[:2] + CORE[4:] + UPD[2:]
    core = JK.fused_vis_mp(CUTOFF, NH, False, interpret=True)
    outs, vjp = jax.vjp(core, *[a[n] for n in names])
    cts = [f(*np.shape(o), sc=0.5) for o in outs]
    return dict(a=a, t={n: _t(x) for n, x in a.items()}, cts=cts,
                grads=dict(zip(names, vjp(tuple(cts)))))


@pytest.mark.parametrize("update, store", [(True, True), (True, False), (False, True),
                                           (False, False)],
                         ids=["update-store", "update", "store", "plain"])
def test_bf16_forward_matches_pallas(edge, update, store):
    """K1's bfloat16 plain version, through its wrapper on CPU tensors, in
    each flag pair against the JAX forward kernel of that pair in interpret
    mode on the same bfloat16 inputs: every output and the stash."""
    a, t = edge["a"], edge["t"]
    args = [a[n] for n in CORE]
    if update:
        fn = JK.fused_edge_block_with_update_res if store else JK.fused_edge_block_with_update
        ref = fn(*args, *[a[n] for n in UPD], CUTOFF, NH, interpret=True)
    else:
        fn = JK.fused_edge_block_res if store else JK.fused_edge_block
        ref = fn(*args, CUTOFF, NH, interpret=True)
    kw = {n: t[n] for n in UPD} if update else {}
    got = TK.edge_fwd(*[t[n] for n in CORE], CUTOFF, NH, **kw, store=store)
    got = [g for g in got if g is not None]
    names = ["x_agg", "vec_agg"] + (["df"] if update else []) + (
        ["zdkv", "zs"] + (["zf"] if update else []) if store else [])
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        assert g.dtype == torch.bfloat16, name
        _close(g, r, name)


def test_bf16_stash_backward_matches_pallas_vjp(edge):
    """K2 and K3's bfloat16 plain versions (FusedVisMP's stash route on
    bfloat16 CPU tensors) against jax.vjp of the JAX fused core, whose
    backward kernels read their bfloat16 stash."""
    t = edge["t"]
    diff = ["q", "k", "v", "vec", "wt", "wsrc", "edge", "d_sh", "dist"]
    ins = {n: x.clone().requires_grad_(n in diff) for n, x in t.items()}
    order = CORE[:4] + UPD[:2] + CORE[4:] + UPD[2:]
    outs = TK.FusedVisMP.apply(*[ins[n] for n in order], CUTOFF, NH, False)
    grads = torch.autograd.grad(outs, [ins[n] for n in diff],
                                grad_outputs=[_t(c) for c in edge["cts"]])
    for n, g in zip(diff, grads):
        _close(g, edge["grads"][n], f"g_{n}")


@pytest.mark.parametrize("kernel", ["K7", "K8"])
def test_bf16_recompute_backward_matches_pallas(edge, kernel):
    """K7 and K8's bfloat16 plain versions against the recompute-mode JAX
    kernels ``_bwd_msg_call`` and ``_bwd_upd_call`` in interpret mode."""
    a, t = edge["a"], edge["t"]
    g_x, g_va, g_df = edge["cts"]
    if kernel == "K7":
        ref = JK._bwd_msg_call(a["q"], a["k"], a["v"], _sm(a["vec"]), a["edge"],
                               jnp.transpose(a["d_sh"], (0, 3, 1, 2)), a["dist"], a["adj"],
                               a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], g_x, _sm(g_va),
                               cutoff=CUTOFF, nh=NH, interpret=True)
        ref = [ref[0], ref[1], ref[2], _sm(ref[3]), ref[4],
               jnp.transpose(ref[5], (0, 2, 3, 1)), ref[6]]
        got = TK.edge_bwd_msg_rc(*[t[n] for n in CORE], _t(g_x), _t(g_va), CUTOFF, NH)
        names = ["g_q", "g_k", "g_v", "g_vec", "g_edge", "g_d_sh", "g_dist"]
    else:
        ref = JK._bwd_upd_call(a["edge"], a["adj"], _sm(a["wt"]), _sm(a["wsrc"]), a["w_f"],
                               a["b_f"], g_df, interpret=True)
        ref = [ref[0], _sm(ref[1]), _sm(ref[2])]
        got = TK.edge_bwd_upd_rc(t["edge"], t["adj"], t["wt"], t["wsrc"], t["w_f"], t["b_f"],
                                 _t(g_df))
        names = ["g_edge", "g_wt", "g_wsrc"]
    for name, g, r in zip(names, got, ref):
        assert g.dtype == torch.bfloat16, name
        _close(g, r, name)


@pytest.fixture(scope="module")
def chig_dip24():
    """Chignolin's first fragment batch (the 2 x 24 dipeptides), caps placed."""
    conftest.require_examples()
    atoms = normalize_atom_order(read_pdb(conftest.example_pdb("chig")))
    rt = FragmentRuntime.build(build_fragment_index(atoms))
    pos = np.asarray(build_row_positions(rt, jnp.asarray(atoms.positions, jnp.float32)))
    w, idx, z, valid, _, _ = rt.dip_buckets[0]
    return np.asarray(z), pos[np.asarray(idx), :w], np.asarray(valid)


def _jax_pair(act, fused, z, pos, mask):
    """JAX's float32 and mixed-precision (E, F) of a 2 x 32 model."""
    jcfg = JV.ViSNetConfig(**SMALL, activation=act, attn_activation=act)
    params = JV.init_params(jax.random.PRNGKey(0), jcfg)
    mixed = dataclasses.replace(jcfg, fused=fused, fused_interpret=fused, edge_dtype=BF)
    run = lambda c: jax.jit(lambda p, z, x, m: JV.energy_and_forces(p, z, x, m, c))(
        params, z, pos, mask)
    (e32, f32), (em, fm) = run(jcfg), run(mixed)
    return params, [np.asarray(x) for x in (e32, f32, em, fm)]


@pytest.fixture(scope="module")
def silu_pair(chig_dip24):
    return _jax_pair("silu", True, *chig_dip24)


@pytest.fixture(scope="module")
def tanh_pair(chig_dip24):
    return _jax_pair("tanh", False, *chig_dip24)


def _check_model(pair, batch, tcfg):
    params, (e32, f32, em, fm) = pair
    z, pos, mask = batch
    e, f = TV.energy_and_forces(params_from_jax(jax.tree.map(np.asarray, params)),
                                torch.as_tensor(z).long(), torch.as_tensor(pos),
                                torch.as_tensor(mask), tcfg)
    shift_f, shift_e = float(np.abs(fm - f32).max()), float(np.abs(em - e32).max())
    df, de = float(np.abs(f.numpy() - fm).max()), float(np.abs(e.numpy() - em).max())
    msg = (f"port vs JAX mixed: max|dF| {df:.3e}, max|dE| {de:.3e}; JAX mixed vs float32: "
           f"max|dF| {shift_f:.3e}, max|dE| {shift_e:.3e}")
    assert shift_f > 0 and df <= 0.5 * shift_f, msg
    assert de <= 0.5 * shift_e, msg


@pytest.mark.parametrize("remat", [False, True], ids=["stash", "remat"])
def test_mixed_model_matches_jax_mixed_path(silu_pair, chig_dip24, remat):
    """A 2 x 32 silu model with edge_dtype=bfloat16 on Chignolin's 2 x 24
    batch, the port's kernel model (K1-K3, or K1, K7, K8 with remat) against
    JAX's Pallas path in the mode: E and F within half of JAX's own
    mixed-vs-float32 shift on the same input."""
    cfg = TV.ViSNetConfig(**SMALL, edge_dtype=torch.bfloat16, remat=remat)
    _check_model(silu_pair, chig_dip24, cfg)


def test_mixed_tanh_model_plain_route_matches_jax_jnp_path(tanh_pair, chig_dip24):
    """A tanh model in the mode takes the plain edge core in bfloat16 (the
    card's plain route, resolve_config), against JAX's jnp path (fused=False)
    in the mode, to the same bound."""
    cfg = TV.ViSNetConfig(**SMALL, activation="tanh", attn_activation="tanh",
                          edge_dtype=torch.bfloat16)
    assert TV.resolve_config(cfg, "cuda").plain_edge_core
    _check_model(tanh_pair, chig_dip24, cfg)


def test_resolve_config_gives_mixed_models_the_per_layer_path(monkeypatch, caplog):
    """edge_dtype with AI2BMD_FUSED_LAYER=1 (on the card) or fused_layer=True
    (anywhere) runs the per-layer kernels, with one logged line, as JAX's
    use_full_layer needs edge_dtype None; a float32 config is unchanged."""
    monkeypatch.setenv("AI2BMD_FUSED_LAYER", "1")
    mixed = TV.ViSNetConfig(**SMALL, edge_dtype=torch.bfloat16)
    with caplog.at_level(logging.WARNING, logger=TV.__name__):
        got = TV.resolve_config(mixed, "cuda")
    assert got == mixed and not got.fused_layer
    assert len(caplog.records) == 1 and "per-layer path" in caplog.records[0].getMessage()
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=TV.__name__):
        got = TV.resolve_config(dataclasses.replace(mixed, fused_layer=True), "cpu")
    assert not got.fused_layer and len(caplog.records) == 1
    f32 = TV.ViSNetConfig(**SMALL)
    assert TV.resolve_config(f32, "cuda") == dataclasses.replace(f32, fused_layer=True)
    monkeypatch.delenv("AI2BMD_FUSED_LAYER")
    assert TV.resolve_config(f32, "cuda") == f32
    assert TV.resolve_config(mixed, "cuda") == mixed


def test_edge_dtype_takes_bfloat16_only():
    """float16 (or any type but bfloat16) raises when configured, naming
    ROADMAP Queue 2."""
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="ROADMAP.md, Queue 2"):
            TV.ViSNetConfig(**SMALL, edge_dtype=dtype)
    assert TV.ViSNetConfig(**SMALL, edge_dtype=torch.bfloat16).edge_dtype == torch.bfloat16

