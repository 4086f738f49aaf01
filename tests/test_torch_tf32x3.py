"""The 3xTF32 split of the edge kernels' tensor-core products (ai2bmd_torch).

K1, K2, K3, K7 and K8 take their edge products on the tensor cores, each
float32 operand split into two TF32 halves (``csrc/common.cuh``
``mma_rows_times_cols``, and K3/K8's row-tile product in
``csrc/edge_bwd_upd.cu``).  ``ops/tf32x3.py`` models that arithmetic in plain
PyTorch; these tests bound its error on the CPU against a float64 product,
against a plain float32 product, against one TF32 pass and against the JAX
package's own production split (3-pass bf16, ``vismp._split_b16``), and put
the split into the plain versions of K1, K2, K3 and K8 at Chignolin's (4, 40)
shape and of K5 and K6 at (2, 24).
Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai2bmd_tpu.ops.pallas import vismp as JK
from ai2bmd_torch.models.params import init_params
from ai2bmd_torch.models.visnet import ViSNetConfig, dense_graph, spherical_harmonics
from ai2bmd_torch.ops import tf32x3 as T
from ai2bmd_torch.ops import vislayer as TL
from ai2bmd_torch.ops import vismp as TK

H, NH, S, CUTOFF = 256, 8, 8, 5.0
EDGE_TOL = 1e-4   # chip_smoke.py's kernel tolerance, times max(1, max|ref|)


def _operands(K, rows=1024, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, K)).astype(np.float32) * 0.3
    w = rng.standard_normal((K, H)).astype(np.float32) * np.float32((2.0 / (K + H)) ** 0.5)
    return x, w


def _err64(y, x, w):
    ref = x.astype(np.float64) @ w.astype(np.float64)
    return float(np.abs(np.asarray(y, np.float64) - ref).max())


@pytest.mark.parametrize("K", [256, 512])
def test_split_product_error_is_float32_class(K):
    """Against a float64 product: the split within 10x of a float32 product's
    error; one TF32 pass alone more than 100x worse."""
    x, w = _operands(K)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    e_split = _err64(T.mm_tf32x3_plain(tx, tw), x, w)
    e_f32 = _err64(tx @ tw, x, w)
    e_one = _err64(T.round_tf32(tx) @ T.round_tf32(tw), x, w)
    assert e_split <= 10 * e_f32, (e_split, e_f32)
    assert e_one > 100 * e_f32, (e_one, e_f32)


@pytest.mark.parametrize("K", [256, 512])
def test_split_loses_less_than_the_jax_bf16_split(K):
    """The TPU kernels' production mode ``b3`` (three bf16 passes,
    vismp.py:43-97) against the port's three TF32 passes on the same inputs:
    TF32 keeps 3 more bits a pass, so the port's split is the closer."""
    x, w = _operands(K, seed=1)
    xh, xl = JK._split_b16(jnp.asarray(x))
    wh, wl = JK._split_b16(jnp.asarray(w))
    b3 = JK._dot1(xh, wh) + JK._dot1(xh, wl) + JK._dot1(xl, wh)
    e_b3 = _err64(b3, x, w)
    e_split = _err64(T.mm_tf32x3_plain(torch.from_numpy(x), torch.from_numpy(w)), x, w)
    assert e_split < e_b3, (e_split, e_b3)


def _f(bits):
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("bits, want", [
    (0x3F800000, 0x3F800000),   # 1.0: exact
    (0x3F801000, 0x3F802000),   # a tie above an even kept value: away from zero (nearest-even keeps it)
    (0xBF801000, 0xBF802000),   # the same tie, negative: away from zero
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3FFFF000, 0x40000000),   # a tie that carries into the exponent
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x00000FFF, 0x00000000),   # a subnormal below the tie: to +0
    (0x007FF000, 0x00800000),   # the largest subnormal's tie: to the smallest normal
    (0x80000000, 0x80000000),   # -0 stays -0
    (0x7F7FF000, 0x7F800000),   # past the largest TF32 value: to infinity
], ids=["one", "tie", "neg-tie", "below-tie", "carry", "sub-tie", "sub-below", "sub-carry",
        "neg-zero", "overflow"])
def test_round_tf32_matches_cvt_rna(bits, want):
    got = T.round_tf32(_f(bits)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(got) == want, f"{bits:#010x} -> {int(got):#010x}, expected {want:#010x}"


def test_round_tf32_passes_inf_and_nan():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    y = T.round_tf32(x)
    assert torch.equal(y[:2], x[:2]) and bool(torch.isnan(y[2]))


def _edge_inputs(B=4, A=40, seed=2):
    """K1/K2's inputs at (B, A) from random positions (a 5 A cutoff graph
    with self loops), float32 tensors on the CPU."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
    pos = torch.from_numpy((rng.standard_normal((B, A, 3)) * 2.5).astype(np.float32))
    vec = pos[:, None] - pos[:, :, None]
    dist = vec.norm(dim=-1)
    eye = torch.eye(A, dtype=torch.bool)
    adj = ((dist < CUTOFF) | eye).float()
    unit = vec / dist.clamp(min=1e-6)[..., None] * (~eye)[..., None]
    w = lambda n_in, n_out: r(n_in, n_out, sc=(2.0 / (n_in + n_out)) ** 0.5)
    return dict(
        q=r(B, A, H), k=r(B, A, H), v=r(B, A, H), vec=r(B, A, S, H),
        edge=r(B, A, A, H) * adj[..., None], d_sh=spherical_harmonics(unit, 2).contiguous(),
        dist=dist, adj=adj, w_dkv=w(H, 2 * H), b_dkv=r(2 * H, sc=0.1), w_s=w(H, 2 * H),
        b_s=r(2 * H, sc=0.1), wt=r(B, A, S, H), wsrc=r(B, A, S, H), w_f=w(H, H),
        b_f=r(H, sc=0.1), g_x=r(B, A, H, sc=1.0), g_va=r(B, A, S, H, sc=1.0))


def _close(got, ref, label):
    for n, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None
            continue
        err = float((g - r).abs().max())
        assert err <= EDGE_TOL * max(1.0, float(r.abs().max())), (label, n, err)


def _layer_case(B=2, A=24, seed=7):
    """K5/K6's plain-version arguments at (B, A) x 256: the first layer of a
    production ViSNet (random weights from a seed), numpy inputs, a 5 A
    graph with the last fragment's last 3 slots masked, and cotangents."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
    cfg = ViSNetConfig()
    w = TL.layer_weights(init_params(cfg, torch.Generator().manual_seed(0))["layers"][0], H, NH,
                         False)
    mask = torch.ones((B, A), dtype=torch.bool)
    mask[-1, A - 3:] = False
    adj, _, dist, d_sh = dense_graph(r(B, A, 3, sc=2.5), mask, cfg)
    adj = adj.float()
    fwd = (r(B, A, H, sc=0.5), r(B, S, A, H, sc=0.3), r(B, A, A, H, sc=0.2) * adj[..., None],
           d_sh.permute(0, 3, 1, 2).contiguous(), dist, adj, w, CUTOFF, NH, False)
    cot = (r(B, A, H, sc=1.0), r(B, S, A, H, sc=1.0), r(B, A, A, H, sc=1.0) * adj[..., None])
    return fwd, cot


@pytest.mark.parametrize("which", ["edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "edge_bwd_upd_rc",
                                   "vislayer_fwd", "vislayer_bwd"])
def test_plain_versions_with_the_split_stay_within_edge_tol(which):
    """K1's, K2's, K3's and K8's plain versions with their products taken
    through the split, at Chignolin's (4, 40) shape and H = 256, against the
    same plain versions in float32 (K3/K8 summing into a given g_edge); and
    K5's and K6's (every product of the layer, the backward's transposed
    ones included) at (2, 24) x 256."""
    if which.startswith("vislayer"):
        fwd, cot = _layer_case()
        if which == "vislayer_fwd":
            _close(TL.vislayer_fwd_plain(*fwd, mm=T.mm_tf32x3_plain),
                   TL.vislayer_fwd_plain(*fwd), which)
        else:
            bwd = (*fwd[:7], None, *cot, *fwd[7:])
            _close(TL.vislayer_bwd_plain(*bwd, mm=T.mm_tf32x3_plain),
                   TL.vislayer_bwd_plain(*bwd), which)
        return
    a = _edge_inputs()
    core = (a["q"], a["k"], a["v"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"],
            a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], CUTOFF, NH)
    upd = dict(wt=a["wt"], wsrc=a["wsrc"], w_f=a["w_f"], b_f=a["b_f"])
    ref = TK.edge_fwd_plain(*core, **upd)
    if which == "edge_fwd":
        _close(TK.edge_fwd_plain(*core, **upd, mm=T.mm_tf32x3_plain), ref, which)
        return
    if which in ("edge_bwd_upd", "edge_bwd_upd_rc"):
        g_df = torch.from_numpy(np.random.default_rng(5).standard_normal(ref[5].shape)
                                .astype(np.float32)) * a["adj"][..., None]
        g_edge = torch.randn(ref[5].shape, generator=torch.Generator().manual_seed(6))
        if which == "edge_bwd_upd":
            fn = lambda **kw: TK.edge_bwd_upd_plain(a["adj"], a["wt"], a["wsrc"], a["w_f"], ref[5],
                                                    g_df, g_edge.clone(), **kw)
        else:
            fn = lambda **kw: TK.edge_bwd_upd_rc_plain(a["edge"], a["adj"], a["wt"], a["wsrc"],
                                                       a["w_f"], a["b_f"], g_df, g_edge.clone(),
                                                       **kw)
        _close(fn(mm=T.mm_tf32x3_plain), fn(), which)
        return
    zdkv, zs = ref[3], ref[4]
    args = (a["q"], a["k"], a["v"], a["vec"], zdkv, zs, a["d_sh"], a["dist"], a["adj"],
            a["w_dkv"], a["w_s"], a["g_x"], a["g_va"], CUTOFF, NH)
    _close(TK.edge_bwd_msg_plain(*args, mm=T.mm_tf32x3_plain),
           TK.edge_bwd_msg_plain(*args), which)


def test_mm_tf32x3_takes_the_plain_model_on_the_cpu_and_raises_elsewhere():
    x, w = _operands(256, rows=16)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(T.mm_tf32x3(tx, tw), T.mm_tf32x3_plain(tx, tw))
    with pytest.raises(ValueError, match="CUDA"):
        T.mm_tf32x3(tx.to("meta"), tw.to("meta"))
