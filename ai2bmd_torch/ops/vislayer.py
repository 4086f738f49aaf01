"""The complete ViS-MP layer: plain PyTorch versions, kernel wrappers, autograd.

Port of ``ai2bmd_tpu/ops/pallas/vislayer.py``.  One call runs a whole layer,
node projections, edge core, edge update, node update and residual adds:

    xn = LayerNorm(x);  vecn = vec * w_vln
    q|k|v = xn @ W_qkv + b;  vec1|vec2|vec3 = vecn @ W_vp;  vdot = sum_c vec1 * vec2
    wt, ws = vecn @ W_t, vecn @ W_src                  (not the last layer)
    x_agg, vec_agg, df = the edge core of ops/vismp.py
    o1|o2|o3 = x_agg @ W_o + b_o
    x' = x + vdot * o2 + o3;  vec' = vec + vec3 * o1 + vec_agg;  edge' = edge + df

Layout of the JAX package's ``fused_layer``: x [B,A,H]; vec SPHERE-MAJOR
[B,S,A,H]; edge [B,A,A,H]; d_sh sphere-major [B,S,A,A]; dist, adj [B,A,A];
the weights in the order of ``layer_weights``.

Two kernels (``csrc/``) and their plain versions:

  vislayer_fwd  (K5)  (x', vec', edge', x_agg)
  vislayer_bwd  (K6)  (gx, gvec, gedge, gd_sh, gdist), recomputed from the
                      layer inputs and x_agg (no stored activations)

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors; there is no other route.  ``fused_layer`` is what the
model calls.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ai2bmd_torch.ops import LAUNCHES, _build
from ai2bmd_torch.ops.vismp import check_shapes, edge_fwd_plain, route

_f32 = torch.float32
_LN_EPS = 1e-5

WEIGHT_NAMES = ("ln_s", "ln_b", "vln_w", "w_qkv", "b_qkv", "w_vp", "w_dkv", "b_dkv",
                "w_s", "b_s", "w_o", "b_o", "w_t", "w_src", "w_f", "b_f", "pool")

# The pointer fields of ``struct Layer`` (csrc/vislayer.cuh), in order.
PTR_FIELDS = (
    "x", "vec", "edge", "dsh", "dist", "adj",
    "ln_s", "ln_b", "vln_w", "w_qkv", "b_qkv", "w_vp", "w_dkv", "b_dkv", "w_s", "b_s",
    "w_o", "b_o", "w_t", "w_src", "w_f", "b_f",
    "w_qkvT", "w_oT", "w_catT", "w_dkvT", "w_sT", "w_fT",
    "xagg_in", "gx2", "gvec2", "gedge2",
    "qkv", "proj", "vecagg", "o", "gxagg", "gqkv", "gw", "gvecn", "gk_e", "gv_e", "s1_e",
    "gs_e",
    "x2", "vec2", "edge2", "xagg",
    "gx", "gvec", "gedge", "gdsh", "gdist",
)


def head_pool_matrix(H: int, nh: int) -> np.ndarray:
    """[H, nh] 0/1 matrix summing each head's channels (the TPU kernels'
    per-head reduction, ``ai2bmd_tpu/ops/pallas/vismp.py:248``)."""
    dh = H // nh
    m = np.zeros((H, nh), np.float32)
    for h in range(nh):
        m[h * dh:(h + 1) * dh, h] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _constants(H: int, nh: int, dtype: torch.dtype, device: torch.device):
    """The head pool and the zero W_t/W_src/W_f/b_f of the last layer, made
    once per device instead of in every call."""
    pool = torch.as_tensor(head_pool_matrix(H, nh), dtype=dtype, device=device)
    zH = torch.zeros((H, H), dtype=dtype, device=device)
    return pool, zH, torch.zeros((H,), dtype=dtype, device=device)


def layer_weights(lp: dict, H: int, nh: int, last: bool, dtype=_f32) -> tuple:
    """The fused-layer weight tuple from a ViSNet layer's parameters, in the
    order of ``ai2bmd_tpu/ops/pallas/vislayer.py:603-632``.  The last layer
    gets zero W_t, W_src, W_f and b_f, which the kernels never multiply."""
    w_qkv = torch.cat([lp["q_proj"]["w"], lp["k_proj"]["w"], lp["v_proj"]["w"]], dim=1)
    b_qkv = torch.cat([lp["q_proj"]["b"], lp["k_proj"]["b"], lp["v_proj"]["b"]])
    w_dkv = torch.cat([lp["dk_proj"]["w"], lp["dv_proj"]["w"]], dim=1)
    b_dkv = torch.cat([lp["dk_proj"]["b"], lp["dv_proj"]["b"]])
    pool, zH, zb = _constants(H, nh, dtype, w_qkv.device)
    if last:
        wt, wsrc, wf, bf = zH, zH, zH, zb
    else:
        wt, wsrc = lp["w_trg_proj"]["w"], lp["w_src_proj"]["w"]
        wf, bf = lp["f_proj"]["w"], lp["f_proj"]["b"]
    return (
        lp["layernorm"]["scale"], lp["layernorm"]["bias"], lp["vec_layernorm"]["weight"],
        w_qkv, b_qkv, lp["vec_proj"]["w"], w_dkv, b_dkv,
        lp["s_proj"]["w"], lp["s_proj"]["b"], lp["o_proj"]["w"], lp["o_proj"]["b"],
        wt, wsrc, wf, bf, pool,
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _LN_EPS) * scale + bias


def vislayer_fwd_plain(x, vec, edge, d_sh, dist, adj, weights, cutoff: float, nh: int,
                       last: bool):
    """Plain version of K5: (x', vec', edge', x_agg).  The layer of
    ``vis_mp_layer`` plus the residual adds, through K1's plain edge core
    (silu activations, vecnorm "none")."""
    (ln_s, ln_b, vln_w, w_qkv, b_qkv, w_vp, w_dkv, b_dkv, w_s, b_s, w_o, b_o,
     w_t, w_src, w_f, b_f, _pool) = weights
    H = x.shape[-1]
    q, k, v = (_layer_norm(x, ln_s, ln_b) @ w_qkv + b_qkv).split(H, dim=-1)
    vecn = vec * vln_w                                          # [B,S,A,H]
    vec1, vec2, vec3 = (vecn @ w_vp).split(H, dim=-1)
    upd = {} if last else dict(wt=(vecn @ w_t).transpose(1, 2),
                               wsrc=(vecn @ w_src).transpose(1, 2), w_f=w_f, b_f=b_f)
    x_agg, vec_agg, df = edge_fwd_plain(
        q, k, v, vecn.transpose(1, 2), edge, d_sh.permute(0, 2, 3, 1), dist, adj,
        w_dkv, b_dkv, w_s, b_s, cutoff, nh, **upd)[:3]
    o1, o2, o3 = (x_agg @ w_o + b_o).split(H, dim=-1)
    x2 = x + (vec1 * vec2).sum(1) * o2 + o3
    vec_out = vec + vec3 * o1[:, None] + vec_agg.transpose(1, 2)
    edge2 = edge.clone() if last else edge + df
    return x2, vec_out, edge2, x_agg


def vislayer_bwd_plain(x, vec, edge, d_sh, dist, adj, weights, xagg, gx2, gvec2, gedge2,
                       cutoff: float, nh: int, last: bool):
    """Plain version of K6: the VJP of ``vislayer_fwd_plain`` recomputed from
    the layer inputs, (gx, gvec, gedge, gd_sh, gdist).  No weight cotangents;
    gedge holds the residual passthrough gedge2 (for the last layer too,
    ``vislayer.py:593-595``).  ``xagg`` is recomputed, not read."""
    del xagg
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, vec, edge, d_sh, dist)]
        outs = vislayer_fwd_plain(*ins, adj, [w.detach() for w in weights], cutoff, nh,
                                  last)[:3]
        return torch.autograd.grad(outs, ins, (gx2, gvec2, gedge2))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_I, _F = _build.I, _build.F
# (pointers, their count, B, A, H, S, cutoff, last)
_ARGS = [ctypes.POINTER(ctypes.c_void_p), _I, _I, _I, _I, _I, _F, _I]


def _inputs(x, vec, edge, d_sh, dist, adj, weights, nh):
    """Check the layer's inputs for the kernels.  Returns (B, A, H, S) and the
    inputs keyed by their ``Layer`` field; the head pool is checked and left
    out (the kernels sum each warp's 32 channels instead)."""
    B, A, H = x.shape
    S = vec.shape[1]
    check_shapes(A, H, S, nh, "fused-layer")
    shapes = dict(
        x=(B, A, H), vec=(B, S, A, H), edge=(B, A, A, H), dsh=(B, S, A, A), dist=(B, A, A),
        adj=(B, A, A), ln_s=(H,), ln_b=(H,), vln_w=(H,), w_qkv=(H, 3 * H), b_qkv=(3 * H,),
        w_vp=(H, 3 * H), w_dkv=(H, 2 * H), b_dkv=(2 * H,), w_s=(H, 2 * H), b_s=(2 * H,),
        w_o=(H, 3 * H), b_o=(3 * H,), w_t=(H, H), w_src=(H, H), w_f=(H, H), b_f=(H,),
        pool=(H, nh))
    named = dict(zip(("x", "vec", "edge", "dsh", "dist", "adj"),
                     (x, vec, edge, d_sh, dist, adj)), **dict(zip(WEIGHT_NAMES, weights)))
    for name, t in named.items():
        _build.check(name, t, shapes[name], device=x.device)
    del named["pool"]
    return (B, A, H, S), named


def _launch(name: str, ptrs: dict, B, A, H, S, cutoff, last):
    unknown = set(ptrs) - set(PTR_FIELDS)
    if unknown:
        raise KeyError(f"not a field of Layer: {sorted(unknown)}")
    arr = (ctypes.c_void_p * len(PTR_FIELDS))(
        *[None if ptrs.get(f) is None else ptrs[f].data_ptr() for f in PTR_FIELDS])
    _build.call(name, _ARGS, arr, len(PTR_FIELDS), B, A, H, S, float(cutoff), int(last))


def vislayer_fwd(x, vec, edge, d_sh, dist, adj, weights, cutoff: float, nh: int, last: bool):
    """K5.  Returns (x', vec', edge', x_agg)."""
    if not route(x, "fused-layer"):
        return vislayer_fwd_plain(x, vec, edge, d_sh, dist, adj, weights, cutoff, nh, last)
    (B, A, H, S), t = _inputs(x, vec, edge, d_sh, dist, adj, weights, nh)
    new = lambda *s: torch.empty(s, dtype=_f32, device=x.device)
    NP = 3 if last else 5
    t.update(qkv=new(B * A, 3 * H), proj=new(B * S * A, NP * H), vecagg=new(B, S, A, H),
             x2=new(B, A, H), vec2=new(B, S, A, H), edge2=new(B, A, A, H), xagg=new(B, A, H))
    _launch("vislayer_fwd_launch", t, B, A, H, S, cutoff, last)
    LAUNCHES["vislayer_fwd"] += 1
    return t["x2"], t["vec2"], t["edge2"], t["xagg"]


def vislayer_bwd(x, vec, edge, d_sh, dist, adj, weights, xagg, gx2, gvec2, gedge2,
                 cutoff: float, nh: int, last: bool):
    """K6.  Returns (gx, gvec, gedge, gd_sh, gdist); gedge includes gedge2."""
    if not route(x, "fused-layer"):
        return vislayer_bwd_plain(x, vec, edge, d_sh, dist, adj, weights, xagg, gx2, gvec2,
                                  gedge2, cutoff, nh, last)
    (B, A, H, S), t = _inputs(x, vec, edge, d_sh, dist, adj, weights, nh)
    for name, g, shape in (("xagg", xagg, (B, A, H)), ("gx2", gx2, (B, A, H)),
                           ("gvec2", gvec2, (B, S, A, H)), ("gedge2", gedge2, (B, A, A, H))):
        _build.check(name, g, shape, device=x.device)
    new = lambda *s: torch.empty(s, dtype=_f32, device=x.device)
    w_cat = t["w_vp"] if last else torch.cat([t["w_vp"], t["w_t"], t["w_src"]], dim=1)
    NP = 3 if last else 5
    t.update(
        w_qkvT=t["w_qkv"].t().contiguous(), w_oT=t["w_o"].t().contiguous(),
        w_catT=w_cat.t().contiguous(), w_dkvT=t["w_dkv"].t().contiguous(),
        w_sT=t["w_s"].t().contiguous(), w_fT=None if last else t["w_f"].t().contiguous(),
        xagg_in=xagg, gx2=gx2, gvec2=gvec2, gedge2=gedge2,
        qkv=new(B * A, 3 * H), proj=new(B * S * A, NP * H), o=new(B * A, 3 * H),
        gxagg=new(B * A, H), gqkv=new(B * A, 3 * H), gvecn=new(B * S * A, H),
        gw=None if last else new(B * S * A, 2 * H),
        gk_e=new(B, A, A, H), gv_e=new(B, A, A, H), s1_e=new(B, A, A, H),
        gs_e=None if last else new(B, A, A, H),
        gx=new(B, A, H), gvec=new(B, S, A, H), gedge=new(B, A, A, H), gdsh=new(B, S, A, A),
        gdist=new(B, A, A))
    _launch("vislayer_bwd_launch", t, B, A, H, S, cutoff, last)
    LAUNCHES["vislayer_bwd"] += 1
    return t["gx"], t["gvec"], t["gedge"], t["gdsh"], t["gdist"]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedLayer(torch.autograd.Function):
    """One layer through K5 forward and K6 backward (their plain versions on
    CPU tensors).  Saves the layer inputs and x_agg; the backward recomputes
    the rest.  The gradient flows to x, vec, edge, d_sh and dist.  adj and
    the weights get NO gradient (None; the reference returns zeros,
    ``vislayer.py:596-597``): forces differentiate positions only, so
    training must use the per-layer path."""

    @staticmethod
    def forward(ctx, x, vec, edge, d_sh, dist, adj, cutoff, nh, last, *weights):
        x2, vec2, edge2, xagg = vislayer_fwd(x, vec, edge, d_sh, dist, adj, weights,
                                             cutoff, nh, last)
        ctx.save_for_backward(x, vec, edge, d_sh, dist, adj, xagg, *weights)
        ctx.cfg = (cutoff, nh, last)
        return x2, vec2, edge2

    @staticmethod
    def backward(ctx, gx2, gvec2, gedge2):
        x, vec, edge, d_sh, dist, adj, xagg, *weights = ctx.saved_tensors
        grads = vislayer_bwd(x, vec, edge, d_sh, dist, adj, weights, xagg, gx2.contiguous(),
                             gvec2.contiguous(), gedge2.contiguous(), *ctx.cfg)
        return (*grads, None, None, None, None) + (None,) * len(weights)


def fused_layer(cutoff: float, nh: int, last: bool):
    """The JAX package's ``fused_layer(cutoff, nh, last)``: returns
    f(x, vec_sm, edge, d_sh_sm, dist, adj_f, *weights) -> (x', vec', edge')
    with vec and d_sh sphere-major, weights as ``layer_weights`` orders them."""

    def f(x, vec_sm, edge, d_sh_sm, dist, adj_f, *weights):
        cont = [t.contiguous() for t in (x, vec_sm, edge, d_sh_sm, dist, adj_f)]
        return FusedLayer.apply(*cont, cutoff, nh, last, *(w.contiguous() for w in weights))

    return f
