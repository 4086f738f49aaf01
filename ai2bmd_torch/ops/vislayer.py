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
from ai2bmd_torch.ops.vismp import check_layer_shapes, edge_fwd_plain, route

_f32 = torch.float32
_LN_EPS = 1e-5

WEIGHT_NAMES = ("ln_s", "ln_b", "vln_w", "w_qkv", "b_qkv", "w_vp", "w_dkv", "b_dkv",
                "w_s", "b_s", "w_o", "b_o", "w_t", "w_src", "w_f", "b_f", "pool")

# The pointer fields of ``struct Layer`` (csrc/vislayer.cuh), in order.
PTR_FIELDS = (
    "x", "vec", "edge", "dsh", "dist", "adj",
    "ln_s", "ln_b", "vln_w", "w_qkv", "b_qkv", "w_vp", "w_dkv", "b_dkv", "w_s", "b_s",
    "w_o", "b_o", "w_t", "w_src", "w_f", "b_f",
    "xagg_in", "gx2", "gvec2", "gedge2",
    "xn", "vecn", "qkv", "proj", "o",
    "z", "v_e", "s_e", "g_e", "gS_e",
    "xo", "xv", "gxagg", "gqkv", "gvecn", "gxh",
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
                       last: bool, mm=torch.matmul):
    """Plain version of K5: (x', vec', edge', x_agg).  The layer of
    ``vis_mp_layer`` plus the residual adds, through K1's plain edge core
    (silu activations, vecnorm "none").  ``mm`` takes every product (the
    kernel's split: ``ops.tf32x3.mm_tf32x3_plain``)."""
    (ln_s, ln_b, vln_w, w_qkv, b_qkv, w_vp, w_dkv, b_dkv, w_s, b_s, w_o, b_o,
     w_t, w_src, w_f, b_f, _pool) = weights
    H = x.shape[-1]
    q, k, v = (mm(_layer_norm(x, ln_s, ln_b), w_qkv) + b_qkv).split(H, dim=-1)
    vecn = vec * vln_w                                          # [B,S,A,H]
    vec1, vec2, vec3 = mm(vecn, w_vp).split(H, dim=-1)
    upd = {} if last else dict(wt=mm(vecn, w_t).transpose(1, 2),
                               wsrc=mm(vecn, w_src).transpose(1, 2), w_f=w_f, b_f=b_f)
    x_agg, vec_agg, df = edge_fwd_plain(
        q, k, v, vecn.transpose(1, 2), edge, d_sh.permute(0, 2, 3, 1), dist, adj,
        w_dkv, b_dkv, w_s, b_s, cutoff, nh, **upd, mm=mm)[:3]
    o1, o2, o3 = (mm(x_agg, w_o) + b_o).split(H, dim=-1)
    x2 = x + (vec1 * vec2).sum(1) * o2 + o3
    vec_out = vec + vec3 * o1[:, None] + vec_agg.transpose(1, 2)
    edge2 = edge.clone() if last else edge + df
    return x2, vec_out, edge2, x_agg


def vislayer_bwd_plain(x, vec, edge, d_sh, dist, adj, weights, xagg, gx2, gvec2, gedge2,
                       cutoff: float, nh: int, last: bool, mm=torch.matmul):
    """Plain version of K6: the VJP of ``vislayer_fwd_plain`` recomputed from
    the layer inputs, (gx, gvec, gedge, gd_sh, gdist).  No weight cotangents;
    gedge holds the residual passthrough gedge2 (for the last layer too,
    ``vislayer.py:593-595``).  ``xagg`` is recomputed, not read.  ``mm``
    takes every product, the transposed ones of the backward included."""
    del xagg
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, vec, edge, d_sh, dist)]
        outs = vislayer_fwd_plain(*ins, adj, [w.detach() for w in weights], cutoff, nh,
                                  last, mm=_with_vjp(mm))[:3]
        return torch.autograd.grad(outs, ins, (gx2, gvec2, gedge2))


def _with_vjp(mm):
    """``mm`` for x @ w with the cotangent of x taken by ``mm`` too:
    g_x = mm(g, w^T).  The weights get no cotangent (the kernels give none)."""
    if mm is torch.matmul:
        return mm

    class _Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(w)
            return mm(x, w)

        @staticmethod
        def backward(ctx, g):
            (w,) = ctx.saved_tensors
            return mm(g, w.T), None

    return _Product.apply


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_I, _F = _build.I, _build.F
# the inputs the kernels' products and epilogues read in 16- or 8-byte chunks
_ALIGNED = ("edge", "w_qkv", "w_vp", "w_dkv", "w_s", "w_o", "w_t", "w_src", "w_f", "xagg_in",
            "gvec2", "gedge2")
# (pointers, their count, B, A, H, S, cutoff, last, channels a head)
_ARGS = [ctypes.POINTER(ctypes.c_void_p), _I, _I, _I, _I, _I, _F, _I, _I]


def _inputs(x, vec, edge, d_sh, dist, adj, weights, nh):
    """Check the layer's inputs for the kernels.  Returns (B, A, H, S) and the
    inputs keyed by their ``Layer`` field; the head pool is checked and left
    out (the kernels sum each head's H / nh lanes instead, an instantiation
    for 8, 16, 32 or 64 channels a head)."""
    B, A, H = x.shape
    S = vec.shape[1]
    check_layer_shapes(A, H, S, nh)
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


def _launch(name: str, ptrs: dict, B, A, H, S, cutoff, last, nh):
    unknown = set(ptrs) - set(PTR_FIELDS)
    if unknown:
        raise KeyError(f"not a field of Layer: {sorted(unknown)}")
    # the products copy 16-byte chunks of their X rows and weights
    unaligned = [f for f, t in ptrs.items()
                 if t is not None and f in _ALIGNED and t.data_ptr() % 16]
    if unaligned:
        raise ValueError(f"fused-layer kernels need 16-byte aligned tensors: {unaligned}")
    arr = (ctypes.c_void_p * len(PTR_FIELDS))(
        *[None if ptrs.get(f) is None else ptrs[f].data_ptr() for f in PTR_FIELDS])
    _build.call(name, _ARGS, arr, len(PTR_FIELDS), B, A, H, S, float(cutoff), int(last),
                H // nh)


def _node_scratch(new, B, A, H, S, last):
    """The node rows both kernels hand between their stages (csrc/vislayer.cuh)."""
    return dict(xn=new(B * A, H), vecn=new(B * S * A, H), qkv=new(B * A, 3 * H),
                proj=new(B * S * A, (3 if last else 5) * H), o=new(B * A, 3 * H))


def vislayer_fwd(x, vec, edge, d_sh, dist, adj, weights, cutoff: float, nh: int, last: bool):
    """K5.  Returns (x', vec', edge', x_agg)."""
    if not route(x, "fused-layer"):
        return vislayer_fwd_plain(x, vec, edge, d_sh, dist, adj, weights, cutoff, nh, last)
    (B, A, H, S), t = _inputs(x, vec, edge, d_sh, dist, adj, weights, nh)
    new = lambda *s: torch.empty(s, dtype=_f32, device=x.device)
    E = B * A * A
    t.update(_node_scratch(new, B, A, H, S, last), z=new(E, 2 * H), v_e=new(E, H),
             s_e=new(E, 2 * H), x2=new(B, A, H), vec2=new(B, S, A, H), edge2=new(B, A, A, H),
             xagg=new(B, A, H))
    _launch("vislayer_fwd_launch", t, B, A, H, S, cutoff, last, nh)
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
    E, NP = B * A * A, 3 if last else 5
    t.update(
        _node_scratch(new, B, A, H, S, last), xagg_in=xagg, gx2=gx2, gvec2=gvec2,
        gedge2=gedge2, z=new(E, 3 * H), v_e=new(E, H), s_e=new(E, 2 * H), g_e=new(E, 2 * H),
        gS_e=None if last else new(E, H), xo=new(B * A, 3 * H), xv=new(B * S * A, NP * H),
        gxagg=new(B * A, H), gqkv=new(B * A, 3 * H), gvecn=new(B * S * A, H),
        gxh=new(B * A, H), gx=new(B, A, H), gvec=new(B, S, A, H), gedge=new(B, A, A, H),
        gdsh=new(B, S, A, A), gdist=new(B, A, A))
    _launch("vislayer_bwd_launch", t, B, A, H, S, cutoff, last, nh)
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
