"""ViS-MP edge core: plain PyTorch versions, kernel wrappers, autograd.

Port of ``ai2bmd_tpu/ops/pallas/vismp.py``.  Shapes follow the JAX package's
public layout: q/k/v [B,A,H]; vec, wt, wsrc [B,A,S,H]; edge [B,A,A,H];
d_sh [B,A,A,S]; dist, adj [B,A,A] (adj as a float mask, self loops
included); linear weights [in, out] as in JAX.  Axis 1 is the centre atom i,
axis 2 the source atom j.

Five kernels (``csrc/``; K7 and K8 are the recompute instantiations of the
templates in K2's and K3's sources) and their plain versions:

  edge_fwd         (K1)  x_agg, vec_agg [, df] [, zdkv, zs, zf]
  edge_bwd_msg     (K2)  backward of x_agg, vec_agg from the stored zdkv, zs
  edge_bwd_upd     (K3)  backward of df from the stored zf; sums its g_edge
                         into the message path's g_edge in place
  edge_bwd_msg_rc  (K7)  backward of x_agg, vec_agg, recomputing zdkv and zs
                         from the edge rows
  edge_bwd_upd_rc  (K8)  backward of df, recomputing zf from the edge rows
                         (g_edge as K3)

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors; there is no other route.  ``edge_core`` is what the model
calls: the plain forward (differentiable in every input, weights included)
on the CPU, ``FusedVisMP`` on the card.  ``FusedVisMP`` has two routes for
the backward: the stash route (K1 stores zdkv, zs, zf; K2/K3 read them) and,
with ``recompute=True``, the memory-lean route (K1 stores nothing; K7/K8
rebuild the pre-activations), which ``edge_core(recompute=True)`` takes on
the CPU too, there through the plain versions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ai2bmd_torch.ops import LAUNCHES, _build

_f32 = torch.float32


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    return 0.5 * (torch.cos(dist * (math.pi / cutoff)) + 1.0) * (dist < cutoff)


def dsilu(z: torch.Tensor) -> torch.Tensor:
    sg = torch.sigmoid(z)
    return sg * (1.0 + z * (1.0 - sg))


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """Sum each head's dh channels: [..., H] -> [..., nh]."""
    return x.unflatten(-1, (nh, x.shape[-1] // nh)).sum(-1)


def _per_channel(x: torch.Tensor, H: int) -> torch.Tensor:
    """Broadcast a per-head value to its channels: [..., nh] -> [..., H]."""
    return x.repeat_interleave(H // x.shape[-1], dim=-1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "swish": F.silu,
    "ssp": lambda x: F.softplus(x) - math.log(2.0),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def edge_fwd_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                   cutoff: float, nh: int, wt=None, wsrc=None, w_f=None, b_f=None,
                   act: str = "silu", attn_act: str = "silu", mm=torch.matmul):
    """Plain version of K1: (x_agg, vec_agg, df, zdkv, zs, zf), df and zf None
    without the update.  The same math as the jnp branch of
    ``ai2bmd_tpu/models/visnet.py:416-474`` and ``vismp.reference_edge_block``
    / ``reference_edge_update`` (:334, :437); the kernel hardwires silu, the
    plain version also takes the config's other activations.  ``mm`` takes
    the edge products (``tf32x3.mm_tf32x3_plain`` models the kernel's)."""
    H = q.shape[-1]
    act_fn, attn_fn = _ACTS[act], _ACTS[attn_act]
    adj_e = adj[..., None]
    zdkv = mm(edge, w_dkv) + b_dkv
    dk, dv = act_fn(zdkv).split(H, dim=-1)
    a = _heads(q[:, :, None] * k[:, None] * dk, nh)
    gate = (cosine_cutoff(dist, cutoff) * adj)[..., None]
    v_ij = v[:, None] * dv * (_per_channel(attn_fn(a), H) * gate)
    zs = mm(v_ij, w_s) + b_s
    s1, s2 = (act_fn(zs) * adj_e).split(H, dim=-1)
    x_agg = v_ij.sum(2)
    vec_agg = (torch.einsum("bjch,bijh->bich", vec, s1)
               + torch.einsum("bijh,bijc->bich", s2, d_sh))
    df = zf = None
    if wt is not None:
        zf = mm(edge, w_f) + b_f
        df = act_fn(zf) * torch.einsum("bich,bjch->bijh", wt, wsrc) * adj_e
    return x_agg, vec_agg, df, zdkv, zs, zf


def edge_bwd_msg_plain(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                       g_xagg, g_vecagg, cutoff: float, nh: int, mm=torch.matmul):
    """Plain version of K2: the message-path VJP from the stored zdkv and zs,
    the math of ``_bwd_msg_kernel_sa`` (vismp.py:757).  Returns
    (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist); ``mm`` takes the edge
    products."""
    H = q.shape[-1]
    adj_e = adj[..., None]
    zk, zv = zdkv.split(H, dim=-1)
    dk, dv = F.silu(zk), F.silu(zv)
    q_i, k_j, v_j = q[:, :, None], k[:, None], v[:, None]
    a = _heads(q_i * k_j * dk, nh)
    att = _per_channel(F.silu(a), H)
    gate = (cosine_cutoff(dist, cutoff) * adj)[..., None]
    g3 = att * gate
    z1, z2 = zs.split(H, dim=-1)
    s1, s2 = F.silu(z1) * adj_e, F.silu(z2) * adj_e

    g_s1 = torch.einsum("bich,bjch->bijh", g_vecagg, vec)
    g_s2 = torch.einsum("bich,bijc->bijh", g_vecagg, d_sh)
    g_vec = torch.einsum("bijh,bich->bjch", s1, g_vecagg)
    g_dsh = torch.einsum("bich,bijh->bijc", g_vecagg, s2)
    g_s = torch.cat([g_s1 * adj_e, g_s2 * adj_e], dim=-1) * dsilu(zs)
    g_vij = mm(g_s, w_s.T) + g_xagg[:, :, None]

    g_v = (g_vij * dv * g3).sum(1)
    g_dv = g_vij * v_j * g3
    g_g3 = g_vij * v_j * dv
    inside = (dist < cutoff).to(q.dtype)
    dcut = -0.5 * (math.pi / cutoff) * torch.sin(dist * (math.pi / cutoff)) * inside
    g_dist = (g_g3 * att).sum(-1) * adj * dcut
    g_p = _per_channel(_heads(g_g3 * gate, nh) * dsilu(a), H)
    g_q = (g_p * k_j * dk).sum(2)
    g_k = (g_p * q_i * dk).sum(1)
    g_dk = g_p * q_i * k_j
    g_edge = mm(torch.cat([g_dk, g_dv], dim=-1) * dsilu(zdkv), w_dkv.T)
    return g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist


def edge_bwd_upd_plain(adj, wt, wsrc, w_f, zf, g_df, g_edge=None, mm=torch.matmul):
    """Plain version of K3: the edge-update VJP from the stored zf, the math
    of ``_bwd_upd_kernel_sa`` (vismp.py:852).  Returns (g_edge, g_wt, g_wsrc).
    Given ``g_edge`` (the message path's, [B,A,A,H]), the edge gradient is
    added into it in place and that tensor is returned, as the kernel does;
    ``mm`` takes the edge product."""
    g = g_df * adj[..., None]
    g_s = g * F.silu(zf)
    s_ij = torch.einsum("bich,bjch->bijh", wt, wsrc)
    g_wt = torch.einsum("bijh,bjch->bich", g_s, wsrc)
    g_wsrc = torch.einsum("bijh,bich->bjch", g_s, wt)
    prod = mm(g * s_ij * dsilu(zf), w_f.T)
    return (prod if g_edge is None else g_edge.add_(prod)), g_wt, g_wsrc


def edge_bwd_msg_rc_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                          g_xagg, g_vecagg, cutoff: float, nh: int):
    """Plain version of K7, the math of ``_bwd_msg_kernel`` (vismp.py:615):
    zdkv and zs recomputed from the layer inputs, then K2's plain version.
    Returns (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist)."""
    zdkv, zs = edge_fwd_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                              cutoff, nh)[3:5]
    return edge_bwd_msg_plain(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                              g_xagg, g_vecagg, cutoff, nh)


def edge_bwd_upd_rc_plain(edge, adj, wt, wsrc, w_f, b_f, g_df, g_edge=None, mm=torch.matmul):
    """Plain version of K8, the math of ``_bwd_upd_kernel`` (vismp.py:714):
    zf = edge @ W_f + b_f recomputed, then K3's plain version (``g_edge``
    and ``mm`` as there).  Returns (g_edge, g_wt, g_wsrc)."""
    return edge_bwd_upd_plain(adj, wt, wsrc, w_f, mm(edge, w_f) + b_f, g_df, g_edge, mm)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = _build.P, _build.I, _build.F
_FWD_ARGS = [_P] * 22 + [_I, _I, _I, _I, _F, _I, _I, _I]
_MSG_ARGS = [_P] * 22 + [_I, _I, _I, _I, _F, _I]
_UPD_ARGS = [_P] * 10 + [_I] * 4
_MSG_RC_ARGS = [_P] * 26 + [_I, _I, _I, _I, _F, _I]
_UPD_RC_ARGS = [_P] * 12 + [_I] * 4


def route(t: torch.Tensor, kernels: str = "edge-core") -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    raise ValueError(f"no {kernels} implementation for device {t.device}")


# Every centre pass of the edge kernels (K1-K3, K7, K8) and of the
# full-layer kernels (K5/K6) walks a centre's sources in chunks of 48 rows
# (``ECHUNK`` in csrc/common.cuh), so they take any A % 8 == 0 up to
# EDGE_MAXA: a fragment or a whole molecule (abd, the largest bundled
# protein, is 752 slots).  A head's sum takes its DH = H / nh lanes, with
# DH a template parameter of 8, 16, 32 or 64 (``head_sum``; a head of 64
# channels spans two warps).  The launchers check the same limits.
EDGE_MAXA = 1024
HEAD_WIDTHS = (8, 16, 32, 64)
# the shapes the kernels do not take yet, where the JAX package's Pallas
# kernels run: refused on the card
UNSUPPORTED = "ROADMAP.md, Queue 2: domain still to extend"
SILU = ("silu", "swish")


def plain_activations(act: str, attn_act: str):
    """Why a model with these activations runs its edge core through the
    plain version, or None when the kernels compute them: the JAX dispatch's
    ``use_fused`` sends every activation but silu to jnp
    (``ai2bmd_tpu/models/visnet.py:384-390``), so the plain edge core is the
    faithful port there, on the card too (``models.visnet.resolve_config``)."""
    if act not in SILU or attn_act not in SILU:
        return f"activations {act!r}/{attn_act!r}: the kernels compute silu"
    return None


def unsupported_shapes(H: int, nh: int, S: int):
    """Why the kernels cannot take a model of H channels, nh heads and S
    spherical components, or None when they can."""
    if H % nh or H // nh not in HEAD_WIDTHS or H % 32 or H > 256 or S > 8:
        return (f"H={H}, nh={nh}, S={S}: the kernels take heads of 8, 16, 32 or 64 channels, "
                f"H a multiple of 32 up to 256 and S <= 8 ({UNSUPPORTED})")
    return None


def check_shapes(A, H, S, nh, kernels: str = "edge"):
    """The shapes the edge kernels (K1-K3, K7, K8) and the full-layer kernels
    take; anything else raises (the card has no plain route for them)."""
    if unsupported_shapes(H, nh, S) or A > EDGE_MAXA or A % 8:
        raise ValueError(
            f"{kernels} kernels take heads of 8, 16, 32 or 64 channels, H a multiple of 32 up "
            f"to 256, A a multiple of 8 up to {EDGE_MAXA}, S <= 8; got H={H}, nh={nh}, A={A}, "
            f"S={S} (H > 256 and S > 8 on the card: {UNSUPPORTED})"
        )


def check_layer_shapes(A, H, S, nh):
    """The shapes the full-layer kernels K5/K6 take: the edge kernels', a
    fragment or a whole molecule of up to EDGE_MAXA slots."""
    check_shapes(A, H, S, nh, "fused-layer")


def edge_fwd(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
             cutoff: float, nh: int, wt=None, wsrc=None, w_f=None, b_f=None,
             store: bool = False):
    """K1.  Returns (x_agg, vec_agg, df, zdkv, zs, zf); df/zf are None without
    the update (wt is None), zdkv/zs/zf None unless ``store``."""
    update = wt is not None
    if not route(q):
        x_agg, vec_agg, df, zdkv, zs, zf = edge_fwd_plain(
            q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
            cutoff, nh, wt, wsrc, w_f, b_f)
        if not store:
            zdkv = zs = zf = None
        return x_agg, vec_agg, df, zdkv, zs, zf
    B, A, H = q.shape
    S = vec.shape[2]
    check_shapes(A, H, S, nh)
    dev = q.device
    c = _build.check
    for name, t, shape in (
        ("q", q, (B, A, H)), ("k", k, (B, A, H)), ("v", v, (B, A, H)),
        ("vec", vec, (B, A, S, H)), ("edge", edge, (B, A, A, H)),
        ("d_sh", d_sh, (B, A, A, S)), ("dist", dist, (B, A, A)),
        ("adj", adj, (B, A, A)), ("w_dkv", w_dkv, (H, 2 * H)),
        ("b_dkv", b_dkv, (2 * H,)), ("w_s", w_s, (H, 2 * H)), ("b_s", b_s, (2 * H,)),
    ):
        c(name, t, shape, device=dev)
    if update:
        for name, t, shape in (("wt", wt, (B, A, S, H)), ("wsrc", wsrc, (B, A, S, H)),
                               ("w_f", w_f, (H, H)), ("b_f", b_f, (H,))):
            c(name, t, shape, device=dev)
    new = lambda *s: torch.empty(s, dtype=_f32, device=dev)
    x_agg, vec_agg = new(B, A, H), new(B, A, S, H)
    df = new(B, A, A, H) if update else None
    zdkv = new(B, A, A, 2 * H) if store else None
    zs = new(B, A, A, 2 * H) if store else None
    zf = new(B, A, A, H) if store and update else None
    p = _build.ptr
    _build.call(
        "edge_fwd_launch", _FWD_ARGS,
        p(q), p(k), p(v), p(vec), p(wt), p(wsrc), p(edge), p(d_sh), p(dist), p(adj),
        p(w_dkv), p(b_dkv), p(w_s), p(b_s), p(w_f), p(b_f),
        p(x_agg), p(vec_agg), p(df), p(zdkv), p(zs), p(zf),
        B, A, H, S, float(cutoff), int(update), int(store), H // nh,
    )
    LAUNCHES["edge_fwd"] += 1
    return x_agg, vec_agg, df, zdkv, zs, zf


def edge_bwd_msg(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                 g_xagg, g_vecagg, cutoff: float, nh: int):
    """K2.  Returns (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist)."""
    if not route(q):
        return edge_bwd_msg_plain(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv,
                                  w_s, g_xagg, g_vecagg, cutoff, nh)
    B, A, H = q.shape
    S = vec.shape[2]
    check_shapes(A, H, S, nh)
    dev = q.device
    wdkvT, wsT = w_dkv.t().contiguous(), w_s.t().contiguous()
    c = _build.check
    for name, t, shape in (
        ("q", q, (B, A, H)), ("k", k, (B, A, H)), ("v", v, (B, A, H)),
        ("vec", vec, (B, A, S, H)), ("zdkv", zdkv, (B, A, A, 2 * H)),
        ("zs", zs, (B, A, A, 2 * H)), ("d_sh", d_sh, (B, A, A, S)),
        ("dist", dist, (B, A, A)), ("adj", adj, (B, A, A)),
        ("w_dkv^T", wdkvT, (2 * H, H)), ("w_s^T", wsT, (2 * H, H)),
        ("g_xagg", g_xagg, (B, A, H)), ("g_vecagg", g_vecagg, (B, A, S, H)),
    ):
        c(name, t, shape, device=dev)
    new = lambda *s: torch.empty(s, dtype=_f32, device=dev)
    g_q, g_k, g_v = new(B, A, H), new(B, A, H), new(B, A, H)
    g_vec, g_edge = new(B, A, S, H), new(B, A, A, H)
    g_dsh, g_dist = new(B, A, A, S), new(B, A, A)
    gk_e, gv_e = new(B, A, A, H), new(B, A, A, H)   # per-edge terms (scratch)
    p = _build.ptr
    _build.call(
        "edge_bwd_msg_launch", _MSG_ARGS,
        p(q), p(k), p(v), p(vec), p(zdkv), p(zs), p(d_sh), p(dist), p(adj),
        p(wdkvT), p(wsT), p(g_xagg), p(g_vecagg),
        p(g_q), p(g_k), p(g_v), p(g_vec), p(g_edge), p(g_dsh), p(g_dist),
        p(gk_e), p(gv_e), B, A, H, S, float(cutoff), H // nh,
    )
    LAUNCHES["edge_bwd_msg"] += 1
    return g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist


def _upd_launch(rc: bool, adj, wt, wsrc, w_f, b_f, zf_or_edge, g_df, g_edge):
    """Launch K3 (``rc`` False, from zf) or K8 (True, from the edge rows) on
    the card.  Returns (g_edge, g_wt, g_wsrc)."""
    B, A, _, H = zf_or_edge.shape
    S = wt.shape[2]
    check_shapes(A, H, S, H // 32)   # K3/K8 sum no head
    dev = zf_or_edge.device
    c = _build.check
    for name, t, shape in (
        ("edge" if rc else "zf", zf_or_edge, (B, A, A, H)), ("adj", adj, (B, A, A)),
        ("wt", wt, (B, A, S, H)), ("wsrc", wsrc, (B, A, S, H)), ("w_f", w_f, (H, H)),
        ("g_df", g_df, (B, A, A, H)),
    ) + ((("b_f", b_f, (H,)),) if rc else ()):
        c(name, t, shape, device=dev)
    new = lambda *s: torch.empty(s, dtype=_f32, device=dev)
    if g_edge is None:
        g_edge = torch.zeros((B, A, A, H), dtype=_f32, device=dev)
    c("g_edge", g_edge, (B, A, A, H), device=dev)
    g_wt, g_wsrc = new(B, A, S, H), new(B, A, S, H)
    gz = new(B, A, A, H)   # scratch: g_zf for the row-tile product
    p = _build.ptr
    if rc:
        gs_e = new(B, A, A, H)   # scratch: the source pass's per-edge factor
        _build.call(
            "edge_bwd_upd_rc_launch", _UPD_RC_ARGS,
            p(zf_or_edge), p(adj), p(wt), p(wsrc), p(w_f), p(b_f), p(g_df),
            p(g_edge), p(g_wt), p(g_wsrc), p(gs_e), p(gz), B, A, H, S,
        )
    else:
        _build.call(
            "edge_bwd_upd_launch", _UPD_ARGS,
            p(adj), p(wt), p(wsrc), p(w_f), p(zf_or_edge), p(g_df),
            p(g_edge), p(g_wt), p(g_wsrc), p(gz), B, A, H, S,
        )
    return g_edge, g_wt, g_wsrc


def edge_bwd_upd(adj, wt, wsrc, w_f, zf, g_df, g_edge=None):
    """K3.  Returns (g_edge, g_wt, g_wsrc); given ``g_edge`` (the message
    path's), the edge gradient is added into it in place and that tensor is
    returned."""
    if not route(zf):
        return edge_bwd_upd_plain(adj, wt, wsrc, w_f, zf, g_df, g_edge)
    out = _upd_launch(False, adj, wt, wsrc, w_f, None, zf, g_df, g_edge)
    LAUNCHES["edge_bwd_upd"] += 1
    return out


def edge_bwd_msg_rc(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                    g_xagg, g_vecagg, cutoff: float, nh: int):
    """K7.  Returns (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist)."""
    if not route(q):
        return edge_bwd_msg_rc_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv,
                                     w_s, b_s, g_xagg, g_vecagg, cutoff, nh)
    B, A, H = q.shape
    S = vec.shape[2]
    check_shapes(A, H, S, nh)
    dev = q.device
    wdkvT, wsT = w_dkv.t().contiguous(), w_s.t().contiguous()
    c = _build.check
    for name, t, shape in (
        ("q", q, (B, A, H)), ("k", k, (B, A, H)), ("v", v, (B, A, H)),
        ("vec", vec, (B, A, S, H)), ("edge", edge, (B, A, A, H)),
        ("d_sh", d_sh, (B, A, A, S)), ("dist", dist, (B, A, A)), ("adj", adj, (B, A, A)),
        ("w_dkv", w_dkv, (H, 2 * H)), ("b_dkv", b_dkv, (2 * H,)),
        ("w_s", w_s, (H, 2 * H)), ("b_s", b_s, (2 * H,)),
        ("g_xagg", g_xagg, (B, A, H)), ("g_vecagg", g_vecagg, (B, A, S, H)),
    ):
        c(name, t, shape, device=dev)
    new = lambda *s: torch.empty(s, dtype=_f32, device=dev)
    g_q, g_k, g_v = new(B, A, H), new(B, A, H), new(B, A, H)
    g_vec, g_edge = new(B, A, S, H), new(B, A, A, H)
    g_dsh, g_dist = new(B, A, A, S), new(B, A, A)
    gk_e, gv_e, s1_e = new(B, A, A, H), new(B, A, A, H), new(B, A, A, H)   # scratch
    p = _build.ptr
    _build.call(
        "edge_bwd_msg_rc_launch", _MSG_RC_ARGS,
        p(q), p(k), p(v), p(vec), p(edge), p(d_sh), p(dist), p(adj),
        p(w_dkv), p(b_dkv), p(w_s), p(b_s), p(wdkvT), p(wsT), p(g_xagg), p(g_vecagg),
        p(g_q), p(g_k), p(g_v), p(g_vec), p(g_edge), p(g_dsh), p(g_dist),
        p(gk_e), p(gv_e), p(s1_e), B, A, H, S, float(cutoff), H // nh,
    )
    LAUNCHES["edge_bwd_msg_rc"] += 1
    return g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist


def edge_bwd_upd_rc(edge, adj, wt, wsrc, w_f, b_f, g_df, g_edge=None):
    """K8.  Returns (g_edge, g_wt, g_wsrc), ``g_edge`` as K3's."""
    if not route(edge):
        return edge_bwd_upd_rc_plain(edge, adj, wt, wsrc, w_f, b_f, g_df, g_edge)
    out = _upd_launch(True, adj, wt, wsrc, w_f, b_f, edge, g_df, g_edge)
    LAUNCHES["edge_bwd_upd_rc"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedVisMP(torch.autograd.Function):
    """The edge core through K1 forward and K2/K3 or K7/K8 backward.

    Mirrors ``vismp.fused_vis_mp`` (vismp.py:1111-1220): the forward stores
    zdkv, zs (and zf with the update) only when some input needs a gradient,
    and the backward reads them instead of recomputing the edge products.
    With ``recompute`` the forward stores none of them and saves the layer
    inputs (with b_dkv, b_s and b_f) instead; the backward rebuilds the
    pre-activations in K7/K8, the route of ``_bwd_msg_call`` /
    ``_bwd_upd_call`` (vismp.py:987, :1060).  The gradient is the same
    either way; the stash of 5 H floats per edge cell is not held between
    the forward and the backward.
    The gradient flows to q, k, v, vec, wt, wsrc, edge, d_sh and dist.  The
    weights and biases get NO gradient (the reference returns zeros,
    vismp.py:1123): forces differentiate positions only, so training must
    use the plain path (``edge_core`` on CPU tensors without ``recompute``,
    or ``edge_fwd_plain`` directly); ``edge_core`` raises rather than take
    this Function for a weight that needs a gradient.
    On CPU tensors the wrappers run their plain versions, so this Function
    is also testable without a card."""

    @staticmethod
    def forward(ctx, q, k, v, vec, wt, wsrc, edge, d_sh, dist, adj,
                w_dkv, b_dkv, w_s, b_s, w_f, b_f, cutoff, nh, recompute=False):
        grads = any(ctx.needs_input_grad[:9])
        store = grads and not recompute
        x_agg, vec_agg, df, zdkv, zs, zf = edge_fwd(
            q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
            cutoff, nh, wt, wsrc, w_f, b_f, store=store)
        ctx.cutoff, ctx.nh, ctx.update = cutoff, nh, wt is not None
        ctx.recompute = recompute
        if store:
            ctx.save_for_backward(q, k, v, vec, wt, wsrc, d_sh, dist, adj,
                                  w_dkv, w_s, w_f, zdkv, zs, zf)
        elif grads:
            ctx.save_for_backward(q, k, v, vec, wt, wsrc, d_sh, dist, adj,
                                  w_dkv, w_s, w_f, edge, b_dkv, b_s, b_f)
        if ctx.update:
            return x_agg, vec_agg, df
        return x_agg, vec_agg

    @staticmethod
    def backward(ctx, g_xagg, g_vecagg, g_df=None):
        q, k, v, vec, wt, wsrc, d_sh, dist, adj, w_dkv, w_s, w_f, *rest = ctx.saved_tensors
        g_xagg, g_vecagg = g_xagg.contiguous(), g_vecagg.contiguous()
        g_wt = g_wsrc = None
        if ctx.recompute:
            edge, b_dkv, b_s, b_f = rest
            g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist = edge_bwd_msg_rc(
                q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                g_xagg, g_vecagg, ctx.cutoff, ctx.nh)
            if ctx.update:   # K8 adds its g_edge into K7's in place
                g_edge, g_wt, g_wsrc = edge_bwd_upd_rc(edge, adj, wt, wsrc, w_f, b_f,
                                                       g_df.contiguous(), g_edge)
        else:
            zdkv, zs, zf = rest
            g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist = edge_bwd_msg(
                q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                g_xagg, g_vecagg, ctx.cutoff, ctx.nh)
            if ctx.update:   # K3 adds its g_edge into K2's in place
                g_edge, g_wt, g_wsrc = edge_bwd_upd(adj, wt, wsrc, w_f, zf, g_df.contiguous(),
                                                    g_edge)
        return (g_q, g_k, g_v, g_vec, g_wt, g_wsrc, g_edge, g_dsh, g_dist,
                None, None, None, None, None, None, None, None, None, None)


def edge_core(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
              cutoff: float, nh: int, wt=None, wsrc=None, w_f=None, b_f=None,
              act: str = "silu", attn_act: str = "silu", recompute: bool = False,
              plain: bool = False):
    """The one entry the model calls: (x_agg, vec_agg, df or None).

    CPU tensors take the plain forward and autograd through it; CUDA tensors
    take ``FusedVisMP`` (kernels K1-K3), which computes silu only.  With
    ``recompute`` both take ``FusedVisMP`` on its recompute route (K1 and
    K7/K8 on the card, their plain versions on the CPU).  ``FusedVisMP``
    gives the weights no gradient, so it raises where one needs it.
    ``plain`` is the explicit route of a model with other activations than
    silu (``ViSNetConfig.plain_edge_core``, set by ``resolve_config``, as
    the JAX package sends them to jnp): the plain forward and autograd on
    any device, each call on CUDA tensors counted in
    ``LAUNCHES["plain_edge_core"]`` (``recompute`` has no effect there).
    Otherwise a batch the kernels cannot take (``check_shapes``) or another
    activation than silu raises on the card."""
    if plain or (not recompute and not route(q)):
        if plain and q.is_cuda:
            LAUNCHES["plain_edge_core"] += 1
        return edge_fwd_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv,
                              w_s, b_s, cutoff, nh, wt, wsrc, w_f, b_f, act, attn_act)[:3]
    if act not in SILU or attn_act not in SILU:
        raise ValueError(f"the edge kernels compute silu, not {act!r}/{attn_act!r}; a model "
                         f"with other activations takes plain=True on the card "
                         f"(ViSNetConfig.plain_edge_core, set by models.visnet.resolve_config)")
    if torch.is_grad_enabled() and any(
            w is not None and w.requires_grad for w in (w_dkv, b_dkv, w_s, b_s, w_f, b_f)):
        raise ValueError("the edge kernels give the edge-core weights no gradient; train "
                         "on CPU tensors without recompute (ViSNetConfig(remat=False))")
    cont = lambda t: None if t is None else t.contiguous()
    outs = FusedVisMP.apply(
        *map(cont, (q, k, v, vec, wt, wsrc, edge, d_sh, dist, adj,
                    w_dkv, b_dkv, w_s, b_s, w_f, b_f)), cutoff, nh, recompute)
    return outs if wt is not None else (*outs, None)
