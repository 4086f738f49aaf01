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

Each kernel takes float32 or bfloat16 storage (the mixed-precision mode,
``ViSNetConfig.edge_dtype``; its plain versions ``edge_fwd_bf16_plain``,
``edge_bwd_msg_bf16_plain``, ``edge_bwd_upd_bf16_plain`` model what the JAX
kernels compute on bfloat16, below).  Each wrapper runs its plain version
for CPU tensors and launches its kernel for CUDA tensors; there is no other
route.  ``edge_core`` is what the model
calls: the plain forward (differentiable in every input, weights included)
on the CPU, ``FusedVisMP`` on the card.  ``FusedVisMP`` has two routes for
the backward: the stash route (K1 stores zdkv, zs, zf; K2/K3 read them) and,
with ``recompute=True``, the memory-lean route (K1 stores nothing; K7/K8
rebuild the pre-activations), which ``edge_core(recompute=True)`` takes on
the CPU too, there through the plain versions.

The products' mode is the JAX package's in-kernel precision, read from
``AI2BMD_KERNEL_MM_PRECISION`` with its values and its message for an
unknown one (``ai2bmd_tpu/ops/pallas/vismp.py:43-70``): ``b3`` (unset: the
production 3xTF32 split), ``highest`` (full float32) or ``default`` (one
pass on bfloat16-rounded operands).  It is read once, at import, as JAX
reads it, into ``_build.MM_MODE``; ``configure_mm_mode()`` reads it again
(tests, and chip_smoke.py, which runs every mode in one process).  Every
wrapper (here, in ``ops/vislayer.py``, ``ops/tf32x3.py`` and
``ops/caps.py``) launches from that mode's kernel library (``_build``).  On
CPU tensors the wrappers of ``highest`` and ``default`` take their mode's
plain product (``ops.tf32x3.plain_mm``); ``b3``'s stay the exact product,
as before.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from ai2bmd_torch.ops import LAUNCHES, _build

_f32 = torch.float32

MM_ENV = "AI2BMD_KERNEL_MM_PRECISION"
# The JAX package's values -> the port's product mode (a kernel library of
# its own, _build.MODES).  JAX's comment calls "high" an alias of b3
# (vismp.py:60), but its code splits only when the mode is "b3" (:93,
# :607): "high" and "" run one dot at precision None, full float32 on
# Mosaic (:45).  The port follows the code (ROADMAP.md, Queue 3).
MM_MODES = {"b3": "b3", "highest": "highest", "high": "highest", "": "highest",
            "default": "default"}


def parse_mm_mode(value: str | None) -> str:
    """The product mode of an ``AI2BMD_KERNEL_MM_PRECISION`` value (None:
    unset, ``b3``); an unknown value raises the JAX package's ValueError."""
    value = "b3" if value is None else value
    if value not in MM_MODES:
        raise ValueError(
            f"AI2BMD_KERNEL_MM_PRECISION={value!r} is not a known mode; "
            f"valid values: b3 (production, default), highest (full f32), "
            f"default (single-pass bf16 throughput), high (alias of b3)"
        )
    return MM_MODES[value]


def configure_mm_mode() -> str:
    """Read ``AI2BMD_KERNEL_MM_PRECISION`` again into ``_build.MM_MODE`` and
    return it.  Launches that follow take that mode's library; a captured
    CUDA graph keeps the mode it was captured in."""
    _build.MM_MODE = parse_mm_mode(os.environ.get(MM_ENV))
    return _build.MM_MODE


configure_mm_mode()


def route_mm():
    """The product of the wrappers' plain route (CPU tensors) in the current
    mode: ``highest`` and ``default`` take their plain model
    (``tf32x3.plain_mm``); ``b3`` the exact product, which its split matches
    within float32 rounding (tests/test_torch_tf32x3.py) and which the
    model's own CPU path and its float64 references run."""
    if _build.MM_MODE == "b3":
        return torch.matmul
    from ai2bmd_torch.ops.tf32x3 import plain_mm

    return plain_mm(_build.MM_MODE)


_bf16 = torch.bfloat16


def _const(x: float, like: torch.Tensor):
    """A Python constant as it meets ``like`` in the JAX package: rounded to
    bfloat16 first when ``like`` is bfloat16 (JAX converts a weakly typed
    scalar to the array's type; torch would take it in float32)."""
    return torch.tensor(x, dtype=_bf16) if like.dtype == _bf16 else x


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """0.5 (cos(pi d / cutoff) + 1) inside the cutoff; on bfloat16 distances
    every step rounds to bfloat16, as the JAX package computes it there."""
    return 0.5 * (torch.cos(dist * _const(math.pi / cutoff, dist)) + 1.0) * (dist < cutoff)


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
    the edge products (``tf32x3.mm_tf32x3_plain`` models the kernel's).
    It computes in the inputs' type: on bfloat16 tensors it is the JAX
    package's jnp path in its mixed precision, each operation rounded to
    bfloat16 (the route of a non-silu model); K1's bfloat16 instantiation
    computes ``edge_fwd_bf16_plain``."""
    H = q.shape[-1]
    act_fn, attn_fn = _ACTS[act], _ACTS[attn_act]
    adj_e = adj[..., None]
    zdkv = mm(edge, w_dkv) + b_dkv
    dk, dv = act_fn(zdkv).split(H, dim=-1)
    a = _heads(q[:, :, None] * k[:, None] * dk, nh)
    gate = (cosine_cutoff(dist, cutoff) * adj)[..., None]
    vd, att = v[:, None] * dv, _per_channel(attn_fn(a), H) * gate
    v_ij = vd * att
    zs = mm(v_ij, w_s) + b_s
    s1, s2 = (act_fn(zs) * adj_e).split(H, dim=-1)
    if v_ij.dtype == _bf16:   # jnp.sum upcasts v_ij: XLA takes its last product in float32
        x_agg = (vd.float() * att.float()).sum(2).to(_bf16)
    else:
        x_agg = v_ij.sum(2)
    vec_agg = (torch.einsum("bjch,bijh->bich", vec, s1)
               + torch.einsum("bijh,bijc->bich", s2, d_sh))
    df = zf = None
    if wt is not None:
        zf = mm(edge, w_f) + b_f
        w_dot = torch.einsum("bich,bjch->bijh", wt, wsrc)
        df = act_fn(zf) * w_dot * adj_e
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
                          g_xagg, g_vecagg, cutoff: float, nh: int, mm=torch.matmul):
    """Plain version of K7, the math of ``_bwd_msg_kernel`` (vismp.py:615):
    zdkv and zs recomputed from the layer inputs, then K2's plain version
    (``mm`` takes every product).  Returns (g_q, g_k, g_v, g_vec, g_edge,
    g_d_sh, g_dist)."""
    if q.dtype == _bf16:
        return edge_bwd_msg_bf16_plain(q, k, v, vec, None, None, d_sh, dist, adj, w_dkv, w_s,
                                       g_xagg, g_vecagg, cutoff, nh, mm, edge=edge,
                                       b_dkv=b_dkv, b_s=b_s)
    zdkv, zs = edge_fwd_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                              cutoff, nh, mm=mm)[3:5]
    return edge_bwd_msg_plain(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                              g_xagg, g_vecagg, cutoff, nh, mm=mm)


def edge_bwd_upd_rc_plain(edge, adj, wt, wsrc, w_f, b_f, g_df, g_edge=None, mm=torch.matmul):
    """Plain version of K8, the math of ``_bwd_upd_kernel`` (vismp.py:714):
    zf = edge @ W_f + b_f recomputed, then K3's plain version (``g_edge``
    and ``mm`` as there).  Returns (g_edge, g_wt, g_wsrc)."""
    if edge.dtype == _bf16:
        return edge_bwd_upd_bf16_plain(adj, wt, wsrc, w_f, None, g_df, g_edge, mm,
                                       edge=edge, b_f=b_f)
    return edge_bwd_upd_plain(adj, wt, wsrc, w_f, mm(edge, w_f) + b_f, g_df, g_edge, mm)


# ---------------------------------------------------------------------------
# plain versions of the bfloat16 instantiations
# ---------------------------------------------------------------------------
#
# K1-K3, K7 and K8 take bfloat16 storage as well (``ViSNetConfig.
# edge_dtype``, the JAX package's mixed-precision mode): every stream, weight
# and output in bfloat16, widened to float32 on load and rounded at the
# store.  Their plain versions below compute what the JAX kernels compute on
# bfloat16 refs as the JAX package runs them (XLA on the CPU in the tests,
# measured there op by op): float32 wherever jnp promotes a bfloat16 operand
# against a float32 one; an operation on bfloat16 operands alone rounds its
# result to bfloat16, except where the next operation promotes it to
# float32 (XLA's excess precision computes that one in float32).  So, of
# what the kernels compute in bfloat16:
# - the cutoff chain on the bfloat16 distance, pi / cutoff rounded first,
#   rounds every step (vismp.py:223, :654, :792; ``cosine_cutoff`` on a
#   bfloat16 tensor), its derivative every step but the last (:699, :837);
# - q_i k_j (:216, :649) and each wt_i[c] wsrc_j[c] (:126, :742) or
#   g_vec_agg_i[c] vec_j[c] (:679, :817) meet float32 next: float32;
# - K2 and K3 read a bfloat16 stash: sigmoid is 1 / (1 + exp(-z)) with each
#   step rounded (its lowering), silu z sigmoid(z) rounded (dk, dv, s and
#   K3's g_df silu(zf)), silu' every step but the last (``_dsilu``), and
#   the products of two of these bfloat16 values that are summed (s1 g_vec_agg,
#   g_vec_agg s2, g_df silu(zf) wsrc, ... wt; :819-824, :884-889) round
#   before their float32 sums, as does q_i k_j before it meets dk;
# - the source-indexed sums (g_k, g_v, g_vec, g_wsrc) add the centres in
#   blocks of 8, each block's float32 sum rounded and added to the running
#   bfloat16 total (the TPU's sequential grid, :804-845, :868-889).
# Outputs are rounded to bfloat16 once, at the store; K3/K8 round their edge
# gradient before they add it into the message path's, as JAX adds the two
# bfloat16 gradients (vismp.py:1213).

I_TILE = 8   # the JAX kernels' centre block: the source sums' bfloat16 steps


def _rb(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even), kept in float32."""
    return x.to(_bf16).float()


def _sigmoid_bf16(z: torch.Tensor) -> torch.Tensor:
    """sigmoid of a bfloat16 value as ``jax.nn.sigmoid`` lowers it there:
    1 / (1 + exp(-z)), each step rounded."""
    return _rb(1.0 / _rb(1.0 + _rb(torch.exp(-z))))


def _dsilu_bf16(z: torch.Tensor) -> torch.Tensor:
    """``_dsilu`` of a bfloat16 value: every step rounded but the last."""
    sg = _sigmoid_bf16(z)
    return sg * _rb(1.0 + _rb(z * _rb(1.0 - sg)))


def _dcut_bf16(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """d cosine_cutoff / d dist of a bfloat16 distance (float32 holding it)
    as the backward kernels compute it: the steps rounded but the last
    product; 0 outside the cutoff."""
    k = math.pi / cutoff
    kb, kd = (float(_rb(torch.tensor(c))) for c in (k, -0.5 * k))
    return kd * _rb(torch.sin(_rb(dist * kb))) * (dist < cutoff)


def _source_sum_bf16(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over the centres (``dim``, of A % I_TILE == 0) as the JAX kernels
    accumulate a source-indexed output: each block of I_TILE centres summed
    in float32 and rounded, the blocks added in order to a bfloat16 total."""
    A = terms.shape[dim]
    blocks = _rb(terms.unflatten(dim, (A // I_TILE, I_TILE)).sum(dim + 1))
    total = blocks.select(dim, 0)
    for n in range(1, A // I_TILE):
        total = _rb(total + blocks.select(dim, n))
    return total


def edge_fwd_bf16_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                        cutoff: float, nh: int, wt=None, wsrc=None, w_f=None, b_f=None,
                        mm=torch.matmul):
    """Plain version of K1's bfloat16 instantiation (bfloat16 tensors in and
    out), the forward kernels on bfloat16 refs (``_edge_core``,
    ``_kernel_full_res``; vismp.py:100-245): float32 throughout but the
    cutoff chain.  Returns (x_agg, vec_agg, df) in bfloat16 and (zdkv, zs,
    zf) in float32: the kernel stores them rounded (the stash), K7/K8's
    plain versions recompute them unrounded.  ``mm`` takes the edge
    products."""
    H = q.shape[-1]
    gate = (cosine_cutoff(dist, cutoff) * adj).float()[..., None]
    q, k, v, vec, edge, d_sh, adj = (t.float() for t in (q, k, v, vec, edge, d_sh, adj))
    adj_e = adj[..., None]
    zdkv = mm(edge, w_dkv.float()) + b_dkv.float()
    dk, dv = F.silu(zdkv).split(H, dim=-1)
    a = _heads(q[:, :, None] * k[:, None] * dk, nh)
    v_ij = v[:, None] * dv * (_per_channel(F.silu(a), H) * gate)
    zs = mm(v_ij, w_s.float()) + b_s.float()
    s1, s2 = (F.silu(zs) * adj_e).split(H, dim=-1)
    x_agg = v_ij.sum(2)
    vec_agg = (torch.einsum("bjch,bijh->bich", vec, s1)
               + torch.einsum("bijh,bijc->bich", s2, d_sh))
    df = zf = None
    if wt is not None:
        zf = mm(edge, w_f.float()) + b_f.float()
        df = (F.silu(zf) * torch.einsum("bich,bjch->bijh", wt.float(), wsrc.float())
              * adj_e).to(_bf16)
    return x_agg.to(_bf16), vec_agg.to(_bf16), df, zdkv, zs, zf


def edge_bwd_msg_bf16_plain(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                            g_xagg, g_vecagg, cutoff: float, nh: int, mm=torch.matmul,
                            edge=None, b_dkv=None, b_s=None):
    """Plain version of K2's bfloat16 instantiation (from the bfloat16 stash
    zdkv, zs; ``_bwd_msg_kernel_sa``, vismp.py:757-851) or, given ``edge``,
    ``b_dkv`` and ``b_s`` instead, K7's (the float32 pre-activations
    recomputed, ``_bwd_msg_kernel``, :615-711).  bfloat16 tensors in and
    out; returns (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist)."""
    H = q.shape[-1]
    rc = edge is not None
    if rc:
        zdkv, zs = edge_fwd_bf16_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s,
                                       b_s, cutoff, nh, mm=mm)[3:5]
    gate = (cosine_cutoff(dist, cutoff) * adj).float()[..., None]
    q, k, v, vec, d_sh, dist, adj, g_xagg, g_vecagg = (
        t.float() for t in (q, k, v, vec, d_sh, dist, adj, g_xagg, g_vecagg))
    adj_e = adj[..., None]
    q_i, k_j, v_j = q[:, :, None], k[:, None], v[:, None]
    if rc:
        dk, dv = F.silu(zdkv).split(H, dim=-1)
        s = F.silu(zs)
        ds_kv, ds_s = dsilu(zdkv), dsilu(zs)
        rp = lambda t: t        # a product that meets float32 next: float32
    else:
        zdkv, zs = zdkv.float(), zs.float()
        dk, dv = _rb(zdkv * _sigmoid_bf16(zdkv)).split(H, dim=-1)
        s = _rb(zs * _sigmoid_bf16(zs))
        ds_kv, ds_s = _dsilu_bf16(zdkv), _dsilu_bf16(zs)
        rp = _rb                # a product of two bfloat16 operands
    a = _heads(rp(q_i * k_j) * dk, nh)
    s1, s2 = (s * adj_e).split(H, dim=-1)
    att = _per_channel(F.silu(a), H)
    g3 = att * gate

    g_s1 = torch.einsum("bich,bjch->bijh", g_vecagg, vec)
    g_s2 = torch.einsum("bich,bijc->bijh", g_vecagg, d_sh)
    g_vec = _source_sum_bf16(rp(s1[..., None, :] * g_vecagg[:, :, None]), 1)
    g_dsh = rp(g_vecagg[:, :, None] * s2[..., None, :]).sum(-1)
    g_s = torch.cat([g_s1 * adj_e, g_s2 * adj_e], dim=-1) * ds_s
    g_vij = mm(g_s, w_s.float().T) + g_xagg[:, :, None]

    g_v = _source_sum_bf16(g_vij * dv * g3, 1)
    g_dv = g_vij * v_j * g3
    g_g3 = g_vij * v_j * dv
    g_dist = (g_g3 * att).sum(-1) * adj * _dcut_bf16(dist, cutoff)
    g_p = _per_channel(_heads(g_g3 * gate, nh) * dsilu(a), H)
    g_q = (g_p * k_j * dk).sum(2)
    g_k = _source_sum_bf16(g_p * q_i * dk, 1)
    g_dk = g_p * q_i * k_j
    g_edge = mm(torch.cat([g_dk, g_dv], dim=-1) * ds_kv, w_dkv.float().T)
    return tuple(t.to(_bf16) for t in (g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist))


def edge_bwd_upd_bf16_plain(adj, wt, wsrc, w_f, zf, g_df, g_edge=None, mm=torch.matmul,
                            edge=None, b_f=None):
    """Plain version of K3's bfloat16 instantiation (from the bfloat16 zf;
    ``_bwd_upd_kernel_sa``, vismp.py:852-890) or, given ``edge`` and ``b_f``
    instead, K8's (zf recomputed in float32, ``_bwd_upd_kernel``, :714-754).
    bfloat16 tensors in and out; returns (g_edge, g_wt, g_wsrc), the edge
    gradient rounded and added into ``g_edge`` in place when given."""
    adj, wt, wsrc, g_df = (t.float() for t in (adj, wt, wsrc, g_df))
    g = g_df * adj[..., None]
    if edge is not None:
        zf = mm(edge.float(), w_f.float()) + b_f.float()
        g_s, ds = g * F.silu(zf), dsilu(zf)
    else:
        zf = zf.float()
        g_s, ds = _rb(g * _rb(zf * _sigmoid_bf16(zf))), _dsilu_bf16(zf)
    rp = _rb if edge is None else (lambda t: t)   # K3's g_s is bfloat16, K8's float32
    s_ij = torch.einsum("bich,bjch->bijh", wt, wsrc)
    g_wt = rp(g_s[..., None, :] * wsrc[:, None]).sum(2)
    g_wsrc = _source_sum_bf16(rp(g_s[..., None, :] * wt[:, :, None]), 1)
    prod = mm(g * s_ij * ds, w_f.float().T).to(_bf16)
    return (prod if g_edge is None else g_edge.add_(prod)), g_wt.to(_bf16), g_wsrc.to(_bf16)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = _build.P, _build.I, _build.F
# the launchers' arguments after their pointers
_FWD_TAIL = [_I, _I, _I, _I, _F, _I, _I, _I]
_MSG_TAIL = [_I, _I, _I, _I, _F, _I]


def route(t: torch.Tensor, kernels: str = "edge-core") -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    raise ValueError(f"no {kernels} implementation for device {t.device}")


# Every centre pass of the edge kernels (K1-K3, K7, K8) and of the
# full-layer kernels (K5/K6) walks a centre's sources in chunks of at most
# 48 rows (``ECHUNK`` in csrc/common.cuh), so they take any A % 8 == 0, as
# the JAX package's dense kernels do (their TI = 8): a fragment or a whole
# molecule of any size, as far as the card's memory goes (a shape too large
# fails on torch's own allocation).  Both families take every H whose head
# count divides it, as JAX's kernels do: their narrow instantiations heads
# of 8, 16, 32 or 64 channels with H a multiple of 32 up to 256
# (``narrow_shapes`` for K1, K2, K7, K5 and K6, ``narrow_update`` for K3 and
# K8, which sum no head; one thread a channel, ``head_sum<DH>`` on a warp's
# lanes), their wide ones every other shape (channels padded to a multiple
# of 32, each thread looping over several, a chunk's rows in a device
# scratch and staged in shared memory a k-tile of 128 columns at a time, so
# no constant bounds H and no shared memory grows with it).
# ``layer_shapes`` / ``unsupported_shapes`` say what both take,
# ``check_shapes`` / ``check_layer_shapes`` check a batch for each family;
# the launchers check the same limits.
HEAD_WIDTHS = (8, 16, 32, 64)
# the shapes the kernels do not take, where the JAX package's Pallas
# kernels run: refused on the card
UNSUPPORTED = "ROADMAP.md, Queue 2: domain still to extend"
NO_MODEL_S = ("no model of either package builds S > 8: their spherical harmonics stop at "
              "lmax 2")
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


def narrow_update(H: int) -> bool:
    """True where K3 and K8, which sum no head, run their narrow
    instantiation (``narrow_update`` in csrc/common.cuh)."""
    return H % 32 == 0 and H <= 256


def narrow_shapes(H: int, nh: int) -> bool:
    """True where K1, K2 and K7 run their narrow instantiations
    (``narrow_shapes`` in csrc/common.cuh); every other shape of the edge
    kernels' domain runs their wide ones."""
    return nh > 0 and H % nh == 0 and H // nh in HEAD_WIDTHS and narrow_update(H)


def layer_shapes(H: int, nh: int, S: int) -> bool:
    """True for the shapes the full-layer kernels K5/K6 take
    (``layer_shapes_ok`` in csrc/vislayer.cuh): every H that the head count
    divides, S <= 8, the edge kernels' domain.  Their narrow
    instantiations run where ``narrow_shapes`` holds, their wide ones
    elsewhere."""
    return nh > 0 and H > 0 and H % nh == 0 and S <= 8


def wide_width(H: int) -> int:
    """H rounded up to a multiple of 32: the width the wide instantiations
    pad their channels to (``wide_width`` in csrc/common.cuh)."""
    return -(-H // 32) * 32


def unsupported_shapes(H: int, nh: int, S: int):
    """Why the kernels (the edge kernels K1-K3, K7, K8 and the full-layer
    kernels K5/K6, one domain) cannot take a model of H channels, nh heads
    and S spherical components, or None when they can."""
    if not layer_shapes(H, nh, S):
        return (f"H={H}, nh={nh}, S={S}: the edge and full-layer kernels take every H that "
                f"the head count divides, and S <= 8 ({UNSUPPORTED}; {NO_MODEL_S})")
    return None


def _check_slots(kernels: str, A: int, why):
    if why or A <= 0 or A % 8:
        raise ValueError(f"{kernels} take A a multiple of 8; got A={A}; "
                         f"{why or 'H, nh and S are in their domain'}")


def check_shapes(A, H, S, nh):
    """The shapes the edge kernels (K1-K3, K7, K8) take; anything else
    raises (the card has no plain route for them)."""
    _check_slots("edge kernels", A, unsupported_shapes(H, nh, S))


def check_layer_shapes(A, H, S, nh):
    """The shapes the full-layer kernels K5/K6 take: a fragment or a whole
    molecule of any A % 8 == 0, at every width of ``layer_shapes``."""
    _check_slots("fused-layer kernels", A, unsupported_shapes(H, nh, S))


def padded_weight(w: torch.Tensor, H: int, halves: int = 1) -> torch.Tensor:
    """A weight [H, halves H] (or a bias [halves H]) as the wide
    instantiations read it: each half zero-padded to [wide_width(H),
    wide_width(H)] ([wide_width(H)]; csrc/common.cuh); the weight itself
    when H is a multiple of 32.  A model pads its weights once
    (``models.visnet``); the wrappers take them padded or not."""
    Hp = wide_width(H)
    if Hp == H:
        return w
    if w.dim() == 1:
        out = w.new_zeros(halves, Hp)
        out[:, :H] = w.reshape(halves, H)
        return out.view(halves * Hp)
    out = w.new_zeros(Hp, halves, Hp)
    out[:H, :, :H] = w.reshape(H, halves, H)
    return out.view(Hp, halves * Hp)


def unpadded_weight(w: torch.Tensor, H: int, halves: int = 1) -> torch.Tensor:
    """``padded_weight``'s inverse: a weight or bias given padded or not, as
    [H, halves H] ([halves H])."""
    Hp = wide_width(H)
    if Hp == H or w.shape[0] == (H if w.dim() == 2 else halves * H):
        return w
    if w.dim() == 1:
        return w.view(halves, Hp)[:, :H].reshape(halves * H)
    return w.view(Hp, halves, Hp)[:H, :, :H].reshape(H, halves * H)


# The storage types the edge kernels take: float32, and bfloat16 (the
# mixed-precision mode); the launchers take the type from q (or zf / edge)
# and hold every other operand to it.  The bfloat16 instantiations have
# entry points of their own (``*_bf16_launch``, built into every mode's
# library) and launch counts of their own (``LAUNCHES[name + "_bf16"]``).
# On the CPU the wrappers take any type: bfloat16 to the plain versions of
# the bfloat16 instantiations, any other (float64 in the references) to
# the float32 plain versions.
EDGE_DTYPES = (torch.float32, _bf16)


def _dtype(t: torch.Tensor):
    if t.dtype not in EDGE_DTYPES:
        raise ValueError(f"the edge kernels take float32 or bfloat16 storage, not {t.dtype} "
                         f"({UNSUPPORTED})")
    return t.dtype


def _tag(dtype) -> str:
    """The suffix of a storage type's entry points and launch counts."""
    return "_bf16" if dtype == _bf16 else ""


def _weight(name: str, w: torch.Tensor, H: int, halves: int, device,
            dtype=torch.float32) -> torch.Tensor:
    """Check a weight given [H, halves H] or already padded (``padded_weight``)
    and return it padded, in its storage type."""
    Hp = wide_width(H)
    if Hp != H and tuple(w.shape) == (Hp, halves * Hp):
        _build.check(name, w, (Hp, halves * Hp), dtype=dtype, device=device)
        return w
    _build.check(name, w, (H, halves * H), dtype=dtype, device=device)
    return padded_weight(w, H, halves)


def _wide_scratch(kind: int, B: int, A: int, H: int, nh: int, dev):
    """The device scratch of a wide K1 (``kind`` 0) or K2/K7 (1), or None
    where the narrow instantiation runs: one slot a block (B A blocks) of
    ``edge_wide_scratch`` floats (``wide_scratch`` in csrc/common.cuh), the
    rows of a source chunk that the kernel stages in shared memory a k-tile
    at a time."""
    if narrow_shapes(H, nh):
        return None
    fn = _build.library(_build.MM_MODE).edge_wide_scratch
    fn.argtypes, fn.restype = [_I] * 4, ctypes.c_longlong
    return torch.empty(B * A * fn(kind, A, H, nh), dtype=_f32, device=dev)


def edge_fwd(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
             cutoff: float, nh: int, wt=None, wsrc=None, w_f=None, b_f=None,
             store: bool = False):
    """K1.  Returns (x_agg, vec_agg, df, zdkv, zs, zf); df/zf are None without
    the update (wt is None), zdkv/zs/zf None unless ``store``.  On bfloat16
    tensors, K1's bfloat16 instantiation (``edge_fwd_bf16_plain`` on the
    CPU): every output and the stash in bfloat16."""
    update = wt is not None
    if not route(q):
        low = q.dtype == _bf16
        plain = edge_fwd_bf16_plain if low else edge_fwd_plain
        x_agg, vec_agg, df, zdkv, zs, zf = plain(
            q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
            cutoff, nh, wt, wsrc, w_f, b_f, mm=route_mm())
        if not store:
            zdkv = zs = zf = None
        elif low:
            zdkv, zs, zf = (None if z is None else z.to(_bf16) for z in (zdkv, zs, zf))
        return x_agg, vec_agg, df, zdkv, zs, zf
    dt = _dtype(q)
    B, A, H = q.shape
    S = vec.shape[2]
    check_shapes(A, H, S, nh)
    dev = q.device
    c = lambda name, t, shape: _build.check(name, t, shape, dtype=dt, device=dev)
    for name, t, shape in (
        ("q", q, (B, A, H)), ("k", k, (B, A, H)), ("v", v, (B, A, H)),
        ("vec", vec, (B, A, S, H)), ("edge", edge, (B, A, A, H)),
        ("d_sh", d_sh, (B, A, A, S)), ("dist", dist, (B, A, A)),
        ("adj", adj, (B, A, A)), ("b_dkv", b_dkv, (2 * H,)), ("b_s", b_s, (2 * H,)),
    ):
        c(name, t, shape)
    w_dkv = _weight("w_dkv", w_dkv, H, 2, dev, dt)
    w_s = _weight("w_s", w_s, H, 2, dev, dt)
    if update:
        for name, t, shape in (("wt", wt, (B, A, S, H)), ("wsrc", wsrc, (B, A, S, H)),
                               ("b_f", b_f, (H,))):
            c(name, t, shape)
        w_f = _weight("w_f", w_f, H, 1, dev, dt)
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    x_agg, vec_agg = new(B, A, H), new(B, A, S, H)
    df = new(B, A, A, H) if update else None
    zdkv = new(B, A, A, 2 * H) if store else None
    zs = new(B, A, A, 2 * H) if store else None
    zf = new(B, A, A, H) if store and update else None
    p = _build.ptr
    args = [p(q), p(k), p(v), p(vec), p(wt), p(wsrc), p(edge), p(d_sh), p(dist), p(adj),
            p(w_dkv), p(b_dkv), p(w_s), p(b_s), p(w_f), p(b_f),
            p(x_agg), p(vec_agg), p(df), p(zdkv), p(zs), p(zf)]
    if dt == _bf16:   # the sums over the sources' chunks, in float32
        acc = new(B, A, H, dtype=_f32), new(B, A, S, H, dtype=_f32)
        args += [p(t) for t in acc]
    wrk = _wide_scratch(0, B, A, H, nh, dev)
    args.append(p(wrk))
    _build.call(f"edge_fwd{_tag(dt)}_launch", [_P] * len(args) + _FWD_TAIL, *args,
                B, A, H, S, float(cutoff), int(update), int(store), H // nh)
    LAUNCHES["edge_fwd" + _tag(dt)] += 1
    return x_agg, vec_agg, df, zdkv, zs, zf


def _msg_launch(rc: bool, q, k, v, vec, zdkv_or_edge, zs, d_sh, dist, adj, w_dkv, b_dkv, w_s,
                b_s, g_xagg, g_vecagg, cutoff: float, nh: int):
    """Launch K2 (``rc`` False, from the stash zdkv, zs) or K7 (True, from the
    edge rows with b_dkv, b_s) on the card, in q's storage type.  Returns
    (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist)."""
    B, A, H = q.shape
    S = vec.shape[2]
    check_shapes(A, H, S, nh)
    dt, dev = _dtype(q), q.device
    c = lambda name, t, shape: _build.check(name, t, shape, dtype=dt, device=dev)
    for name, t, shape in (
        ("q", q, (B, A, H)), ("k", k, (B, A, H)), ("v", v, (B, A, H)),
        ("vec", vec, (B, A, S, H)), ("d_sh", d_sh, (B, A, A, S)),
        ("dist", dist, (B, A, A)), ("adj", adj, (B, A, A)),
        ("g_xagg", g_xagg, (B, A, H)), ("g_vecagg", g_vecagg, (B, A, S, H)),
    ) + ((("edge", zdkv_or_edge, (B, A, A, H)), ("b_dkv", b_dkv, (2 * H,)),
          ("b_s", b_s, (2 * H,))) if rc else
         (("zdkv", zdkv_or_edge, (B, A, A, 2 * H)), ("zs", zs, (B, A, A, 2 * H)))):
        c(name, t, shape)
    w_dkv = _weight("w_dkv", w_dkv, H, 2, dev, dt)
    w_s = _weight("w_s", w_s, H, 2, dev, dt)
    wdkvT, wsT = w_dkv.t().contiguous(), w_s.t().contiguous()
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    g_q, g_k, g_v = new(B, A, H), new(B, A, H), new(B, A, H)
    g_vec, g_edge = new(B, A, S, H), new(B, A, A, H)
    g_dsh, g_dist = new(B, A, A, S), new(B, A, A)
    # scratch: the per-edge terms of g_k and g_v (K7: and s1) for the source pass
    gk_e, gv_e = new(B, A, A, H, dtype=_f32), new(B, A, A, H, dtype=_f32)
    p = _build.ptr
    if rc:
        s1_e = new(B, A, A, H, dtype=_f32)
        args = [p(q), p(k), p(v), p(vec), p(zdkv_or_edge), p(d_sh), p(dist), p(adj),
                p(w_dkv), p(b_dkv), p(w_s), p(b_s), p(wdkvT), p(wsT), p(g_xagg), p(g_vecagg),
                p(g_q), p(g_k), p(g_v), p(g_vec), p(g_edge), p(g_dsh), p(g_dist),
                p(gk_e), p(gv_e), p(s1_e)]
    else:
        args = [p(q), p(k), p(v), p(vec), p(zdkv_or_edge), p(zs), p(d_sh), p(dist), p(adj),
                p(wdkvT), p(wsT), p(g_xagg), p(g_vecagg),
                p(g_q), p(g_k), p(g_v), p(g_vec), p(g_edge), p(g_dsh), p(g_dist),
                p(gk_e), p(gv_e)]
    if dt == _bf16:   # g_q's sum over the sources' chunks, in float32
        acc = new(B, A, H, dtype=_f32)
        args.append(p(acc))
    wrk = _wide_scratch(1, B, A, H, nh, dev)
    args.append(p(wrk))
    name = "edge_bwd_msg_rc" if rc else "edge_bwd_msg"
    _build.call(f"{name}{_tag(dt)}_launch", [_P] * len(args) + _MSG_TAIL, *args,
                B, A, H, S, float(cutoff), H // nh)
    LAUNCHES[name + _tag(dt)] += 1
    return g_q, g_k, g_v, g_vec, g_edge, g_dsh, g_dist


def edge_bwd_msg(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s,
                 g_xagg, g_vecagg, cutoff: float, nh: int):
    """K2.  Returns (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist); on
    bfloat16 tensors its bfloat16 instantiation (``edge_bwd_msg_bf16_plain``
    on the CPU)."""
    if not route(q):
        plain = edge_bwd_msg_bf16_plain if q.dtype == _bf16 else edge_bwd_msg_plain
        return plain(q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, w_s, g_xagg, g_vecagg,
                     cutoff, nh, mm=route_mm())
    return _msg_launch(False, q, k, v, vec, zdkv, zs, d_sh, dist, adj, w_dkv, None, w_s, None,
                       g_xagg, g_vecagg, cutoff, nh)


def _upd_launch(rc: bool, adj, wt, wsrc, w_f, b_f, zf_or_edge, g_df, g_edge):
    """Launch K3 (``rc`` False, from zf) or K8 (True, from the edge rows) on
    the card, in the storage type of zf or edge.  Returns (g_edge, g_wt,
    g_wsrc)."""
    B, A, _, H = zf_or_edge.shape
    S = wt.shape[2]
    check_shapes(A, H, S, 1)   # K3/K8 sum no head
    dt, dev = _dtype(zf_or_edge), zf_or_edge.device
    c = lambda name, t, shape: _build.check(name, t, shape, dtype=dt, device=dev)
    for name, t, shape in (
        ("edge" if rc else "zf", zf_or_edge, (B, A, A, H)), ("adj", adj, (B, A, A)),
        ("wt", wt, (B, A, S, H)), ("wsrc", wsrc, (B, A, S, H)), ("g_df", g_df, (B, A, A, H)),
    ) + ((("b_f", b_f, (H,)),) if rc else ()):
        c(name, t, shape)
    w_f = _weight("w_f", w_f, H, 1, dev, dt)
    new = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    if g_edge is None:
        g_edge = torch.zeros((B, A, A, H), dtype=dt, device=dev)
    c("g_edge", g_edge, (B, A, A, H))
    g_wt, g_wsrc = new(B, A, S, H), new(B, A, S, H)
    gz = new(B, A, A, wide_width(H), dtype=_f32)   # scratch: g_zf for the row-tile product
    p = _build.ptr
    if rc:
        gs_e = new(B, A, A, H, dtype=_f32)   # scratch: the source pass's per-edge factor
        args = [p(zf_or_edge), p(adj), p(wt), p(wsrc), p(w_f), p(b_f), p(g_df),
                p(g_edge), p(g_wt), p(g_wsrc), p(gs_e), p(gz)]
    else:
        args = [p(adj), p(wt), p(wsrc), p(w_f), p(zf_or_edge), p(g_df),
                p(g_edge), p(g_wt), p(g_wsrc), p(gz)]
    if dt == _bf16:   # g_wt's sum over the sources' chunks, in float32
        acc = new(B, A, S, H, dtype=_f32)
        args.append(p(acc))
    name = "edge_bwd_upd_rc" if rc else "edge_bwd_upd"
    _build.call(f"{name}{_tag(dt)}_launch", [_P] * len(args) + [_I] * 4, *args, B, A, H, S)
    LAUNCHES[name + _tag(dt)] += 1
    return g_edge, g_wt, g_wsrc


def edge_bwd_upd(adj, wt, wsrc, w_f, zf, g_df, g_edge=None):
    """K3.  Returns (g_edge, g_wt, g_wsrc); given ``g_edge`` (the message
    path's), the edge gradient is added into it in place and that tensor is
    returned.  On bfloat16 tensors its bfloat16 instantiation
    (``edge_bwd_upd_bf16_plain`` on the CPU)."""
    if not route(zf):
        plain = edge_bwd_upd_bf16_plain if zf.dtype == _bf16 else edge_bwd_upd_plain
        return plain(adj, wt, wsrc, w_f, zf, g_df, g_edge, mm=route_mm())
    return _upd_launch(False, adj, wt, wsrc, w_f, None, zf, g_df, g_edge)


def edge_bwd_msg_rc(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                    g_xagg, g_vecagg, cutoff: float, nh: int):
    """K7.  Returns (g_q, g_k, g_v, g_vec, g_edge, g_d_sh, g_dist); on
    bfloat16 tensors its bfloat16 instantiation."""
    if not route(q):
        return edge_bwd_msg_rc_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv,
                                     w_s, b_s, g_xagg, g_vecagg, cutoff, nh, mm=route_mm())
    return _msg_launch(True, q, k, v, vec, edge, None, d_sh, dist, adj, w_dkv, b_dkv, w_s, b_s,
                       g_xagg, g_vecagg, cutoff, nh)


def edge_bwd_upd_rc(edge, adj, wt, wsrc, w_f, b_f, g_df, g_edge=None):
    """K8.  Returns (g_edge, g_wt, g_wsrc), ``g_edge`` as K3's; on bfloat16
    tensors its bfloat16 instantiation."""
    if not route(edge):
        return edge_bwd_upd_rc_plain(edge, adj, wt, wsrc, w_f, b_f, g_df, g_edge,
                                     mm=route_mm())
    return _upd_launch(True, adj, wt, wsrc, w_f, b_f, edge, g_df, g_edge)


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
    is also testable without a card.  bfloat16 inputs take the kernels'
    bfloat16 instantiations (or their plain versions): outputs, stash and
    cotangents in bfloat16."""

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
    K7/K8 on the card, their plain versions on the CPU).  bfloat16 tensors
    of a silu model (the mixed-precision mode) take ``FusedVisMP`` on the
    CPU too: the plain versions of the kernels' bfloat16 instantiations,
    forward and backward, as the JAX package runs its kernels in that mode
    (another activation takes the plain forward in bfloat16, JAX's jnp
    path).
    ``FusedVisMP`` gives the weights no gradient, so it raises where one
    needs it.  ``plain`` is the explicit route of a model with other
    activations than silu (``ViSNetConfig.plain_edge_core``, set by
    ``resolve_config``, as the JAX package sends them to jnp): the plain
    forward (in the inputs' type) and autograd on any device, each call on
    CUDA tensors counted in ``LAUNCHES["plain_edge_core"]`` (``recompute``
    has no effect there).  Otherwise a batch the kernels cannot take
    (``check_shapes``) or another activation than silu raises on the
    card."""
    silu_model = act in SILU and attn_act in SILU
    if plain or (not recompute and not route(q) and (q.dtype != _bf16 or not silu_model)):
        if plain and q.is_cuda:
            LAUNCHES["plain_edge_core"] += 1
        return edge_fwd_plain(q, k, v, vec, edge, d_sh, dist, adj, w_dkv, b_dkv,
                              w_s, b_s, cutoff, nh, wt, wsrc, w_f, b_f, act, attn_act)[:3]
    if not silu_model:
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
