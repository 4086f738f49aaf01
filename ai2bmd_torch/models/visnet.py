"""ViSNet equivariant GNN potential in PyTorch.

Port of ``ai2bmd_tpu/models/visnet.py`` with the same dense formulation:
fragments padded to [B, A] with a validity mask, the graph a dense
[B, A, A] adjacency within the cutoff (self loops included), the vector
message and the vector-rejection edge update contracted to [B, A, A, H]
intermediates, and forces from autograd of the summed energy.  The layer
math is the jnp branch of ``vis_mp_layer`` (visnet.py:416-474); its edge
core goes through ``ops.vismp.edge_core``, which is the plain version on CPU
tensors and kernels K1-K3 on CUDA tensors (the kernel branch, :391-414).
With ``fused_layer`` every layer runs whole through ``ops.vislayer``
(kernels K5/K6 on CUDA tensors, their plain versions on CPU tensors), the
branch of :506-536.

``remat`` trades arithmetic for memory as the JAX config's does
(:59-62, applied at :567-568), but not in the same way.  ``jax.checkpoint``
replays each whole layer in the backward; here only the edge core is
recomputed: its forward (K1) keeps no zdkv/zs/zf stash and its backward
(K7/K8, or their plain versions on CPU tensors) rebuilds the O(B·A²·H) edge
products, which dominate the memory, from the edge rows, while autograd
keeps the node side's [B,A,H]-sized activations as usual.  The gradient is
the same either way.  ``fused_layer`` ignores ``remat``, as the JAX
full-layer branch returns before :567 (K6 always recomputes).

A model on the card with another activation than silu runs every edge core
through its plain version, on the card, as the JAX package sends such a
model to jnp: ``resolve_config`` sets ``plain_edge_core`` once when the
model is configured and logs the reason; each such call on CUDA tensors adds
one to ``LAUNCHES["plain_edge_core"]``.  The kernels take every H that
the head count divides, as JAX's do; a silu model of shapes they do not
take (S > 8, which no model of either package builds;
``ops.vismp.unsupported_shapes``, the edge and the full-layer kernels' one
domain) is refused on the card when it is configured.

``edge_dtype=torch.bfloat16`` is the JAX config's mixed-precision mode
(:63-66, applied at :545-556): each ViS-MP layer runs on bfloat16 copies of
its weights and of x, vec, dist, edge_attr, d_sh and adj, and its dx, dvec
and df go back to float32 onto the float32 residual streams.  Its edge
core runs the bfloat16 instantiations of K1-K3 (K1, K7, K8 with ``remat``)
on the card and their plain versions on the CPU (the kernel model, what
the JAX kernels compute on bfloat16); a model with other activations than
silu runs the plain edge core in bfloat16, as JAX's jnp path.  The
full-layer kernels take float32 only, as JAX's ``use_full_layer`` requires
``edge_dtype`` None (:511): ``resolve_config`` gives such a model the
per-layer path.

Not ported (options of the JAX config that no production path sets):
``exact_rejection``, and the switches ``fused`` and the ``*_interpret``
flags, which the tensors' device replaces.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import weakref

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from ai2bmd_torch.models import params as PM
from ai2bmd_torch.ops import vislayer as FL
from ai2bmd_torch.ops.vismp import (_ACTS, cosine_cutoff, edge_core, padded_weight,
                                    plain_activations, unsupported_shapes, wide_width)

__all__ = [
    "ViSNet", "ViSNetConfig", "atomwise_energy", "cosine_cutoff", "dense_graph",
    "energy", "energy_and_forces", "expnorm_rbf", "gated_equivariant_block",
    "layer_norm", "representation", "resolve_config", "spherical_harmonics",
    "vec_layer_norm", "vis_mp_layer",
]


@dataclasses.dataclass(frozen=True)
class ViSNetConfig:
    lmax: int = 2
    hidden_channels: int = 256
    num_heads: int = 8
    num_layers: int = 9
    num_rbf: int = 32
    cutoff: float = 5.0
    max_z: int = 100
    vecnorm_type: str = "none"        # none | rms | max_min
    activation: str = "silu"
    attn_activation: str = "silu"
    # the reference's hyperparameters, which config_from_hparams fills
    # (models/checkpoint.py); as in the JAX model, neither is read: the
    # aggregation always sums and the RBF is never trained (MD
    # differentiates positions only).  The JAX config's dtype is the
    # module's dtype here.
    reduce_op: str = "add"
    trainable_rbf: bool = False
    # fused_layer=True runs each complete ViS-MP layer as one kernel pair
    # (ops/vislayer.py: K5 forward, recompute-mode K6 backward) instead of
    # the edge-core kernels K1-K3 and the eager node side.  Needs silu
    # activations, vecnorm "none" and A % 8 == 0 (a fragment or a whole
    # molecule of any size; raises otherwise), and takes every width the
    # edge kernels take (on the card at H % 32 != 0 with each layer's
    # weights padded once).  Weight gradients are not computed on this
    # path: training uses the default.
    fused_layer: bool = False
    # remat=True runs the edge core's backward in recompute mode (kernels
    # K7/K8, the plain versions on the CPU): less device memory for large
    # fragment batches, more arithmetic.  Needs silu activations.  Like the
    # card's edge kernels, it gives the edge-core weights no gradient, so a
    # weight that needs one raises: training uses the default.
    remat: bool = False
    # plain_edge_core=True runs every layer's edge core through its plain
    # PyTorch version, on the card too (counted in
    # LAUNCHES["plain_edge_core"]): the explicit route that resolve_config
    # sets for a model on the card with other activations than silu, as the
    # JAX package sends them to jnp.  It takes the place of fused_layer and
    # remat.
    plain_edge_core: bool = False
    # edge_dtype=torch.bfloat16: the mixed-precision mode (module docstring);
    # None keeps every layer in float32.  No other type: the JAX package's
    # callers pass bfloat16 alone (bench.py:84, benchmarks/vis_micro.py:67).
    edge_dtype: torch.dtype | None = None

    def __post_init__(self):
        if self.edge_dtype not in (None, torch.bfloat16):
            raise ValueError(f"edge_dtype={self.edge_dtype}: the edge kernels store float32 or "
                             f"bfloat16 (ROADMAP.md, Queue 2: float16 and other types are "
                             f"still to port)")

    @property
    def n_sphere(self) -> int:
        return (self.lmax + 1) ** 2 - 1


def resolve_config(cfg: ViSNetConfig, device) -> ViSNetConfig:
    """The config a model on ``device`` runs (``ai2bmd_tpu/models/visnet.py:
    102-131``): on the card, ``AI2BMD_FUSED_LAYER=1`` selects the full-layer
    kernels K5/K6; the default there is the edge-core kernels K1-K3.  A
    model on the card with other activations than silu (``ops.vismp.
    plain_activations``) gets the explicit plain route instead
    (``plain_edge_core``), with one logged line naming the reason; a silu
    model of shapes the kernels do not take (K1-K3 and K5/K6 take the same
    ones) raises here, once, naming ROADMAP.md Queue 2: it never falls back
    to the plain edge core.  A model with ``edge_dtype``
    set runs the per-layer path on any device: ``fused_layer`` or
    ``AI2BMD_FUSED_LAYER=1`` gives way to it with one logged line, as JAX's
    ``use_full_layer`` does (visnet.py:506-514).  Otherwise a config with
    ``fused_layer`` already set, or a model on the CPU, is returned as it
    is; H not a multiple of the head count raises."""
    if cfg.hidden_channels % cfg.num_heads:
        raise ValueError(f"hidden_channels={cfg.hidden_channels} is not a multiple of "
                         f"num_heads={cfg.num_heads}")
    log = logging.getLogger(__name__)
    cuda = torch.device(device).type == "cuda"
    if cfg.edge_dtype is not None and (
            cfg.fused_layer or (cuda and os.environ.get("AI2BMD_FUSED_LAYER") == "1")):
        log.warning("ViSNet %d x %d, %d heads, edge_dtype=%s: the full-layer kernels K5/K6 take "
                    "float32 only (the JAX package's use_full_layer needs edge_dtype None); "
                    "every layer runs the per-layer path", cfg.num_layers, cfg.hidden_channels,
                    cfg.num_heads, str(cfg.edge_dtype).replace("torch.", ""))
        cfg = dataclasses.replace(cfg, fused_layer=False)
    if not cuda:
        return cfg
    why = plain_activations(cfg.activation, cfg.attn_activation)
    if why is not None:
        log.warning(
            "ViSNet %d x %d, %d heads: %s; every edge core runs its plain PyTorch version on "
            "the card (LAUNCHES['plain_edge_core']), as the JAX package runs jnp there",
            cfg.num_layers, cfg.hidden_channels, cfg.num_heads, why)
        return dataclasses.replace(cfg, plain_edge_core=True, fused_layer=False, remat=False)
    shapes = unsupported_shapes(cfg.hidden_channels, cfg.num_heads, cfg.n_sphere)
    if shapes is not None:
        raise ValueError(f"ViSNet {cfg.num_layers} x {cfg.hidden_channels}, {cfg.num_heads} "
                         f"heads on the card: {shapes}")
    if (cfg.fused_layer or cfg.edge_dtype is not None
            or os.environ.get("AI2BMD_FUSED_LAYER") != "1"):
        return cfg
    return dataclasses.replace(cfg, fused_layer=True)


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _safe_inv_norm(vec, eps=1e-12):
    """1/|vec| over the last axis (kept), zero value and gradient at 0."""
    d2 = (vec * vec).sum(-1, keepdim=True)
    nonzero = d2 > eps
    inv = torch.where(nonzero, torch.rsqrt(torch.where(nonzero, d2, torch.ones_like(d2))),
                      torch.zeros_like(d2))
    return inv, nonzero


def _safe_norm(vec, dim=-1, keepdim=False, eps=1e-12):
    d2 = (vec * vec).sum(dim, keepdim=keepdim)
    nonzero = d2 > eps
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def expnorm_rbf(p: dict, dist: torch.Tensor, cfg: ViSNetConfig) -> torch.Tensor:
    alpha = 5.0 / cfg.cutoff
    d = dist[..., None]
    return cosine_cutoff(d, cfg.cutoff) * torch.exp(
        -p["betas"] * (torch.exp(-alpha * d) - p["means"]) ** 2
    )


def spherical_harmonics(unit_vec: torch.Tensor, lmax: int) -> torch.Tensor:
    """Real SH of a unit vector: l=1 (x, y, z) and, for lmax 2, the l=2 block."""
    x, y, z = unit_vec.unbind(-1)
    comps = [x, y, z]
    if lmax >= 2:
        s3 = math.sqrt(3.0)
        comps += [
            s3 * x * z,
            s3 * x * y,
            y * y - 0.5 * (x * x + z * z),
            s3 * y * z,
            (s3 / 2.0) * (z * z - x * x),
        ]
    return torch.stack(comps, dim=-1)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        # as jnp computes it on bfloat16: the mean and the variance in
        # float32, each rounded once, 1 / sqrt exactly rounded, every other
        # step rounded to bfloat16
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True).to(x.dtype)
        r = (1.0 / torch.sqrt((var + torch.tensor(eps, dtype=x.dtype)).float())).to(x.dtype)
        return (x - mu.to(x.dtype)) * r * p["scale"] + p["bias"]
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def vec_layer_norm(p: dict, vec: torch.Tensor, norm_type: str, lmax: int) -> torch.Tensor:
    """VecLayerNorm over vec [..., S, H] (reference utils.py:165-249)."""
    if norm_type == "none":
        return vec * p["weight"]

    def norm_block(v):
        dist = _safe_norm(v, dim=-2, keepdim=True)               # [..., 1, H]
        if norm_type == "rms":
            ms = (dist ** 2).mean(-1, keepdim=True)
            pos = ms > 1e-24
            rms = torch.where(pos, torch.sqrt(torch.where(pos, ms, torch.ones_like(ms))),
                              torch.zeros_like(ms))
            inv = torch.where(rms > 1e-12, 1.0 / torch.clamp(rms, min=1e-12),
                              torch.zeros_like(rms))
            return v * inv
        if norm_type != "max_min":
            raise ValueError(f"unknown vecnorm_type {norm_type!r}")
        direct = v / torch.clamp(dist, min=1e-12)
        mx = dist.amax(-1, keepdim=True)
        mn = dist.amin(-1, keepdim=True)
        delta = torch.where(mx - mn == 0, torch.ones_like(mx), mx - mn)
        return F.relu((dist - mn) / delta) * direct

    if lmax >= 2:
        vec = torch.cat([norm_block(vec[..., :3, :]), norm_block(vec[..., 3:8, :])], dim=-2)
    else:
        vec = norm_block(vec)
    return vec * p["weight"]


def dense_graph(pos: torch.Tensor, mask: torch.Tensor, cfg: ViSNetConfig):
    """All-pairs graph within one padded fragment.

    Returns adj [B,A,A] (edges incl. self loops: both endpoints valid and
    r < cutoff), adj_ns (without self loops), dist [B,A,A] (0 on self loops)
    and d_sh [B,A,A,S], the spherical features of the unit edge vector."""
    A = pos.shape[1]
    vec = pos[:, None, :, :] - pos[:, :, None, :]       # j - i (source - centre)
    inv, nonzero = _safe_inv_norm(vec)
    dist = _safe_norm(vec)
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)
    pair_valid = mask[:, :, None] & mask[:, None, :]
    adj = pair_valid & ((dist < cfg.cutoff) | eye)
    adj_ns = adj & ~eye & nonzero[..., 0]
    return adj, adj_ns, dist, spherical_harmonics(vec * inv, cfg.lmax)


# A layer's weights zero-padded for the wide kernels (H % 32 != 0): the
# edge-core weights of the per-layer path (_PADDED) and the full-layer
# route's tuple (_PADDED_LAYER), each keyed on the layer's s_proj weight:
# made at the first evaluation on the card and kept while the layer's
# weights are the same tensors at the same versions, so a graphed step
# replays no padding.
_PADDED = WeakIdKeyDictionary()
_PADDED_LAYER = WeakIdKeyDictionary()
# and a layer's bfloat16 copy in the mixed-precision mode (_cast_layer)
_CAST = WeakIdKeyDictionary()


def _padded_once(cache, key, src, make):
    """make() for the weights ``src``, kept in ``cache`` under ``key`` while
    they are the same tensors at the same versions."""
    hit = cache.get(key)
    if hit is None or len(hit[0]) != len(src) or any(
            r() is not t or u != t._version for (r, u), t in zip(hit[0], src)):
        hit = cache[key] = ([(weakref.ref(t), t._version) for t in src], make())
    return hit[1]


def _padded_edge_weights(lp: dict, H: int, last: bool):
    """(W_dkv, W_s, W_f or None) of one layer as the wide kernels read them
    (``ops.vismp.padded_weight``), padded once per model."""
    src = tuple(lp[k]["w"] for k in ("dk_proj", "dv_proj", "s_proj")
                + (() if last else ("f_proj",)))
    return _padded_once(_PADDED, src[2], src, lambda: (
        padded_weight(torch.cat(src[:2], dim=1), H, 2), padded_weight(src[2], H, 2),
        None if last else padded_weight(src[3], H)))


def _padded_layer_weights(lp: dict, H: int, nh: int, last: bool, dtype):
    """One layer's fused-layer weight tuple as K5/K6's wide instantiation
    reads it (``ops.vislayer.padded_layer_weights``), padded once per model."""
    src = tuple(t for k in sorted(lp) for t in lp[k].values())
    return _padded_once(_PADDED_LAYER, lp["s_proj"]["w"], src, lambda: FL.padded_layer_weights(
        FL.layer_weights(lp, H, nh, last, dtype), H))


def _cast_layer(lp: dict, dtype) -> dict:
    """A layer's parameter tree in the mixed-precision mode's type, cast once
    per model (kept while the layer's weights are the same tensors at the
    same versions, as the padded weights are)."""
    src = tuple(t for k in sorted(lp) for t in lp[k].values())
    cast = lambda: {k: {n: t.to(dtype) for n, t in sub.items()} for k, sub in lp.items()}
    if torch.is_grad_enabled() and any(t.requires_grad for t in src):
        return cast()   # a copy that carries the weights' gradient is made anew
    return _padded_once(_CAST, lp["s_proj"]["w"], src, cast)


# In the mixed-precision mode the layer runs on bfloat16 tensors, each
# operation rounded to bfloat16 as in the JAX package, except where XLA
# computes one in float32: an operation on bfloat16 operands whose result is
# converted to float32 next is computed in float32 (XLA's excess
# precision; measured on the JAX package's CPU runs).  In the layer's node
# side that is the product summed by vec_dot (jnp.sum upcasts it) and the
# last add of dx and dvec, which the residual streams take in float32.
def _mixed_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b).sum(-2), in float32 for bfloat16 a, b (rounded once)."""
    if a.dtype != torch.bfloat16:
        return (a * b).sum(-2)
    return (a.float() * b.float()).sum(-2).to(a.dtype)


def _mixed_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, in float32 (unrounded) for bfloat16 a, b."""
    if a.dtype != torch.bfloat16:
        return a + b
    return a.float() + b.float()


def vis_mp_layer(lp: dict, x, vec, adj_f, dist, edge_attr, d_sh, cfg: ViSNetConfig,
                 last: bool):
    """One ViS_MP update (reference visnet_block.py:237-312).

    x [B,A,H]; vec [B,A,S,H]; adj_f [B,A,A] float (self loops included);
    dist [B,A,A]; edge_attr [B,A,A,H]; d_sh [B,A,A,S].
    Returns (dx, dvec, df or None)."""
    H, nh = cfg.hidden_channels, cfg.num_heads
    x = layer_norm(lp["layernorm"], x)
    vec = vec_layer_norm(lp["vec_layernorm"], vec, cfg.vecnorm_type, cfg.lmax)

    w_qkv = torch.cat([lp["q_proj"]["w"], lp["k_proj"]["w"], lp["v_proj"]["w"]], dim=1)
    b_qkv = torch.cat([lp["q_proj"]["b"], lp["k_proj"]["b"], lp["v_proj"]["b"]])
    q, k, v = (x @ w_qkv + b_qkv).split(H, dim=-1)
    b_dkv = torch.cat([lp["dk_proj"]["b"], lp["dv_proj"]["b"]])
    if x.is_cuda and not cfg.plain_edge_core and wide_width(H) != H:
        w_dkv, w_s, w_f = _padded_edge_weights(lp, H, last)
    else:
        w_dkv = torch.cat([lp["dk_proj"]["w"], lp["dv_proj"]["w"]], dim=1)
        w_s, w_f = lp["s_proj"]["w"], None if last else lp["f_proj"]["w"]

    vec1, vec2, vec3 = _linear(lp["vec_proj"], vec).split(H, dim=-1)
    vec_dot = _mixed_sum(vec1, vec2)                      # [B,A,H]

    upd = {}
    if not last:
        # edge update: silu(f_proj(edge)) * <W_trg vec_i, W_src vec_j>_c * adj
        # (the vector rejections' |d_sh|^2 - 2 correction vanishes)
        upd = dict(wt=_linear(lp["w_trg_proj"], vec), wsrc=_linear(lp["w_src_proj"], vec),
                   w_f=w_f, b_f=lp["f_proj"]["b"])
    x_agg, vec_agg, df = edge_core(
        q, k, v, vec, edge_attr, d_sh, dist, adj_f, w_dkv, b_dkv,
        w_s, lp["s_proj"]["b"], cfg.cutoff, nh,
        act=cfg.activation, attn_act=cfg.attn_activation, recompute=cfg.remat,
        plain=cfg.plain_edge_core, **upd,
    )
    o1, o2, o3 = _linear(lp["o_proj"], x_agg).split(H, dim=-1)
    dx = _mixed_add(vec_dot * o2, o3)
    dvec = _mixed_add(vec3 * o1[:, :, None, :], vec_agg)
    return dx, dvec, df


def representation(params: dict, z, pos, mask, cfg: ViSNetConfig):
    """ViSNetBlock forward (visnet_block.py:103-142): embeddings + MP stack."""
    B, A = z.shape
    dtype = pos.dtype
    adj, adj_ns, dist, d_sh = dense_graph(pos, mask, cfg)
    adj_f = adj.to(dtype)
    maskf = mask[..., None].to(dtype)

    x = params["embedding"][z] * maskf
    edge_rbf = expnorm_rbf(params["rbf"], dist, cfg) * adj_f[..., None]

    # neighbour embedding (self loops removed; utils.py:296-317)
    ne = params["neighbor_embedding"]
    C = cosine_cutoff(dist, cfg.cutoff) * adj_ns.to(dtype)
    W = _linear(ne["distance_proj"], edge_rbf) * C[..., None]
    x_nbr = torch.einsum("bjh,bijh->bih", ne["embedding"][z] * maskf, W)
    x = _linear(ne["combine"], torch.cat([x, x_nbr], dim=-1)) * maskf

    # edge embedding over all edges incl. self loops (utils.py:331-341)
    edge_attr = ((x[:, :, None, :] + x[:, None, :, :])
                 * _linear(params["edge_embedding"]["edge_proj"], edge_rbf)
                 * adj_f[..., None])

    if cfg.fused_layer and cfg.edge_dtype is None:
        return _fused_layer_stack(params, x, edge_attr, dist, d_sh, adj_f, cfg)

    vec = torch.zeros((B, A, cfg.n_sphere, cfg.hidden_channels), dtype=dtype,
                      device=pos.device)
    ed = cfg.edge_dtype
    if ed is not None:   # the mixed-precision mode (visnet.py:545-556)
        adj_c, dist_c, d_sh_c = adj_f.to(ed), dist.to(ed), d_sh.to(ed)
    for li, lp in enumerate(params["layers"]):
        last = li == cfg.num_layers - 1
        if ed is None:
            dx, dvec, df = vis_mp_layer(lp, x, vec, adj_f, dist, edge_attr, d_sh, cfg, last)
        else:
            # dx and dvec come back in float32 (_mixed_add), df in bfloat16,
            # which the float32 edge stream's add promotes
            dx, dvec, df = vis_mp_layer(_cast_layer(lp, ed), x.to(ed), vec.to(ed), adj_c,
                                        dist_c, edge_attr.to(ed), d_sh_c, cfg, last)
        x = x + dx
        vec = vec + dvec
        if df is not None:
            edge_attr = edge_attr + df

    x = layer_norm(params["out_norm"], x)
    vec = vec_layer_norm(params["vec_out_norm"], vec, cfg.vecnorm_type, cfg.lmax)
    return x, vec


def _fused_layer_stack(params: dict, x, edge_attr, dist, d_sh, adj_f, cfg: ViSNetConfig):
    """The MP stack through ``ops.vislayer.fused_layer`` (visnet.py:506-536):
    the vector stream stays sphere-major [B,S,A,H] across the layers and is
    transposed once at the stack's entry and exit.  On the card at H % 32
    != 0 each layer's weights go padded (``_padded_layer_weights``)."""
    B, A, H = x.shape
    silu = ("silu", "swish")
    if (A % 8 or cfg.vecnorm_type != "none" or cfg.activation not in silu
            or cfg.attn_activation not in silu):
        raise ValueError(
            f"fused_layer needs A % 8 == 0, vecnorm_type 'none' and silu activations; got "
            f"A={A}, vecnorm_type={cfg.vecnorm_type!r}, activation={cfg.activation!r}, "
            f"attn_activation={cfg.attn_activation!r}")
    vec_sm = x.new_zeros((B, cfg.n_sphere, A, H))
    dsh_sm = d_sh.permute(0, 3, 1, 2).contiguous()
    for li, lp in enumerate(params["layers"]):
        last = li == cfg.num_layers - 1
        op = FL.fused_layer(cfg.cutoff, cfg.num_heads, last)
        w = (_padded_layer_weights(lp, H, cfg.num_heads, last, x.dtype)
             if x.is_cuda and wide_width(H) != H else
             FL.layer_weights(lp, H, cfg.num_heads, last, x.dtype))
        x, vec_sm, edge_attr = op(x, vec_sm, edge_attr, dsh_sm, dist, adj_f, *w)
    x = layer_norm(params["out_norm"], x)
    vec = vec_layer_norm(params["vec_out_norm"], vec_sm.transpose(1, 2), cfg.vecnorm_type,
                         cfg.lmax)
    return x, vec


def gated_equivariant_block(p: dict, x, v, scalar_activation: bool, cfg: ViSNetConfig):
    """output_modules.py:9-62."""
    act = _ACTS[cfg.activation]
    vec1 = _safe_norm(_linear(p["vec1_proj"], v), dim=-2)
    vec2 = _linear(p["vec2_proj"], v)
    out = _linear(p["update1"], act(_linear(p["update0"], torch.cat([x, vec1], dim=-1))))
    x, gate = out.chunk(2, dim=-1)
    v = gate[:, :, None, :] * vec2
    if scalar_activation:
        x = act(x)
    return x, v


def atomwise_energy(params: dict, z, pos, mask, cfg: ViSNetConfig):
    """Per-atom scalar contributions [B, A], masked."""
    x, v = representation(params, z, pos, mask, cfg)
    x, v = gated_equivariant_block(params["output"]["block0"], x, v, True, cfg)
    x, v = gated_equivariant_block(params["output"]["block1"], x, v, False, cfg)
    x = x + v.sum() * 0.0            # grad-keeper parity (output_modules.py:140)
    x = x * params["std"]
    x = x + params["atomref"][z]
    return x[..., 0] * mask.to(x.dtype)


def energy(params: dict, z, pos, mask, cfg: ViSNetConfig):
    """Per-fragment energies [B] (reference visnet.py:135-150)."""
    return atomwise_energy(params, z, pos, mask, cfg).sum(-1) + params["mean"]


def energy_and_forces(params: dict, z, pos, mask, cfg: ViSNetConfig):
    """E [B] and F [B,A,3] = -dE/dpos (masked), by autograd."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        e = energy(params, z, p, mask, cfg)
        (g,) = torch.autograd.grad(e.sum(), p, create_graph=False)
    return e.detach(), -g * mask[..., None].to(g.dtype)


class ViSNet(nn.Module):
    """The parameter tree as an ``nn.Module``, so ``.to(device, dtype)``
    moves and casts it; the computation is the plain functions above.
    Parameters do not require gradients: MD differentiates positions only."""

    def __init__(self, cfg: ViSNetConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for path, leaf in PM.flatten(params):
            name = "__".join(map(str, path))
            self.register_parameter(
                name, nn.Parameter(torch.as_tensor(leaf).clone(), requires_grad=False))
            self._paths.append((name, path))

    def params(self) -> dict:
        """The parameter tree (current tensors) in the JAX layout."""
        return PM.unflatten([(path, getattr(self, name)) for name, path in self._paths])

    def forward(self, z, pos, mask):
        return energy(self.params(), z, pos, mask, self.cfg)
