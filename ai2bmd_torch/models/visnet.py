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
one to ``LAUNCHES["plain_edge_core"]``.  A silu model of shapes the kernels
do not take (H > 256, S > 8) is refused on the card when it is configured.

Not ported (options of the JAX config that no production path sets):
``exact_rejection``, ``edge_dtype``, and the switches ``fused`` and the
``*_interpret`` flags, which the tensors' device replaces.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ai2bmd_torch.models import params as PM
from ai2bmd_torch.ops import vislayer as FL
from ai2bmd_torch.ops.vismp import (_ACTS, cosine_cutoff, edge_core, plain_activations,
                                    unsupported_shapes)

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
    # activations, vecnorm "none" and A % 8 == 0, and on the card A <= 1024
    # (a fragment or a whole molecule; raises otherwise).  Weight gradients
    # are not computed on this path: training uses the default.
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
    model of shapes the kernels do not take raises here, once, naming
    ROADMAP.md Queue 2.  A config with ``fused_layer`` already set, or a
    model on the CPU, is returned as it is; H not a multiple of the head
    count raises."""
    if cfg.hidden_channels % cfg.num_heads:
        raise ValueError(f"hidden_channels={cfg.hidden_channels} is not a multiple of "
                         f"num_heads={cfg.num_heads}")
    if torch.device(device).type != "cuda":
        return cfg
    why = plain_activations(cfg.activation, cfg.attn_activation)
    if why is not None:
        logging.getLogger(__name__).warning(
            "ViSNet %d x %d, %d heads: %s; every edge core runs its plain PyTorch version on "
            "the card (LAUNCHES['plain_edge_core']), as the JAX package runs jnp there",
            cfg.num_layers, cfg.hidden_channels, cfg.num_heads, why)
        return dataclasses.replace(cfg, plain_edge_core=True, fused_layer=False, remat=False)
    shapes = unsupported_shapes(cfg.hidden_channels, cfg.num_heads, cfg.n_sphere)
    if shapes is not None:
        raise ValueError(f"ViSNet {cfg.num_layers} x {cfg.hidden_channels}, {cfg.num_heads} "
                         f"heads on the card: {shapes}")
    if cfg.fused_layer:
        return cfg
    if os.environ.get("AI2BMD_FUSED_LAYER") == "1":
        return dataclasses.replace(cfg, fused_layer=True)
    return cfg


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
    w_dkv = torch.cat([lp["dk_proj"]["w"], lp["dv_proj"]["w"]], dim=1)
    b_dkv = torch.cat([lp["dk_proj"]["b"], lp["dv_proj"]["b"]])

    vec1, vec2, vec3 = _linear(lp["vec_proj"], vec).split(H, dim=-1)
    vec_dot = (vec1 * vec2).sum(-2)                        # [B,A,H]

    upd = {}
    if not last:
        # edge update: silu(f_proj(edge)) * <W_trg vec_i, W_src vec_j>_c * adj
        # (the vector rejections' |d_sh|^2 - 2 correction vanishes)
        upd = dict(wt=_linear(lp["w_trg_proj"], vec), wsrc=_linear(lp["w_src_proj"], vec),
                   w_f=lp["f_proj"]["w"], b_f=lp["f_proj"]["b"])
    x_agg, vec_agg, df = edge_core(
        q, k, v, vec, edge_attr, d_sh, dist, adj_f, w_dkv, b_dkv,
        lp["s_proj"]["w"], lp["s_proj"]["b"], cfg.cutoff, nh,
        act=cfg.activation, attn_act=cfg.attn_activation, recompute=cfg.remat,
        plain=cfg.plain_edge_core, **upd,
    )
    o1, o2, o3 = _linear(lp["o_proj"], x_agg).split(H, dim=-1)
    dx = vec_dot * o2 + o3
    dvec = vec3 * o1[:, :, None, :] + vec_agg
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

    if cfg.fused_layer:
        return _fused_layer_stack(params, x, edge_attr, dist, d_sh, adj_f, cfg)

    vec = torch.zeros((B, A, cfg.n_sphere, cfg.hidden_channels), dtype=dtype,
                      device=pos.device)
    for li, lp in enumerate(params["layers"]):
        dx, dvec, df = vis_mp_layer(lp, x, vec, adj_f, dist, edge_attr, d_sh, cfg,
                                    last=li == cfg.num_layers - 1)
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
    transposed once at the stack's entry and exit."""
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
        w = FL.layer_weights(lp, H, cfg.num_heads, last, x.dtype)
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
