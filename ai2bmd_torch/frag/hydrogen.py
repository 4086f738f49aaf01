"""Cap-hydrogen optimization: batched AMBER energy + unrolled L-BFGS.

Port of ``ai2bmd_tpu/frag/hydrogen.py``.  The energy is the reference's five
AMBER terms (kcal/mol) over per-row index tables; the optimizer is the same
fixed-iteration two-loop-recursion L-BFGS (first step scaled by
min(1, 1/|g|_1) * lr, then lr; curvature-gated history; the gradient after
the final step is not computed).  Its gradients come from
``ops.caps.amber_grad_rows``: kernel K4 on CUDA, autograd of
``amber_row_energy`` on the CPU.  The scalar gates stay on the device as
``torch.where`` so the loop never waits for the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.host import TypeTopology
from ai2bmd_torch.ops import caps
from ai2bmd_torch.ops.caps import CapTables
from ai2bmd_torch.utils.collectives import all_reduce_sum


@dataclasses.dataclass
class HydrogenTables:
    caps: CapTables
    free: torch.Tensor    # [R, S, 1] mask over cap coordinates

    @classmethod
    def build(cls, top: TypeTopology, row_prmtop: list[str], is_cap: np.ndarray,
              device, dtype) -> "HydrogenTables":
        return cls(
            caps=CapTables.build(top, top.type_ids(row_prmtop), is_cap.shape[1], device, dtype),
            free=torch.as_tensor(is_cap[..., None], dtype=dtype, device=device),
        )

    def rows(self, sl: slice) -> "HydrogenTables":
        """The tables of the rows ``sl`` alone (a rank's block of rows)."""
        return HydrogenTables(caps=self.caps.rows(sl), free=self.free[sl])


def _safe_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """|v| over the last axis, with zero value and zero gradient at v == 0
    (the root sees 1.0 there, so autograd gets no NaN)."""
    d2 = (v * v).sum(-1)
    nz = d2 > eps
    return torch.where(nz, torch.sqrt(torch.where(nz, d2, torch.ones_like(d2))),
                       torch.zeros_like(d2))


def _safe_unit(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    d2 = (v * v).sum(-1, keepdim=True)
    nz = d2 > eps
    return v * torch.where(nz, torch.rsqrt(torch.where(nz, d2, torch.ones_like(d2))),
                           torch.zeros_like(d2))


def _take(pos: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pos [..., R,S,3], idx [R,X] -> [..., R,X,3]."""
    return torch.gather(pos, -2, idx[..., None].expand(*pos.shape[:-2], idx.shape[-1], 3))


def _atan2_guarded(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ok = (x * x + y * y) > 1e-12
    return torch.atan2(torch.where(ok, y, torch.zeros_like(y)),
                       torch.where(ok, x, torch.ones_like(x)))


def amber_row_energy(ct: CapTables, pos: torch.Tensor) -> torch.Tensor:
    """AMBER energy of every dipeptide row, pos [..., R,S,3] -> [..., R]
    (kcal/mol).

    Terms as ``ai2bmd_tpu/frag/hydrogen.py:103-151``: 0.5 k (r-r0)^2 bonds,
    0.5 k (th-th0)^2 angles (atan2 form), 0.5 k (1 + cos(n phi - psi))
    dihedrals, (A/r^12 - B/r^6)/scnb + (qq/r)/scee over the exclusion
    complement."""
    r = _safe_norm(_take(pos, ct.bond_ij[..., 0]) - _take(pos, ct.bond_ij[..., 1]))
    e_bond = 0.5 * (ct.bond_k * (r - ct.bond_r0) ** 2).sum(-1)

    pj = _take(pos, ct.angle_ijk[..., 1])
    v0 = _take(pos, ct.angle_ijk[..., 0]) - pj
    v1 = _take(pos, ct.angle_ijk[..., 2]) - pj
    theta = _atan2_guarded(_safe_norm(torch.cross(v0, v1, dim=-1)), (v0 * v1).sum(-1))
    e_angle = 0.5 * (ct.angle_k * (theta - ct.angle_t0) ** 2).sum(-1)

    p0, p1, p2, p3 = (_take(pos, ct.dih_ijkl[..., c]) for c in range(4))
    v0, v1, v2 = p1 - p2, p1 - p0, p3 - p2
    n1 = _safe_unit(torch.cross(v1, v0, dim=-1))
    n2 = _safe_unit(torch.cross(v0, v2, dim=-1))
    m1 = torch.cross(n1, _safe_unit(v0), dim=-1)
    phi = _atan2_guarded((m1 * n2).sum(-1), (n1 * n2).sum(-1))
    e_dih = 0.5 * (ct.dih_k * (1.0 + torch.cos(ct.dih_n * phi - ct.dih_phase))).sum(-1)

    mask = ct.nb_mask
    d = _safe_norm(_take(pos, ct.nb_ij[..., 0]) - _take(pos, ct.nb_ij[..., 1]))
    d_safe = torch.where(mask, torch.clamp(d, min=1e-6), torch.ones_like(d))
    inv6 = d_safe ** -6
    maskf = mask.to(pos.dtype)
    e_vdw = (maskf * (ct.nb_acoef * inv6 * inv6 - ct.nb_bcoef * inv6)).sum(-1) / ct.scnb
    e_el = (maskf * ct.nb_qq / d_safe).sum(-1) / ct.scee
    return e_bond + e_angle + e_dih + e_vdw + e_el


def amber_energy(ht: HydrogenTables, pos: torch.Tensor) -> torch.Tensor:
    """Total AMBER energy over all rows; pos [R,S,3] -> scalar."""
    return amber_row_energy(ht.caps, pos).sum()


@torch.no_grad()
def optimize_caps(ht: HydrogenTables, pos: torch.Tensor, n_iter: int = 10,
                  lr: float = 0.1, group=None) -> torch.Tensor:
    """L-BFGS over the cap-H coordinates; fixed n_iter, history = n_iter.

    pos [R,S,3]: one solve joint over all rows, like the reference's single
    torch LBFGS over the batch (the two-loop inner products couple every
    row).  With ``group`` (a process group whose ranks each hold a block of
    the rows, ``ht`` that block's tables) every scalar of the solve, the
    first step's L1 norm and each inner product, is summed over the group,
    so that each rank walks the joint solve's iterates on its own rows
    (``axis_name``, ``ai2bmd_tpu/frag/hydrogen.py:165-189``).  pos
    [Rl,R,S,3]: one such solve per replica, with its own inner products,
    step scale and curvature gates (``jax.vmap`` of the joint solve,
    ``ai2bmd_tpu/frag/runtime.py:386-388``), on one rank; the gradient of
    every replica's rows comes from one cap-gradient call per iteration."""
    if n_iter == 0:
        return pos
    shape = pos.shape
    free = ht.free.expand(shape[-3:]).reshape(-1)
    if pos.dim() == 4:                   # per replica: scalars [Rl, 1]
        if group is not None:
            raise ValueError("the per-replica solve takes no process group")
        x = pos.reshape(shape[0], -1)
        scalar = (shape[0], 1)
        dot = lambda a, b: (a * b).sum(-1, keepdim=True)
        l1 = lambda a: a.abs().sum(-1, keepdim=True)
    else:
        x = pos.reshape(-1)
        scalar = ()
        gsum = (lambda t: t) if group is None else (lambda t: all_reduce_sum(t, group))
        dot = lambda a, b: gsum(torch.dot(a, b))
        l1 = lambda a: gsum(a.abs().sum())
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

    def egrad(x):
        return caps.amber_grad_rows(ht.caps, x.reshape(shape)).reshape(x.shape) * free

    def two_loop(g, s_hist, y_hist, rho_hist, gamma):
        q = g
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist), reversed(rho_hist)):
            al = rho * dot(s, q)
            q = q - al * y
            alphas.append(al)
        alphas = alphas[::-1]
        r = gamma * q
        for s, y, rho, al in zip(s_hist, y_hist, rho_hist, alphas):
            be = rho * dot(y, r)
            r = r + s * (al - be)
        return -r

    g = egrad(x)
    s_hist, y_hist, rho_hist = [], [], []
    gamma = torch.ones(scalar, dtype=pos.dtype, device=pos.device)
    for it in range(n_iter):
        if it == 0:
            d = -g
            t = torch.clamp(1.0 / torch.clamp(l1(g), min=1e-10), max=1.0) * lr
        else:
            d = two_loop(g, s_hist, y_hist, rho_hist, gamma)
            t = lr
        x_new = x + t * d
        if it == n_iter - 1:
            x = x_new
            break
        g_new = egrad(x_new)
        y = g_new - g
        s = t * d
        ys = dot(y, s)
        ok = ys > 1e-10
        okf = ok.to(pos.dtype)
        s_hist.append(s * okf)
        y_hist.append(y * okf)
        rho_hist.append(torch.where(ok, 1.0 / torch.where(ok, ys, torch.ones_like(ys)), zero))
        gamma = torch.where(ok, ys / torch.clamp(dot(y, y), min=1e-10), gamma)
        x, g = x_new, g_new
    return x.reshape(shape)
