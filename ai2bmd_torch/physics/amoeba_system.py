"""Neighbour-listed periodic AMOEBA nonbonded engine.

Port of ``ai2bmd_tpu/physics/amoeba_system.py``: the full AMOEBA nonbonded
energy of an assigned system (protein + water, ``physics/amoeba_protein.
assign_amoeba``) under periodic boundaries over an [N, K] neighbour list
(``ops/neighbors.py``), the replacement for the solvated-system evaluations
the reference ships to Tinker9 every step (src/Calculators/tinker_async.py:
155-181).  Every pair quantity is a flat [N, K] plane, and every per-atom
quantity is packed into one [N, 15] matrix gathered once a pair set
(``_packed``), as in JAX.

Terms (``amoeba_system.py:23-42``):

  permanent  erfc multipole pairs over the list (each unordered pair once),
             order-6 SPME reciprocal, self term, and (s - 1) x the full
             Coulomb pair energy of the 1-2 / 1-3 / 1-4 / 1-5 mpole-scaled
             pairs
  induction  the variational solve over the full Ewald interaction
             (``energy_ewald_variational``, the QM/MM backend's): both
             Tinker fields, A mu_d = E_d and A mu_p = E_p, by a two-column
             Jacobi-preconditioned CG of fixed length under ``torch.no_grad``
             from the carried dipoles, A the explicit mutual operator
             (``_mutual_operator``: 1/alpha, the Thole-damped Ewald dipole
             tensor over the list, and the mesh's dipole gradient); the
             energy is the fixed-dipole functional Phi, whose position
             gradient is the converged polarization force, recomputed in
             the backward pass (``torch.utils.checkpoint``, as
             ``jax.checkpoint``).  Or the unrolled solve of pure-AMOEBA MD
             (``energy_ewald_induction``, ``physics/amoeba_md.py``): a
             fixed number of PCG iterations on the d-masked functional with
             the gradient through every iteration, F(m) + pcorr(m) its
             energy.  Or SOR over real-space Thole fields (``energy``,
             ``induction="sor"``)
  vdW        buffered 14-7 over the list, shifted to zero at the cutoff, with
             scaled-pair corrections

Units: positions A, energy eV.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from ai2bmd_torch import units
from ai2bmd_torch.ops.neighbors import (NeighborList, build_neighbor_list,
                                        build_neighbor_list_cells, cell_grid, gather_rows)
from ai2bmd_torch.ops.neighbors import _pbc_diff as _minimum_image
from ai2bmd_torch.physics import amoeba_pme as MP
from ai2bmd_torch.physics.amoeba import _thole_lambdas, rotate_multipoles
from ai2bmd_torch.physics.amoeba_protein import (MPOLE_SCALES, POLAR_SCALES, VDW_SCALES,
                                                 AmoebaAssignment)
from ai2bmd_torch.utils.device import resolve_device

_T6 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
# packed per-atom matrix columns: q, mu(3), theta6(6), pdamp, thole, pos(3)
_Q, _MU, _T, _PD, _TH, _POS = 0, 1, 4, 10, 11, 12


def _where(mask, a, value: float):
    return torch.where(mask, a, torch.full_like(a, value))


def _slices(M):
    """(q, mu3, t6, pdamp, thole, pos3) column views of packed rows."""
    return (M[..., _Q], (M[..., _MU], M[..., _MU + 1], M[..., _MU + 2]),
            tuple(M[..., _T + c] for c in range(6)), M[..., _PD], M[..., _TH],
            (M[..., _POS], M[..., _POS + 1], M[..., _POS + 2]))


def _rows(nl: NeighborList):
    """The list's indices with the dead slots' N clamped to N - 1, as JAX's
    gathers clamp (every use masks them out)."""
    return nl.idx.clamp(max=nl.idx.shape[0] - 1)


def _upper(nl: NeighborList):
    """[N,K]: the slot's neighbour has the larger index (each unordered pair
    once)."""
    return nl.idx > torch.arange(nl.idx.shape[0], device=nl.idx.device)[:, None]


@dataclasses.dataclass
class AmoebaPeriodicSystem:
    """Device tables for the nonbonded AMOEBA energy of one system."""

    n_atoms: int
    cell: torch.Tensor        # [3], rounded like the other tables
    pme: MP.MultipoleEwaldParams
    cutoff: float
    sor_iters: int
    sor_omega: float
    q: torch.Tensor
    dip_loc: torch.Tensor
    quad_loc: torch.Tensor
    frame_z: torch.Tensor
    frame_x: torch.Tensor
    frame_kind: torch.Tensor
    alpha: torch.Tensor
    pdamp: torch.Tensor
    thole: torch.Tensor
    vdw_rmin: torch.Tensor
    vdw_eps: torch.Tensor
    vdw_red: torch.Tensor
    heavy_of: torch.Tensor
    # exception pair lists (i < j)
    mx_pairs: torch.Tensor    # [Mm,2] pairs with mscale != 1
    mx_weight: torch.Tensor   # mscale - 1, subtracted in the tables' precision (as JAX does)
    vx_pairs: torch.Tensor    # [Mv,2] pairs with vscale != 1
    vx_scale: torch.Tensor
    px_pairs: torch.Tensor    # [Mp,2] pairs with pscale != 1
    px_scale: torch.Tensor
    grp_pairs: torch.Tensor   # [Gp,2] intra-polarization-group pairs
    nl_grid: tuple | None = None

    @classmethod
    def build(cls, asg: AmoebaAssignment, cell, cutoff: float = 9.0, beta: float = 0.4,
              grid_spacing: float = 0.8, sor_iters: int = 30, sor_omega: float = 0.7,
              device=None, dtype=torch.float32, table_dtype=np.float32,
              ) -> "AmoebaPeriodicSystem":
        """``amoeba_system.py:117-164``.  The per-atom tables and the cell are
        rounded through ``table_dtype`` and then held in ``dtype``: float32
        tables are what JAX's QM/MM backend builds (its default
        ``dtype=float32``), also under x64; the mesh's cell and influence
        function stay unrounded, as JAX keeps them.  ``device`` None means
        the card (raises without one)."""
        device = resolve_device(device)
        cell = np.asarray(cell, np.float64)
        pme = MP.MultipoleEwaldParams.build(cell, beta=beta, grid_spacing=grid_spacing,
                                            device=device, dtype=dtype)
        f = lambda a: torch.as_tensor(np.asarray(a, table_dtype), dtype=dtype, device=device)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)

        def exceptions(table):
            s = np.array([table[int(o)] for o in asg.scale_order])
            sel = s != 1.0
            return i(np.asarray(asg.scale_pairs).reshape(-1, 2)[sel]), s[sel].astype(table_dtype)

        mx_p, mx_s = exceptions(MPOLE_SCALES)
        vx_p, vx_s = exceptions(VDW_SCALES)
        px_p, px_s = exceptions(POLAR_SCALES)
        return cls(
            n_atoms=asg.n_atoms, cell=f(cell), pme=pme, cutoff=cutoff, sor_iters=sor_iters,
            sor_omega=sor_omega, q=f(asg.q), dip_loc=f(asg.dip_loc), quad_loc=f(asg.quad_loc),
            frame_z=i(asg.frame_z), frame_x=i(asg.frame_x), frame_kind=i(asg.frame_kind),
            alpha=f(asg.alpha), pdamp=f(asg.alpha ** (1.0 / 6.0)), thole=f(asg.thole),
            vdw_rmin=f(asg.vdw_rmin), vdw_eps=f(asg.vdw_eps), vdw_red=f(asg.vdw_red),
            heavy_of=i(asg.heavy_of), mx_pairs=mx_p, mx_weight=f(mx_s - table_dtype(1.0)),
            vx_pairs=vx_p, vx_scale=f(vx_s), px_pairs=px_p, px_scale=f(px_s),
            grp_pairs=i(np.asarray(asg.group_pairs).reshape(-1, 2)),
            nl_grid=cell_grid(cell, cutoff, asg.n_atoms),
        )

    def neighbor_list(self, P, k_max: int | None = None) -> NeighborList:
        """The [N, K] list within the cutoff (``amoeba_system.py:166-180``);
        K defaults to ~1.3x liquid-water density at the cutoff.  The cell
        build wherever the box holds 3 cells an axis, else the tiled dense
        build (the same pair set)."""
        if k_max is None:
            k_max = int(np.ceil(0.13 * 4.19 * self.cutoff ** 3 / 64.0)) * 64
        if self.nl_grid is not None:
            nc, max_occ = self.nl_grid
            return build_neighbor_list_cells(P, self.cutoff, k_max, self.cell, nc, max_occ)
        return build_neighbor_list(P, self.cutoff, k_max, cell=self.cell)

    # ------------------------------------------------------------------
    def lab_multipoles(self, P):
        mu, theta = rotate_multipoles(P, self.frame_z, self.frame_x, self.frame_kind,
                                      self.dip_loc, self.quad_loc)
        return self.q, mu, theta

    def _packed(self, P):
        """(one [N,15] matrix of q, mu, theta6, pdamp, thole, positions; q,
        mu, theta)."""
        q, mu, theta = self.lab_multipoles(P)
        t6 = torch.stack([theta[:, a, b] for a, b in _T6], dim=-1)
        pm = torch.cat([q[:, None], mu, t6, self.pdamp[:, None], self.thole[:, None], P], dim=-1)
        return pm, q, mu, theta

    def _pair_geom(self, pm, nl: NeighborList):
        """Packed j-side rows, displacements r_j - r_i and liveness, [N,K];
        dead slots parked at a finite displacement (10, 0, 0)."""
        Mj = gather_rows(pm, _rows(nl))
        qj, mj3, tj6, pdj, thj, (pjx, pjy, pjz) = _slices(Mj)
        d = [_minimum_image(pj - pm[:, None, _POS + a], self.cell[a])
             for a, pj in enumerate((pjx, pjy, pjz))]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        live = nl.valid & (r2 < self.cutoff * self.cutoff)
        dx, dy, dz = _where(live, d[0], 10.0), _where(live, d[1], 0.0), _where(live, d[2], 0.0)
        return (qj, mj3, tj6, pdj, thj), (dx, dy, dz), _where(live, r2, 100.0), live

    def _pair_rows(self, pm, pairs, sign: float = 1.0):
        """(i rows, j rows, sign x (r_j - r_i) minimum image) of an explicit
        pair list."""
        Mi, Mj = pm[pairs[:, 0]], pm[pairs[:, 1]]
        d = tuple(sign * _minimum_image(Mj[:, _POS + a] - Mi[:, _POS + a], self.cell[a])
                  for a in range(3))
        return Mi, Mj, d

    def permanent_energy(self, P, nl: NeighborList):
        """Permanent multipole electrostatics, eV (``amoeba_system.py:
        240-259``)."""
        pm, q, mu, theta = self._packed(P)
        (qj, mj3, tj6, _, _), (dx, dy, dz), r2, live = self._pair_geom(pm, nl)
        live = live & _upper(nl)
        r2s = _where(live, r2, 1.0)
        qi, mi3, ti6, _, _, _ = _slices(pm[:, None, :])
        e = MP.multipole_pair_energy_soa(dx, dy, dz, qi, qj, mi3, mj3, ti6, tj6,
                                         MP.bn_chain_erfc(r2s, self.pme.beta))
        e_real = _where(live, e, 0.0).sum()
        e_rec = MP.reciprocal_energy(self.pme, P, q, mu, theta)
        e_self = MP.self_energy(q, mu, theta, self.pme.beta)
        e_corr = (self.mx_weight * self._exception_pair_energy(pm, self.mx_pairs)).sum()
        return units.COULOMB * (e_real + e_rec + e_self + e_corr)

    def _exception_pair_energy(self, pm, pairs):
        Mi, Mj, (dx, dy, dz) = self._pair_rows(pm, pairs)
        qi, mi3, ti6, _, _, _ = _slices(Mi)
        qj, mj3, tj6, _, _, _ = _slices(Mj)
        return MP.multipole_pair_energy_soa(dx, dy, dz, qi, qj, mi3, mj3, ti6, tj6,
                                            MP.bn_chain_coulomb(dx * dx + dy * dy + dz * dz))

    # ------------------------------------------------------------------
    # real-space SOR induction (induction="sor")
    # ------------------------------------------------------------------
    def _fields(self, pm, nl: NeighborList):
        """(E_d [N,3], E_p [N,3], SOR geometry): the Thole-damped real-space
        fields of the permanents, d-masked and p-scaled
        (``amoeba_system.py:275-323``)."""
        (qj, mj3, tj6, pdj, thj), (dx, dy, dz), r2, live = self._pair_geom(pm, nl)
        fx, fy, fz = -dx, -dy, -dz                   # field point convention r_i - r_j
        r = torch.sqrt(_where(live, r2, 100.0))
        l3, l5, l7 = _thole_lambdas(r, pm[:, None, _PD] * pdj,
                                    torch.minimum(pm[:, None, _TH], thj))
        ex, ey, ez = MP.field_soa(fx, fy, fz, qj, mj3, tj6, l3, l5, l7)
        E_full = torch.stack([_where(live, e, 0.0).sum(1) for e in (ex, ey, ez)], dim=-1)

        def corrections(pairs, weight):
            Mi, Mj, (cx, cy, cz) = self._pair_rows(pm, pairs, sign=-1.0)     # r_i - r_j
            qi, mi3, ti6, pdi, thi, _ = _slices(Mi)
            qj_, mj3_, tj6_, pdj_, thj_, _ = _slices(Mj)
            cl3, cl5, cl7 = _thole_lambdas(torch.sqrt(cx * cx + cy * cy + cz * cz), pdi * pdj_,
                                           torch.minimum(thi, thj_))
            f_i = torch.stack(MP.field_soa(cx, cy, cz, qj_, mj3_, tj6_, cl3, cl5, cl7), -1)
            f_j = torch.stack(MP.field_soa(-cx, -cy, -cz, qi, mi3, ti6, cl3, cl5, cl7), -1)
            src = torch.cat([weight[:, None] * f_i, weight[:, None] * f_j])
            dst = torch.cat([pairs[:, 0], pairs[:, 1]])
            return torch.zeros_like(E_full).index_add(0, dst, src)

        E_d = E_full - corrections(self.grp_pairs, torch.ones(self.grp_pairs.shape[0],
                                                              dtype=pm.dtype, device=pm.device))
        E_p = E_full - corrections(self.px_pairs, 1.0 - self.px_scale)
        return E_d, E_p, (fx, fy, fz), live, l3, l5

    def induced_dipoles(self, P, nl: NeighborList):
        """Mutual induction by ``sor_iters`` SOR sweeps over the list
        (``amoeba_system.py:325-347``); returns (mu_ind, E_p)."""
        pm, *_ = self._packed(P)
        E_d, E_p, (dx, dy, dz), live, l3, l5 = self._fields(pm, nl)
        alpha = self.alpha[:, None]
        idx = _rows(nl)
        mu_ind = alpha * E_d
        for _ in range(self.sor_iters):
            Mj = gather_rows(mu_ind, idx)
            f = MP.dipole_field_soa(dx, dy, dz, (Mj[..., 0], Mj[..., 1], Mj[..., 2]), l3, l5)
            Em = torch.stack([_where(live, c, 0.0).sum(1) for c in f], dim=-1)
            mu_ind = mu_ind + self.sor_omega * (alpha * (E_d + Em) - mu_ind)
        return mu_ind, E_p

    def polarization_energy(self, P, nl: NeighborList):
        mu_ind, E_p = self.induced_dipoles(P, nl)
        return -0.5 * units.COULOMB * (mu_ind * E_p).sum()

    # ------------------------------------------------------------------
    # full-Ewald variational induction (``amoeba_system.py:353-785``)
    # ------------------------------------------------------------------
    def _induction_functional(self, P, nl: NeighborList):
        """(F, alpha, pcorr): the quadratic induction functional F(m) in
        e^2/A (1/2 m.m/alpha, the erfc cross and mutual pair terms with
        Thole damping folded in as B_n,erfc - (1 - lambda_n) B_n,coulomb,
        the group d-mask, the mesh and self terms), and the p-vs-d
        energy-field correction pcorr(m) (``amoeba_system.py:374-495``)."""
        pm, q, mu_perm, theta = self._packed(P)
        (qj, mj3, tj6, pdj, thj), (dx, dy, dz), r2, live = self._pair_geom(pm, nl)
        live_u = live & _upper(nl)
        r2s = _where(live_u, r2, 1.0)
        l3, l5, l7 = _thole_lambdas(torch.sqrt(r2s), pm[:, None, _PD] * pdj,
                                    torch.minimum(pm[:, None, _TH], thj))
        lam = (1.0, l3, l5, l7, 1.0)
        bn_eff = [be - (1.0 - ln) * bc for be, bc, ln in
                  zip(MP.bn_chain_erfc(r2s, self.pme.beta), MP.bn_chain_coulomb(r2s), lam)]
        zq = torch.zeros_like(qj)
        zero6 = (zq,) * 6
        qi = pm[:, None, _Q]
        idx = _rows(nl)
        mi3 = tuple(pm[:, None, _MU + a] for a in range(3))
        ti6 = tuple(pm[:, None, _T + c] for c in range(6))

        def e_real(m):
            mi = tuple(m[:, None, a] for a in range(3))
            Mj = gather_rows(m, idx)
            mj = (Mj[..., 0], Mj[..., 1], Mj[..., 2])
            e_c = (MP.multipole_pair_energy_soa(dx, dy, dz, zq, qj, mi, mj3, zero6, tj6, bn_eff)
                   + MP.multipole_pair_energy_soa(dx, dy, dz, qi, zq, mi3, mj, ti6, zero6,
                                                  bn_eff))
            e_m = MP.multipole_pair_energy_soa(dx, dy, dz, zq, zq, mi, mj, zero6, zero6, bn_eff)
            return _where(live_u, e_c + e_m, 0.0).sum()

        def damped_cross(pairs):
            """m -> per-pair cross energy: m_i with the permanents at j and
            m_j with those at i, Thole-damped Coulomb kernel."""
            Mi, Mj, (gx, gy, gz) = self._pair_rows(pm, pairs)
            gqi, gmi3, gti6, gpdi, gthi, _ = _slices(Mi)
            gqj, gmj3, gtj6, gpdj, gthj, _ = _slices(Mj)
            gr2 = gx * gx + gy * gy + gz * gz
            gl3, gl5, gl7 = _thole_lambdas(torch.sqrt(gr2), gpdi * gpdj, torch.minimum(gthi, gthj))
            g_bn = [bc * ln for bc, ln in zip(MP.bn_chain_coulomb(gr2), (1.0, gl3, gl5, gl7, 1.0))]
            gz6 = (torch.zeros_like(gx),) * 6
            gzq = gz6[0]
            pi, pj = pairs[:, 0], pairs[:, 1]

            def cross(m):
                mi = (m[pi, 0], m[pi, 1], m[pi, 2])
                mj = (m[pj, 0], m[pj, 1], m[pj, 2])
                return (MP.multipole_pair_energy_soa(gx, gy, gz, gzq, gqj, mi, gmj3, gz6, gtj6,
                                                     g_bn)
                        + MP.multipole_pair_energy_soa(gx, gy, gz, gqi, gzq, gmi3, mj, gti6, gz6,
                                                       g_bn))
            return cross

        cross_grp = damped_cross(self.grp_pairs)
        cross_px = damped_cross(self.px_pairs)

        def pcorr(m):
            return 0.5 * cross_grp(m).sum() - 0.5 * ((1.0 - self.px_scale) * cross_px(m)).sum()

        def e_recip_self(m):
            mu_tot = mu_perm + m
            return ((MP.reciprocal_energy(self.pme, P, q, mu_tot, theta)
                     - MP.reciprocal_energy(self.pme, P, q, mu_perm, theta))
                    + MP.self_energy(q, mu_tot, theta, self.pme.beta)
                    - MP.self_energy(q, mu_perm, theta, self.pme.beta))

        alpha = torch.clamp(self.alpha, min=1e-6)

        def F(m):
            return ((m * m / (2.0 * alpha[:, None])).sum() + e_real(m) - cross_grp(m).sum()
                    + e_recip_self(m))

        return F, alpha, pcorr

    def _mutual_operator(self, P, nl: NeighborList):
        """The Hessian of the induction functional applied to dipoles p
        [N,3,R] (``amoeba_system.py:497-578``, its batched form included):
        p / alpha + sum_j [B1_eff p_j - B2_eff (p_j.x) x] over the list +
        the mesh's dipole gradient - B_1(0) p (the self term).  Explicit
        tensor algebra, no autograd Hessian-vector product."""
        G = torch.cat([self.pdamp[:, None], self.thole[:, None], P], dim=-1)
        Gj = gather_rows(G, _rows(nl))                                              # [N,K,5]
        d = [_minimum_image(Gj[..., 2 + a] - P[:, None, a], self.cell[a]) for a in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        live = nl.valid & (r2 < self.cutoff * self.cutoff)
        dx, dy, dz = _where(live, d[0], 10.0), _where(live, d[1], 0.0), _where(live, d[2], 0.0)
        r2s = _where(live, r2, 100.0)
        l3, l5, _ = _thole_lambdas(torch.sqrt(r2s), self.pdamp[:, None] * Gj[..., 0],
                                   torch.minimum(self.thole[:, None], Gj[..., 1]))
        be = MP.bn_chain_erfc(r2s, self.pme.beta, n=3)
        bc = MP.bn_chain_coulomb(r2s, n=3)
        b1 = _where(live, be[1] - (1.0 - l3) * bc[1], 0.0)[..., None]     # [N,K,1]
        b2 = _where(live, be[2] - (1.0 - l5) * bc[2], 0.0)[..., None]
        dx, dy, dz = dx[..., None], dy[..., None], dz[..., None]
        inv_alpha = (1.0 / torch.clamp(self.alpha, min=1e-6))[:, None, None]
        b1_self = 4.0 * self.pme.beta ** 3 / (3.0 * MP.SQRT_PI)
        st = MP._stencils(self.pme, P)
        idx = _rows(nl)

        def apply(p):
            Pj = gather_rows(p, idx)                                # [N,K,3,R]
            pjx, pjy, pjz = Pj[:, :, 0], Pj[:, :, 1], Pj[:, :, 2]
            b2pr = b2 * (pjx * dx + pjy * dy + pjz * dz)
            T = torch.stack([(b1 * pjx - b2pr * dx).sum(1), (b1 * pjy - b2pr * dy).sum(1),
                             (b1 * pjz - b2pr * dz).sum(1)], dim=1)
            return (p * inv_alpha + T + MP.reciprocal_dipole_gradient(self.pme, P, p, st)
                    - b1_self * p)

        return apply

    def induced_dipoles_ewald(self, P, nl: NeighborList, cg_iters: int = 12, m0=None):
        """Fixed-iteration Jacobi-PCG minimization of the induction
        functional with gradients through the iterations; (mu_ind [N,3],
        E_pol in e^2/A with the p-vs-d correction) (``amoeba_system.py:
        580-636``).  The right-hand side -E_d = -grad F(0) keeps its graph
        in P, so the position gradient is JAX's at any iteration count, not
        only at convergence.  The iterations are stored, not recomputed
        (JAX rematerializes them, ``jax.checkpoint``)."""
        F, alpha, pcorr = self._induction_functional(P, nl)
        g0 = _grad_at_zero(F, P, create_graph=P.requires_grad)
        A = self._mutual_operator(P, nl)
        hvp = lambda v: A(v[..., None])[..., 0]
        m = torch.zeros_like(P) if m0 is None else m0.detach().to(P.dtype)
        prec = alpha[:, None]
        r_ = -g0 - hvp(m)
        z_ = prec * r_
        p_ = z_
        for _ in range(cg_iters):
            m, r_, z_, p_ = _pcg_step(hvp, prec, m, r_, z_, p_, dims=(0, 1))
        return m, F(m) + pcorr(m)

    def induction_variational(self, P, nl: NeighborList, cg_iters: int = 12, m0_d=None,
                              m0_p=None):
        """Variational induction (``amoeba_system.py:638-737``): both Tinker
        fields solved with the same operator as one two-column PCG under
        ``torch.no_grad`` from the warm starts, then the fixed-dipole scalar

          Phi = 1/2 mu_d.g0 + pcorr(mu_d) + 1/2 mu_p.(g0 + A(mu_d))

        (g0 = grad F(0) = -E_d), which equals -1/2 mu_d.E_p in value and in
        its position derivative.  Returns (mu_d, mu_p, Phi in e^2/A)."""
        with torch.no_grad():
            Pd = P.detach()
            F, alpha, pcorr = self._induction_functional(Pd, nl)
            g0 = _grad_at_zero(F, Pd)
            gp = _grad_at_zero(pcorr, Pd)
            B = torch.stack([-g0, -g0 - 2.0 * gp], dim=-1)          # E_d, E_p
            warm = lambda m0: torch.zeros_like(Pd) if m0 is None else m0.detach().to(P.dtype)
            X = torch.stack([warm(m0_d), warm(m0_p)], dim=-1)
            A = self._mutual_operator(Pd, nl)
            prec = alpha[:, None, None]
            R = B - A(X)
            Z = prec * R
            Pk = Z
            for _ in range(cg_iters):
                X, R, Z, Pk = _pcg_step(A, prec, X, R, Z, Pk, dims=(0, 1))
            m_d, m_p = X[..., 0], X[..., 1]
            del F, pcorr, A
        if not P.requires_grad:
            return m_d, m_p, self._phi(P, nl, m_d, m_p)
        phi = torch.utils.checkpoint.checkpoint(self._phi, P, nl, m_d, m_p,
                                                use_reentrant=False, preserve_rng_state=False)
        return m_d, m_p, phi

    def _phi(self, P, nl: NeighborList, m_d, m_p):
        F, _, pcorr = self._induction_functional(P, nl)
        g0 = _grad_at_zero(F, P, create_graph=P.requires_grad)
        A = self._mutual_operator(P, nl)
        return (0.5 * (m_d * g0).sum() + pcorr(m_d)
                + 0.5 * (m_p * (g0 + A(m_d[..., None])[..., 0])).sum())

    def energy_ewald_variational(self, P, nl: NeighborList, m0_d, m0_p, cg_iters: int = 12):
        """(E in eV, (mu_d, mu_p)) with the variational induction, the QM/MM
        backend's energy (``amoeba_system.py:739-752``); the dipoles are
        detached, to warm-start the next step."""
        m_d, m_p, phi = self.induction_variational(P, nl, cg_iters, m0_d=m0_d, m0_p=m0_p)
        e = self.permanent_energy(P, nl) + units.COULOMB * phi + self.vdw_energy(P, nl)
        return e, (m_d.detach(), m_p.detach())

    def polarization_energy_ewald(self, P, nl: NeighborList, cg_iters: int = 12, m0=None):
        """The full-Ewald polarization energy in eV, F(m) + pcorr(m) after
        ``cg_iters`` PCG iterations from ``m0``, its gradient through the
        iterations (``amoeba_system.py:754-764``): AMOEBA's -1/2 m.E_p at
        convergence, the p-vs-d correction zero for water."""
        return units.COULOMB * self.induced_dipoles_ewald(P, nl, cg_iters, m0=m0)[1]

    def energy_ewald_induction(self, P, nl: NeighborList, cg_iters: int = 12, m0=None):
        """Permanent + unrolled-solve polarization + vdW, eV
        (``amoeba_system.py:766-772``): the pure-AMOEBA MD energy."""
        return (self.permanent_energy(P, nl)
                + self.polarization_energy_ewald(P, nl, cg_iters, m0=m0)
                + self.vdw_energy(P, nl))

    def energy_ewald_induction_warm(self, P, nl: NeighborList, m0, cg_iters: int = 12):
        """(E in eV, the detached dipoles): ``energy_ewald_induction(...,
        m0=m0)`` and the dipoles to warm-start the next call with
        (``amoeba_system.py:774-786``)."""
        m, fmin = self.induced_dipoles_ewald(P, nl, cg_iters, m0=m0)
        e = self.permanent_energy(P, nl) + units.COULOMB * fmin + self.vdw_energy(P, nl)
        return e, m.detach()

    # ------------------------------------------------------------------
    def _vdw_pair(self, r, rm_i, rm_j, ep_i, ep_j):
        r0 = (rm_i ** 3 + rm_j ** 3) / torch.clamp(rm_i ** 2 + rm_j ** 2, min=1e-12)
        se = torch.sqrt(ep_i) + torch.sqrt(ep_j)
        eps = 4.0 * ep_i * ep_j / torch.clamp(se * se, min=1e-12)
        r0 = torch.clamp(r0, min=1e-12)
        rho = r / r0
        e = eps * (1.07 / (rho + 0.07)) ** 7 * (1.12 / (rho ** 7 + 0.12) - 2.0)
        rho_c = self.cutoff / r0
        return e - eps * (1.07 / (rho_c + 0.07)) ** 7 * (1.12 / (rho_c ** 7 + 0.12) - 2.0)

    def _vdw_packed(self, P):
        """[N,5]: the reduced sites (H moved toward its heavy atom), rmin,
        eps."""
        red = self.vdw_red[:, None]
        sites = P[self.heavy_of] + red * (P - P[self.heavy_of])
        return torch.cat([sites, self.vdw_rmin[:, None], self.vdw_eps[:, None]], dim=-1)

    def vdw_energy(self, P, nl: NeighborList):
        """Buffered 14-7 over the list plus the scaled pairs' corrections, eV
        (``amoeba_system.py:815-847``)."""
        vm = self._vdw_packed(P)
        Vj = gather_rows(vm, _rows(nl))
        d = [_minimum_image(Vj[..., a] - vm[:, None, a], self.cell[a]) for a in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        live = nl.valid & _upper(nl) & (r2 < self.cutoff * self.cutoff)
        r = torch.sqrt(_where(live, r2, 1.0))
        e = _where(live, self._vdw_pair(r, vm[:, None, 3], Vj[..., 3], vm[:, None, 4],
                                        Vj[..., 4]), 0.0).sum()
        Vi, Vx = vm[self.vx_pairs[:, 0]], vm[self.vx_pairs[:, 1]]
        c = [_minimum_image(Vx[:, a] - Vi[:, a], self.cell[a]) for a in range(3)]
        rx = torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
        e_x = _where(rx < self.cutoff, self._vdw_pair(rx, Vi[:, 3], Vx[:, 3], Vi[:, 4],
                                                      Vx[:, 4]), 0.0)
        return e + ((self.vx_scale - 1.0) * e_x).sum()

    # ------------------------------------------------------------------
    def energy(self, P, nl: NeighborList):
        """Permanent + SOR polarization + vdW, eV (``amoeba_system.py:
        850-855``)."""
        return self.permanent_energy(P, nl) + self.polarization_energy(P, nl) + self.vdw_energy(
            P, nl)

    def energy_forces(self, P, nl: NeighborList):
        with torch.enable_grad():
            p = P.detach().requires_grad_(True)
            e = self.energy(p, nl)
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g


def _grad_at_zero(fn, P, create_graph: bool = False):
    """grad of fn(m) in m at m = 0 ([N,3]); ``create_graph`` keeps it
    differentiable in P."""
    with torch.enable_grad():
        m = torch.zeros_like(P, requires_grad=True)
        (g,) = torch.autograd.grad(fn(m), m, create_graph=create_graph)
    return g


def _pcg_step(A, prec, m, r_, z_, p_, dims):
    """One Jacobi-preconditioned CG iteration with per-column scalars
    (``amoeba_system.py:684-698``); a vanishing denominator stops the
    column where it is."""
    Ap = A(p_)
    denom = (p_ * Ap).sum(dims)
    rz = (r_ * z_).sum(dims)
    zero = torch.zeros_like(rz)
    a = torch.where(denom.abs() > 1e-30, rz / torch.where(denom.abs() > 1e-30, denom,
                                                          torch.ones_like(denom)), zero)
    m_new = m + a * p_
    r_new = r_ - a * Ap
    z_new = prec * r_new
    b = torch.where(rz.abs() > 1e-30, (r_new * z_new).sum(dims)
                    / torch.where(rz.abs() > 1e-30, rz, torch.ones_like(rz)), zero)
    return m_new, r_new, z_new, z_new + b * p_
