"""Rigid 3-point water: analytic SETTLE constraints on tensors.

Port of ``ai2bmd_tpu/md/settle.py``: the Miyamoto-Kollman SETTLE algorithm
(J Comput Chem 13:952, 1992), the closed-form solution of a rigid
triatomic's three holonomic constraints, over all waters at once; velocities
get the exact RATTLE projection (a 3 x 3 linear system a water for the
bond-direction impulses, solved here by Cramer's rule, which needs no host
sync inside a captured step).  ``shake_reference`` is the iterative SHAKE
oracle the tests hold SETTLE against.

Geometry defaults are TIP3P: r(OH) = 0.9572 A, theta(HOH) = 104.52 deg.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ai2bmd_torch.utils.device import resolve_device


@dataclasses.dataclass
class SettleConstraint:
    """Constraint tables for W rigid waters inside an N-atom system."""

    o_idx: torch.Tensor   # [W] int64
    h1_idx: torch.Tensor  # [W]
    h2_idx: torch.Tensor  # [W]
    m_o: float            # amu
    m_h: float
    ra: float             # canonical geometry: O at (0, ra, 0)
    rb: float             # H at (-+rc, -rb, 0)
    rc: float
    d_oh: float           # constraint distances
    d_hh: float

    @classmethod
    def build(cls, o_idx, h1_idx, h2_idx, m_o: float = 15.9994, m_h: float = 1.008,
              r_oh: float = 0.9572, theta_deg: float = 104.52, device=None) -> "SettleConstraint":
        """``device`` None means the card (raises without one)."""
        device = resolve_device(device)
        th = math.radians(theta_deg)
        rc = r_oh * math.sin(th / 2.0)           # half the H-H distance
        t = r_oh * math.cos(th / 2.0)            # O to the H-H line
        ra = 2.0 * m_h * t / (m_o + 2.0 * m_h)   # centre of mass to O
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        return cls(o_idx=i(o_idx), h1_idx=i(h1_idx), h2_idx=i(h2_idx), m_o=m_o, m_h=m_h,
                   ra=ra, rb=t - ra, rc=rc, d_oh=r_oh, d_hh=2.0 * rc)

    @classmethod
    def from_topology(cls, top, device=None) -> "SettleConstraint | None":
        """The waters of a SystemTopology (each O with its two bonded H), or
        None when it has none; ``device`` None means the card (raises
        without one)."""
        device = resolve_device(device)
        if len(top.water_oxygens) == 0:
            return None
        oset = set(int(o) for o in top.water_oxygens)
        h_of: dict[int, list[int]] = {o: [] for o in oset}
        for i, j in top.bonds:
            i, j = int(i), int(j)
            if i in oset and j not in oset:
                h_of[i].append(j)
            elif j in oset and i not in oset:
                h_of[j].append(i)
        o_idx, h1, h2 = [], [], []
        for o in sorted(oset):
            hs = sorted(h_of[o])
            if len(hs) != 2:
                continue
            o_idx.append(o)
            h1.append(hs[0])
            h2.append(hs[1])
        if not o_idx:
            return None
        return cls.build(np.array(o_idx), np.array(h1), np.array(h2), device=device)

    def gather(self, X):
        return X[self.o_idx], X[self.h1_idx], X[self.h2_idx]

    def scatter(self, X, a, b, c):
        X = X.clone()
        X[self.o_idx] = a
        X[self.h1_idx] = b
        X[self.h2_idx] = c
        return X

    def positions(self, X_old: torch.Tensor, X_new: torch.Tensor) -> torch.Tensor:
        """SETTLE: each water's new positions projected onto the rigid
        geometry, given old positions that satisfy the constraints."""
        a3, b3, c3 = _settle_triads(*self.gather(X_old), *self.gather(X_new), self.m_o,
                                    self.m_h, self.ra, self.rb, self.rc)
        return self.scatter(X_new, a3, b3, c3)

    def velocities(self, X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """The exact RATTLE velocity projection: afterwards d/dt of every
        constraint is zero.  X must satisfy the position constraints."""
        a, b, c = self.gather(X)
        va, vb, vc = self.gather(V)
        e1, e2, e3 = _unit(b - a), _unit(c - a), _unit(c - b)   # O-H1, O-H2, H1-H2
        io, ih = 1.0 / self.m_o, 1.0 / self.m_h
        dot = lambda u, v: (u * v).sum(-1)
        d12, d13, d23 = dot(e1, e2), dot(e1, e3), dot(e2, e3)
        # impulses g1 (along e1, pair a-b), g2 (e2, a-c), g3 (e3, b-c) solve
        # the symmetric system A g = rhs
        A11 = A22 = (io + ih) * torch.ones_like(d12)
        A33 = 2.0 * ih * torch.ones_like(d12)
        A12, A13, A23 = io * d12, -ih * d13, ih * d23
        r1, r2, r3 = dot(e1, va - vb), dot(e2, va - vc), dot(e3, vb - vc)
        det = (A11 * (A22 * A33 - A23 * A23) - A12 * (A12 * A33 - A23 * A13)
               + A13 * (A12 * A23 - A22 * A13))
        g1 = (r1 * (A22 * A33 - A23 * A23) - A12 * (r2 * A33 - A23 * r3)
              + A13 * (r2 * A23 - A22 * r3)) / det
        g2 = (A11 * (r2 * A33 - A23 * r3) - r1 * (A12 * A33 - A23 * A13)
              + A13 * (A12 * r3 - r2 * A13)) / det
        g3 = (A11 * (A22 * r3 - r2 * A23) - A12 * (A12 * r3 - r2 * A13)
              + r1 * (A12 * A23 - A22 * A13)) / det
        g1, g2, g3 = g1[:, None], g2[:, None], g3[:, None]
        va = va - (g1 * e1 + g2 * e2) * io
        vb = vb - (-g1 * e1 + g3 * e3) * ih
        vc = vc - (-g2 * e2 - g3 * e3) * ih
        return self.scatter(V, va, vb, vc)

    def snap(self, X: torch.Tensor) -> torch.Tensor:
        """Project arbitrary water geometries onto the rigid constraints (a
        flexible-water input satisfies them only approximately), with the
        current positions as the orientation reference."""
        return self.positions(X, X)

    def max_violation(self, X: torch.Tensor) -> torch.Tensor:
        a, b, c = self.gather(X)
        return torch.stack([(_norm(b - a) - self.d_oh).abs(), (_norm(c - a) - self.d_oh).abs(),
                            (_norm(c - b) - self.d_hh).abs()]).max()


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _unit(v):
    return v / _norm(v)[..., None]


def _settle_triads(a0, b0, c0, a1, b1, c1, ma, mh, ra, rb, rc):
    """Miyamoto-Kollman closed form over [W,3] triads (``settle.py:188-255``)."""
    com = (ma * a1 + mh * (b1 + c1)) / (ma + 2.0 * mh)
    a1, b1, c1 = a1 - com, b1 - com, c1 - com
    b0a, c0a = b0 - a0, c0 - a0

    # orthonormal frame: z along the old plane normal, x perpendicular to (a1, z)
    cross = lambda u, v: torch.linalg.cross(u, v, dim=-1)
    n0 = cross(b0a, c0a)
    n1 = cross(a1, n0)
    n2 = cross(n0, n1)
    n0, n1, n2 = _unit(n0), _unit(n1), _unit(n2)

    def fr(v):   # lab -> frame (x, y, z)
        return (v * n1).sum(-1), (v * n2).sum(-1), (v * n0).sum(-1)

    xb0, yb0, _ = fr(b0a)
    xc0, yc0, _ = fr(c0a)
    _, _, za1 = fr(a1)
    xb1, yb1, zb1 = fr(b1)
    xc1, yc1, zc1 = fr(c1)

    sinphi = torch.clamp(za1 / ra, -1.0, 1.0)
    cosphi = torch.sqrt(1.0 - sinphi * sinphi)
    sinpsi = torch.clamp((zb1 - zc1) / (2.0 * rc * cosphi), -1.0, 1.0)
    cospsi = torch.sqrt(1.0 - sinpsi * sinpsi)

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    yb2 = -rb * cosphi - rc * sinpsi * sinphi
    yc2 = -rb * cosphi + rc * sinpsi * sinphi

    alpha = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2
    beta = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2
    gamma = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0

    a2b2 = alpha * alpha + beta * beta
    sintheta = (alpha * gamma
                - beta * torch.sqrt(torch.clamp(a2b2 - gamma * gamma, min=0.0))) / a2b2
    sintheta = torch.clamp(sintheta, -1.0, 1.0)
    costheta = torch.sqrt(1.0 - sintheta * sintheta)

    xa3, ya3, za3 = -ya2 * sintheta, ya2 * costheta, za1
    xb3 = xb2 * costheta - yb2 * sintheta
    yb3 = xb2 * sintheta + yb2 * costheta
    zb3 = -rb * sinphi + rc * sinpsi * cosphi
    xc3 = -xb2 * costheta - yc2 * sintheta
    yc3 = -xb2 * sintheta + yc2 * costheta
    zc3 = -rb * sinphi - rc * sinpsi * cosphi

    def lab(x, y, z):
        return x[..., None] * n1 + y[..., None] * n2 + z[..., None] * n0 + com

    return lab(xa3, ya3, za3), lab(xb3, yb3, zb3), lab(xc3, yc3, zc3)


def shake_reference(con: SettleConstraint, X_old, X_new, masses, n_iter: int = 200):
    """Iterative SHAKE on the water constraints, the test oracle for SETTLE
    (``settle.py:258-276``): both solve the same Lagrange system."""
    m = torch.as_tensor(np.asarray(masses), dtype=X_new.dtype, device=X_new.device)[:, None]
    pairs = [(con.o_idx, con.h1_idx, con.d_oh), (con.o_idx, con.h2_idx, con.d_oh),
             (con.h1_idx, con.h2_idx, con.d_hh)]
    ref = [X_old[i] - X_old[j] for i, j, _ in pairs]
    X = X_new.clone()
    for _ in range(n_iter):
        for (i, j, d), r0 in zip(pairs, ref):
            r = X[i] - X[j]
            diff = (r * r).sum(-1) - d * d
            g = diff / (2.0 * (r * r0).sum(-1) * (1.0 / m[i, 0] + 1.0 / m[j, 0]))
            X = X.index_add(0, i, -g[:, None] * r0 / m[i])
            X = X.index_add(0, j, g[:, None] * r0 / m[j])
    return X
