"""Per-step fragment pipeline in PyTorch.

Port of ``ai2bmd_tpu/frag/runtime.py:89-309``.  Per MD step:

  protein positions [N,3]
    -> dipeptide rows [R,S,3] with the cap hydrogens placed along the
       acceptor -> replaced-atom direction
    -> L-BFGS over the cap coordinates (frag.hydrogen), gradient stopped
    -> one ViSNet call per dipeptide size bucket (24 / 32 / S slots) and one
       for the ACE-NME batch at 16 slots
    -> E = sum(E_dip) - sum(E_ace), forces stitched with one ``index_add_``
       into [N+1, 3] (row N collects cap and padding forces and is dropped).

``index_add_`` on CUDA sums in no fixed order; the stitch is the one place
of the step where that is accepted.

``FragmentRuntime.build(row_multiple=)`` pads the row axes with empty rows
and dummy ACE-NME units (``_pad_rows``) for the fragment-sharded potential
(``parallel.sharding.ShardedPotential``).

Replica ensembles (:312-405): with positions [Rl,N,3] the caps are
optimized per replica, and each ViSNet call takes every replica's rows of
its bucket as one batch; ``ensemble_fragment_energy_forces_warm`` runs the
replicas in chunks so that one chunk's activations are alive at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.frag import hydrogen as HY
from ai2bmd_torch.host import ACENME_LEN, ACENME_Z, FragmentIndex, build_type_topology
from ai2bmd_torch.models import visnet as V
from ai2bmd_torch.utils.device import resolve_device

# Dipeptide size-bucket widths; the row slot count S is always appended.
# The edge kernels need multiples of 8 as well (``ops/vismp.check_shapes``:
# their rows go in chunks of 8), as the reference's TPU tiles did.
BUCKET_WIDTHS = (24, 32)
S_ACE = 16
# the FragmentIndex arrays with one entry per dipeptide row
ROW_ARRAYS = ("row_natom", "row_z", "valid", "is_cap", "gather_idx", "cap_dir_idx",
              "cap_radius")


@dataclasses.dataclass
class Bucket:
    width: int
    rows: torch.Tensor       # [r] row indices
    z: torch.Tensor          # [r, w]
    valid: torch.Tensor      # [r, w] bool
    dst: torch.Tensor        # [r, w] stitch target (n_atoms = dropped)
    has_atoms: torch.Tensor  # [r] float


@dataclasses.dataclass
class FragmentRuntime:
    """Static per-system tensors derived from a FragmentIndex."""

    n_atoms: int
    opt_iters: int
    gather_idx: torch.Tensor   # [R,S]
    cap_dir_idx: torch.Tensor  # [R,S]
    cap_radius: torch.Tensor   # [R,S,1]
    is_cap: torch.Tensor       # [R,S] bool
    valid: torch.Tensor        # [R,S] bool
    pad_pos: torch.Tensor      # [R,S,3] parking positions of padding slots
    ace_rows: torch.Tensor     # [C,12]
    ace_slots: torch.Tensor    # [C,12]
    ace_valid: torch.Tensor    # [C] float
    ace_z16: torch.Tensor      # [C,16]
    ace_mask16: torch.Tensor   # [C,16] bool
    ace_dst16: torch.Tensor    # [C,16]
    ace_park: torch.Tensor     # [C,16,3]
    ht: HY.HydrogenTables
    dip_buckets: list[Bucket]

    @classmethod
    def build(cls, fi: FragmentIndex, opt_iters: int = 10, device=None,
              dtype=torch.float32, row_multiple: int = 1) -> "FragmentRuntime":
        """``device`` None means the card (raises without one).
        ``row_multiple`` pads the dipeptide-row and ACE-NME axes to a multiple
        of it (``_pad_rows``), so that they split evenly over a mesh's "mp"
        axis (``parallel.sharding``)."""
        device = resolve_device(device)
        fi = _pad_rows(fi, row_multiple)
        R, S = fi.n_rows, fi.slots
        top = build_type_topology(sorted({t for t in fi.row_prmtop if t}))
        ht = HY.HydrogenTables.build(
            top, [t if t else top.names[0] for t in fi.row_prmtop], fi.is_cap, device, dtype)
        ht.free = ht.free * torch.as_tensor(fi.row_natom > 0, dtype=dtype,
                                            device=device)[:, None, None]
        # park padding slots far away and far apart
        r_idx, s_idx = np.meshgrid(np.arange(R), np.arange(S), indexing="ij")
        pad_pos = np.stack([1e4 + 200.0 * r_idx, 1e4 + 200.0 * s_idx,
                            np.zeros_like(r_idx, dtype=float)], axis=-1)

        real = fi.valid & ~fi.is_cap
        dip_dst = np.where(real, fi.gather_idx, fi.n_atoms)
        C = len(fi.ace_rows)
        ace_valid = np.arange(C) < fi.n_acenmes
        ace_dst = np.where((~fi.ace_is_cap) & ace_valid[:, None], fi.ace_origin, fi.n_atoms)

        # the 12-atom ACE-NME units pad to 16 slots, not to the dipeptide width
        ace_z16 = np.zeros((C, S_ACE), np.int64)
        ace_z16[:, :ACENME_LEN] = np.where(ace_valid[:, None], ACENME_Z[None, :], 0)
        ace_mask16 = np.zeros((C, S_ACE), bool)
        ace_mask16[:, :ACENME_LEN] = ace_valid[:, None]
        ace_dst16 = np.full((C, S_ACE), fi.n_atoms, np.int64)
        ace_dst16[:, :ACENME_LEN] = ace_dst
        c_idx, s_idx = np.meshgrid(np.arange(C), np.arange(S_ACE), indexing="ij")
        ace_park = np.stack([3e4 + 200.0 * c_idx, 3e4 + 200.0 * s_idx,
                             np.zeros_like(c_idx, float)], axis=-1)

        long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
        flt = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        boolean = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.bool, device=device)

        # dipeptide rows bucketed by atom count (empty rows excluded); rows are
        # prefix-valid, so cutting a row to its bucket width drops only padding
        widths = [w for w in BUCKET_WIDTHS if w < S] + [S]
        buckets, lo = [], 0
        for w in widths:
            sel = np.where((fi.row_natom > lo) & (fi.row_natom <= w))[0]
            lo = w
            if len(sel):
                buckets.append(Bucket(
                    width=int(w), rows=long(sel), z=long(fi.row_z[sel, :w]),
                    valid=boolean(fi.valid[sel, :w]), dst=long(dip_dst[sel, :w]),
                    has_atoms=flt(fi.row_natom[sel] > 0),
                ))

        return cls(
            n_atoms=fi.n_atoms, opt_iters=opt_iters,
            gather_idx=long(fi.gather_idx), cap_dir_idx=long(fi.cap_dir_idx),
            cap_radius=flt(fi.cap_radius[..., None]), is_cap=boolean(fi.is_cap),
            valid=boolean(fi.valid), pad_pos=flt(pad_pos),
            ace_rows=long(fi.ace_rows), ace_slots=long(fi.ace_slots),
            ace_valid=flt(ace_valid), ace_z16=long(ace_z16), ace_mask16=boolean(ace_mask16),
            ace_dst16=long(ace_dst16), ace_park=flt(ace_park), ht=ht, dip_buckets=buckets,
        )


def _pad_rows(fi: FragmentIndex, multiple: int) -> FragmentIndex:
    """Pad the row and ACE-NME axes to a multiple of ``multiple`` with empty
    rows (natom 0, every slot invalid) and dummy units (``frag/runtime.py:
    182-216``).  ``n_dipeptides`` and ``n_acenmes`` keep their true values:
    the padded units point at row 0 and are masked by ``ace_valid`` (index <
    ``n_acenmes``); the empty rows fall in no size bucket."""
    if multiple <= 1:
        return fi
    R, C = fi.n_rows, len(fi.ace_rows)
    Rp, Cp = -(-R // multiple) * multiple, -(-C // multiple) * multiple
    if Rp == R and Cp == C:
        return fi

    def pad(a, n):
        return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    return dataclasses.replace(
        fi, n_rows=Rp,
        row_type=fi.row_type + [""] * (Rp - R), row_prmtop=fi.row_prmtop + [""] * (Rp - R),
        **{k: pad(getattr(fi, k), Rp) for k in ROW_ARRAYS},
        ace_rows=pad(fi.ace_rows, Cp), ace_slots=pad(fi.ace_slots, Cp))


def build_row_positions(rt: FragmentRuntime, P: torch.Tensor) -> torch.Tensor:
    """Protein positions [..., N,3] -> dipeptide rows [..., R,S,3] with placed
    caps."""
    base = P[..., rt.gather_idx, :]
    unit = HY._safe_unit(P[..., rt.cap_dir_idx, :] - base)
    pos = torch.where(rt.is_cap[..., None], base + unit * rt.cap_radius, base)
    return torch.where(rt.valid[..., None], pos, rt.pad_pos)


def batched_fragment_terms(params: dict, rt: FragmentRuntime, pos: torch.Tensor,
                           cfg: V.ViSNetConfig):
    """ViSNet over both fragment families + stitching for Rl replicas'
    optimized rows, pos [Rl,R,S,3] -> (E [Rl], F [Rl,N,3]).

    ``frag/runtime.py:316-362``: the replica and row axes fold into one
    ViSNet batch per bucket (one kernel launch per layer for all replicas),
    and the forces stitch with ``index_add_`` on dim 1 of [Rl,N+1,3]."""
    Rl, N = pos.shape[0], rt.n_atoms
    energy = pos.new_zeros((Rl,))
    forces = pos.new_zeros((Rl, N + 1, 3))
    for b in rt.dip_buckets:
        r = len(b.rows)
        e_b, f_b = V.energy_and_forces(
            params, b.z.repeat(Rl, 1), pos[:, b.rows, : b.width].reshape(Rl * r, b.width, 3),
            b.valid.repeat(Rl, 1), cfg)
        energy = energy + (e_b.reshape(Rl, r) * b.has_atoms).sum(1)
        forces.index_add_(1, b.dst.reshape(-1), f_b.reshape(Rl, -1, 3))

    # ACE-NME views: the first/last 6 template slots of consecutive dipeptides
    ace = torch.nn.functional.pad(pos[:, rt.ace_rows, rt.ace_slots],
                                  (0, 0, 0, S_ACE - ACENME_LEN))
    ace_pos = torch.where(rt.ace_mask16[..., None], ace, rt.ace_park)
    C = rt.ace_z16.shape[0]
    e_a, f_a = V.energy_and_forces(params, rt.ace_z16.repeat(Rl, 1),
                                   ace_pos.reshape(Rl * C, S_ACE, 3),
                                   rt.ace_mask16.repeat(Rl, 1), cfg)
    energy = energy - (e_a.reshape(Rl, C) * rt.ace_valid).sum(1)
    forces.index_add_(1, rt.ace_dst16.reshape(-1), -f_a.reshape(Rl, -1, 3))
    return energy, forces[:, :N]


def _fragment_terms(params: dict, rt: FragmentRuntime, pos: torch.Tensor,
                    cfg: V.ViSNetConfig):
    """ViSNet over both fragment families + stitching, given optimized rows
    [R,S,3] of one protein."""
    energy, forces = batched_fragment_terms(params, rt, pos[None], cfg)
    return energy[0], forces[0]


def fragment_energy_forces(params: dict, rt: FragmentRuntime, P: torch.Tensor,
                           cfg: V.ViSNetConfig):
    """Bonded (ML) fragment energy [eV] and forces [N,3] [eV/A], caps cold
    started with ``rt.opt_iters`` L-BFGS iterations.  Cap forces are dropped,
    dipeptide forces add and ACE-NME forces subtract (reference
    combiner.py:23-41); no gradient flows through cap placement or
    optimization."""
    pos = HY.optimize_caps(rt.ht, build_row_positions(rt, P), n_iter=rt.opt_iters)
    return _fragment_terms(params, rt, pos.detach(), cfg)


def fragment_energy_forces_warm(params: dict, rt: FragmentRuntime, P: torch.Tensor,
                                cfg: V.ViSNetConfig, cap_delta: torch.Tensor,
                                warm_iters: int = 1):
    """Warm-started variant: caps start from the previous step's optimized
    offsets relative to the geometric placement.  Returns (E, F, new_delta)."""
    free = rt.is_cap[..., None]
    pos_geo = build_row_positions(rt, P)
    pos0 = pos_geo + torch.where(free, cap_delta, torch.zeros_like(cap_delta))
    pos = HY.optimize_caps(rt.ht, pos0, n_iter=warm_iters).detach()
    new_delta = torch.where(free, pos - pos_geo, torch.zeros_like(pos))
    energy, forces = _fragment_terms(params, rt, pos, cfg)
    return energy, forces, new_delta


def initial_cap_delta(rt: FragmentRuntime, P: torch.Tensor, n_iter: int = 10):
    """Cold-start offsets for the warm path (full optimization once); P
    [N,3], or [Rl,N,3] for one optimization per replica."""
    pos_geo = build_row_positions(rt, P)
    pos = HY.optimize_caps(rt.ht, pos_geo, n_iter=n_iter)
    return torch.where(rt.is_cap[..., None], pos - pos_geo, torch.zeros_like(pos))


def ensemble_fragment_energy_forces_warm(params: dict, rt: FragmentRuntime, Ps: torch.Tensor,
                                         cfg: V.ViSNetConfig, cap_delta: torch.Tensor,
                                         warm_iters: int = 1, replica_chunk: int = 8):
    """Warm-started fragment potential over Rl replicas (``frag/runtime.py:
    365-401``): Ps [Rl,N,3], cap_delta [Rl,R,S,3] -> (E [Rl], F [Rl,N,3],
    new_delta).  The caps are optimized per replica (one L-BFGS per replica,
    the same iterates as a lone replica's), then ViSNet runs on chunks of
    ``replica_chunk`` replicas (all of them if it does not divide Rl) in a
    Python loop.  Each ViSNet call's autograd graph is freed by its own
    backward, so one chunk's activations are alive at a time."""
    free = rt.is_cap[..., None]
    pos_geo = build_row_positions(rt, Ps)
    pos0 = pos_geo + torch.where(free, cap_delta, torch.zeros_like(cap_delta))
    pos = HY.optimize_caps(rt.ht, pos0, n_iter=warm_iters).detach()
    new_delta = torch.where(free, pos - pos_geo, torch.zeros_like(pos))
    Rl = Ps.shape[0]
    c = min(replica_chunk, Rl) if replica_chunk > 0 else Rl
    if Rl % c:
        c = Rl
    parts = [batched_fragment_terms(params, rt, pos[s:s + c], cfg) for s in range(0, Rl, c)]
    return (torch.cat([e for e, _ in parts]), torch.cat([f for _, f in parts]), new_delta)


def initial_cap_delta_batched(rt: FragmentRuntime, Ps: torch.Tensor, n_iter: int = 10):
    """Cold-start offsets of Rl replicas, Ps [Rl,N,3] -> [Rl,R,S,3]: one
    optimization per replica (``frag/runtime.py:404-405``).  Kept only for
    name parity with the JAX package: ``initial_cap_delta`` takes the
    replica axis itself."""
    return initial_cap_delta(rt, Ps, n_iter=n_iter)
