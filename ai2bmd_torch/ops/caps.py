"""Cap-hydrogen AMBER gradient: index-form tables, kernel K4, plain version.

Port of ``ai2bmd_tpu/ops/pallas/caps.py``.  The TPU kernel gathered term
endpoints and scattered forces through one-hot selector matmuls; here the
tables stay in index form, gathered per dipeptide row from the same
``TypeTopology`` tables, and serve both the plain energy
(``frag/hydrogen.amber_row_energy``) and the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.host import TypeTopology
from ai2bmd_torch.ops import LAUNCHES, _build

_INDEX = ("bond_ij", "angle_ijk", "dih_ijkl", "nb_ij")
_COEF = ("bond_k", "bond_r0", "angle_k", "angle_t0", "dih_k", "dih_n", "dih_phase",
         "nb_acoef", "nb_bcoef", "nb_qq")


@dataclasses.dataclass
class CapTables:
    """Per-row AMBER term tables: index arrays [R, X, m] (int64), coefficient
    arrays [R, X] in the working dtype, ``nb_mask`` [R, NP] bool, and the
    1-4 scalings.  ``kernel`` holds the same tables as K4 takes them:
    int32 indices, float32 coefficients with 1/scnb and 1/scee folded in,
    then the per-atom slot lists of ``slot_lists``."""

    bond_ij: torch.Tensor
    bond_k: torch.Tensor
    bond_r0: torch.Tensor
    angle_ijk: torch.Tensor
    angle_k: torch.Tensor
    angle_t0: torch.Tensor
    dih_ijkl: torch.Tensor
    dih_k: torch.Tensor
    dih_n: torch.Tensor
    dih_phase: torch.Tensor
    nb_ij: torch.Tensor
    nb_acoef: torch.Tensor
    nb_bcoef: torch.Tensor
    nb_qq: torch.Tensor
    nb_mask: torch.Tensor
    scee: float
    scnb: float
    kernel: tuple

    @classmethod
    def build(cls, top: TypeTopology, type_id: np.ndarray, n_slots: int, device,
              dtype) -> "CapTables":
        """Tables for the rows of ``type_id``, each of ``n_slots`` atom slots."""
        tid = np.asarray(type_id)
        rows = {k: getattr(top, k)[tid] for k in _INDEX + _COEF + ("nb_mask",)}
        t = {k: torch.as_tensor(rows[k], dtype=torch.int64, device=device) for k in _INDEX}
        t.update({k: torch.as_tensor(rows[k], dtype=dtype, device=device) for k in _COEF})
        t["nb_mask"] = torch.as_tensor(rows["nb_mask"], dtype=torch.bool, device=device)
        i32 = lambda k: torch.as_tensor(rows[k], dtype=torch.int32, device=device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        kernel = (
            i32("bond_ij"), f32(rows["bond_k"]), f32(rows["bond_r0"]),
            i32("angle_ijk"), f32(rows["angle_k"]), f32(rows["angle_t0"]),
            i32("dih_ijkl"), f32(rows["dih_k"]), f32(rows["dih_n"]), f32(rows["dih_phase"]),
            i32("nb_ij"), f32(rows["nb_acoef"] / top.scnb), f32(rows["nb_bcoef"] / top.scnb),
            f32(rows["nb_qq"] / top.scee), f32(rows["nb_mask"]),
            *(torch.as_tensor(a, device=device)
              for a in slot_lists([rows[k] for k in _INDEX], rows["nb_mask"], n_slots)),
        )
        return cls(**t, scee=top.scee, scnb=top.scnb, kernel=kernel)

    def rows(self, sl: slice) -> "CapTables":
        """The tables of the rows ``sl`` alone (a rank's block of rows)."""
        return dataclasses.replace(
            self, **{k: getattr(self, k)[sl] for k in _INDEX + _COEF + ("nb_mask",)},
            kernel=tuple(t[sl].contiguous() for t in self.kernel))

    @property
    def sizes(self) -> tuple[int, int, int, int]:
        return (self.bond_k.shape[1], self.angle_k.shape[1], self.dih_k.shape[1],
                self.nb_qq.shape[1])


def slot_lists(index_tables: list, nb_mask: np.ndarray, n_slots: int):
    """K4's per-atom slot lists: for each row, the (term, endpoint) slots
    that name each atom, in ascending slot order, as CSR arrays
    ``slot_ptr`` [R, S+1] and ``slot_idx`` [R, NE] (int32; the tail past
    ``slot_ptr[r, S]`` is unused).  Slots are numbered as K4 writes them:
    bond endpoints, then angle, dihedral and pair endpoints, term-major.

    Left out are the slots whose force is always +-0.0: those of masked-out
    pairs, and those of terms whose endpoints are all one atom (the tables'
    padding, which K4's geometry guards give zero force).  Adding +-0.0 to
    a float32 sum that starts at +0.0 changes nothing, so the lists give
    the same sums, bit for bit, as a scan over every slot."""
    R = nb_mask.shape[0]
    atom = np.concatenate([t.reshape(R, -1) for t in index_tables], 1)
    live = np.concatenate(
        [np.repeat(~(t == t[..., :1]).all(-1), t.shape[-1], 1) for t in index_tables], 1)
    live[:, -2 * nb_mask.shape[1]:] &= np.repeat(np.asarray(nb_mask, bool), 2, 1)
    ptr = np.zeros((R, n_slots + 1), np.int32)
    idx = np.zeros(atom.shape, np.int32)
    for r in range(R):
        slots = np.flatnonzero(live[r])
        idx[r, :len(slots)] = slots[np.argsort(atom[r, slots], kind="stable")]
        ptr[r, 1:] = np.cumsum(np.bincount(atom[r, slots], minlength=n_slots))
    return ptr, idx


def amber_grad_rows_plain(ct: CapTables, pos: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: autograd of the plain AMBER energy, [..., R,S,3]."""
    from ai2bmd_torch.frag.hydrogen import amber_row_energy

    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(amber_row_energy(ct, p).sum(), p)
    return g


_CAP_ARGS = [_build.P] * 19 + [_build.I] * 7


def amber_grad_rows(ct: CapTables, pos: torch.Tensor) -> torch.Tensor:
    """dE/dpos [..., R,S,3] of every row's cap energy (K4 on CUDA, autograd
    of the plain energy on the CPU); leading axes (replicas) take the same R
    rows of tables, and K4 runs once over all of them.  Forward only:
    callers stop the gradient."""
    if pos.device.type == "cpu":
        return amber_grad_rows_plain(ct, pos)
    if not pos.is_cuda:
        raise ValueError(f"no cap-gradient implementation for device {pos.device}")
    RT, S, _ = pos.shape[-3:]
    R = pos.numel() // (S * 3)
    NB, NA, ND, NP = ct.sizes
    _build.check("pos", pos, (*pos.shape[:-3], RT, S, 3), device=pos.device)
    for tab in ct.kernel:
        if tab.device != pos.device or not tab.is_contiguous():
            raise ValueError("cap tables must be contiguous and on the device of pos")
    if ct.kernel[0].shape[0] != RT:
        raise ValueError(f"cap tables hold {ct.kernel[0].shape[0]} rows, pos has {RT}")
    if ct.kernel[-2].shape[1] != S + 1:
        raise ValueError(f"cap slot lists are for {ct.kernel[-2].shape[1] - 1} slots, pos has {S}")
    grad = torch.empty_like(pos)
    _build.call("cap_grad_launch", _CAP_ARGS, pos.data_ptr(),
                *(t.data_ptr() for t in ct.kernel), grad.data_ptr(),
                R, RT, S, NB, NA, ND, NP)
    LAUNCHES["cap_grad"] += 1
    return grad
