"""The potentials: fragment mode (ML bonded terms + classical long range) and
whole-molecule mode.

Port of ``ai2bmd_tpu/potentials.py`` (``FragmentPotential``,
``ViSNetPotential``).  ``build`` puts the ViSNet module on the card unless
the caller passes ``device="cpu"``: on the card the kernels run, on the CPU
the plain versions.  The dtype is the module's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ai2bmd_torch.frag import runtime as RT
from ai2bmd_torch.host import FragmentIndex, Protein, build_fragment_index
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig, energy_and_forces, resolve_config
from ai2bmd_torch.physics.nonbonded import NonbondedParams, nonbonded_energy_forces
from ai2bmd_torch.physics.pme import PMEParams, pme_energy_forces
from ai2bmd_torch.utils.device import resolve_device


@dataclasses.dataclass
class FragmentPotential:
    """Divide-and-conquer ML potential + a classical long-range term: "mm"
    (LJ + bare Coulomb over the exclusion complement, ``nb``) or "pme"
    (smooth PME over the periodic cell of the input's CRYST1 record,
    ``pme``; dense [N,N] pair masks, no neighbour list)."""

    module: ViSNet
    cfg: ViSNetConfig
    rt: RT.FragmentRuntime
    nb: NonbondedParams | None
    fi: FragmentIndex
    pme: PMEParams | None = None

    @classmethod
    def build(cls, prot: Protein, module: ViSNet, cfg: ViSNetConfig,
              longrange: str = "mm", opt_iters: int = 10,
              device=None) -> "FragmentPotential":
        """``device`` None means the card (raises without one); the module is
        moved there.  ``cfg`` goes through
        ``resolve_config`` for that device."""
        if longrange not in ("mm", "pme"):
            raise ValueError(f"unknown long-range mode {longrange!r}")
        device = resolve_device(device)
        module = module.to(device)
        dtype = next(module.parameters()).dtype
        cfg = resolve_config(cfg, device)
        fi = build_fragment_index(prot.atoms)
        rt = RT.FragmentRuntime.build(fi, opt_iters=opt_iters, device=device, dtype=dtype)
        nb = pme = None
        if longrange == "mm":
            nb = NonbondedParams.build(prot, fi.exclusion_mask(), device, dtype)
        else:
            pme = PMEParams.build(prot, fi.exclusion_pairs, device=device, dtype=dtype)
        return cls(module=module, cfg=cfg, rt=rt, nb=nb, fi=fi, pme=pme)

    def _longrange(self, P: torch.Tensor):
        if self.nb is not None:
            return nonbonded_energy_forces(self.nb, P)
        return pme_energy_forces(self.pme, P)

    def energy_forces(self, P: torch.Tensor):
        e_b, f_b = RT.fragment_energy_forces(self.module.params(), self.rt, P, self.cfg)
        e_nb, f_nb = self._longrange(P)
        return e_b + e_nb, f_b + f_nb

    # -- warm-started stateful variant (aux = cap offsets) -------------------
    def init_cap_delta(self, P: torch.Tensor) -> torch.Tensor:
        """Cold-start cap offsets: ``initial_cap_delta``'s default of 10 L-BFGS
        iterations whatever ``opt_iters`` is, as the reference's
        ``FragmentPotential.init_cap_delta`` (``opt_iters`` sets the stateless
        path's iterations)."""
        return RT.initial_cap_delta(self.rt, P)

    def stateful_energy_forces(self, P: torch.Tensor, aux: torch.Tensor,
                               warm_iters: int = 1):
        e_b, f_b, aux = RT.fragment_energy_forces_warm(
            self.module.params(), self.rt, P, self.cfg, aux, warm_iters=warm_iters)
        e_nb, f_nb = self._longrange(P)
        return e_b + e_nb, f_b + f_nb, aux


@dataclasses.dataclass
class ViSNetPotential:
    """Whole-molecule mode (the reference's ``--mode visnet``): the whole
    system is one ViSNet batch of one molecule, padded to a multiple of
    ``pad_multiple`` slots, the padded slots masked out and parked at 1e4 A.
    For a molecule with a user-trained checkpoint; no caps, no long-range
    term.  Stateless: ``energy_forces`` is P -> (E, F).  On the card every
    layer's edge core runs through K1-K3 (K7/K8 with ``remat``), or with
    ``fused_layer`` (``AI2BMD_FUSED_LAYER=1``) every layer through K5/K6;
    both take any slot count up to ``ops.vismp.EDGE_MAXA``."""

    module: ViSNet
    cfg: ViSNetConfig
    z: torch.Tensor      # [1, pad_to] atomic numbers, 0 in the padding
    mask: torch.Tensor   # [1, pad_to] bool
    pad_to: int

    @classmethod
    def build(cls, numbers, module: ViSNet, cfg: ViSNetConfig, pad_multiple: int = 8,
              device=None) -> "ViSNetPotential":
        """``device`` None means the card (raises without one); the module is
        moved there and ``cfg`` goes through ``resolve_config`` for it."""
        device = resolve_device(device)
        module = module.to(device)
        cfg = resolve_config(cfg, device)
        n = len(numbers)
        pad_to = -(-n // pad_multiple) * pad_multiple
        z = torch.zeros((1, pad_to), dtype=torch.long)
        z[0, :n] = torch.as_tensor(np.asarray(numbers), dtype=torch.long)
        mask = torch.zeros((1, pad_to), dtype=torch.bool)
        mask[0, :n] = True
        return cls(module=module, cfg=cfg, z=z.to(device), mask=mask.to(device), pad_to=pad_to)

    def energy_forces(self, P: torch.Tensor):
        """E (0-d) and F [N,3] of the N atoms at P [N,3], in the module's
        dtype."""
        n = P.shape[0]
        pos = torch.full((1, self.pad_to, 3), 1e4, dtype=self.module_dtype, device=P.device)
        pos[0, :n] = P
        e, f = energy_and_forces(self.module.params(), self.z, pos, self.mask, self.cfg)
        return e[0], f[0, :n]

    @property
    def module_dtype(self) -> torch.dtype:
        return next(self.module.parameters()).dtype
