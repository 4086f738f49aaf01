"""Replica ensembles and the fragment-sharded potential over a dp x mp mesh
of ranks (``torch.distributed``, one rank a card; ``parallel.mesh``).

Port of ``ai2bmd_tpu/parallel/sharding.py``.  JAX runs one SPMD program per
MD step under ``shard_map``; here every rank runs its part eagerly and the
collectives are explicit (``utils.collectives``):

  dp -- the replica axis: each dp index holds a block of replicas
        (``ReplicaBlock``), and replicas never communicate.
  mp -- the fragment-row axis inside one replica (``ShardedPotential``):
        the dipeptide rows and ACE-NME units are split in blocks; each rank
        (1) places and warm-optimizes the caps of its own rows, the L-BFGS
        scalars all-reduced over mp, (2) all-gathers the optimized rows
        (ACE-NME units straddle two dipeptides), (3) runs one ViSNet call per
        size bucket on its rows (``bucket_shard_order`` gives every rank an
        equal slice of every bucket) and one on its ACE-NME units, and (4)
        stitches partial forces; E and F are all-reduced over mp.  The long
        range stays replicated on every rank, as JAX evaluates it.

``ReplicaEnsemble`` (the replica-batched force evaluation:
``frag.runtime.ensemble_fragment_energy_forces_warm``, replica and row axes
folded into one ViSNet batch per bucket, in chunks), ``SolvatedReplicaEnsemble``
(replicas of a solvated box, each stepped alone through the lone solvated
step, on the card one captured CUDA graph that each replica is loaded into)
and ``EnsembleSimulation`` (each replica stepped alone with the sharded
potential) take a ``mesh``: each rank runs its dp block of replicas with the
matching slice of the generators ``replica_generators(seed, n)``, so every
replica follows the trajectory it would follow alone.  ``gather`` brings
every replica's state to every rank for the writers, ``rng_states`` their
generator states, and ``scatter`` / ``set_rng_states`` load a restart.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ai2bmd_torch.frag import hydrogen as HY
from ai2bmd_torch.frag import runtime as RT
from ai2bmd_torch.host import ACENME_LEN, FragmentIndex, Protein
from ai2bmd_torch.io.pdb import PDBAtoms
from ai2bmd_torch.md import langevin as L
from ai2bmd_torch.md.graphed import GraphedLangevin
from ai2bmd_torch.md.simulation import overflow_flags
from ai2bmd_torch.models import visnet as V
from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig, resolve_config
from ai2bmd_torch.physics.nonbonded import NonbondedParams, nonbonded_energy_forces
from ai2bmd_torch.physics.qmmm import QMMMPotential
from ai2bmd_torch.potentials import FragmentPotential
from ai2bmd_torch.utils.collectives import all_gather_cat, all_reduce_sum
from ai2bmd_torch.utils.device import resolve_device
from ai2bmd_torch.utils.tree import tree_clone, tree_copy_, tree_map

log = logging.getLogger(__name__)


def replica_generators(seed: int, n: int, device) -> list[torch.Generator]:
    """One generator per replica, seeded from ``seed`` by numpy's
    ``SeedSequence.spawn`` (independent streams)."""
    seeds = [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def bucket_shard_order(fi: FragmentIndex, n_mp: int, widths=None
                       ) -> tuple[FragmentIndex, list[tuple[int, int, int]]]:
    """Reorder and pad the dipeptide rows for the bucketed mp split
    (``sharding.py:47-119``).

    Returns (permuted fi, layout), layout a list of (bucket width, local
    offset, local rows): after the row axis is split in n_mp blocks, every
    rank's block holds ``local rows`` rows of each size bucket at the same
    offsets, so every rank makes one ViSNet call a bucket at one shape.
    Buckets are padded to a multiple of n_mp with empty rows (natom 0,
    every slot invalid), which land in bucket 0 with the merged-away rows."""
    widths = RT.BUCKET_WIDTHS if widths is None else widths
    ws = [w for w in widths if w < fi.slots] + [fi.slots]
    natom = np.asarray(fi.row_natom)
    bucket_rows, lo = [], -1          # empty rows land in bucket 0
    for w in ws:
        bucket_rows.append(np.where((natom > lo) & (natom <= w))[0])
        lo = w

    pads = [(-len(sel)) % n_mp for sel in bucket_rows]
    fi_ext = _append_empty_rows(fi, sum(pads))
    next_new, padded = fi.n_rows, []
    for sel, pad in zip(bucket_rows, pads):
        padded.append(np.concatenate([sel, np.arange(next_new, next_new + pad)]).astype(np.int64))
        next_new += pad

    r_loc = [len(p) // n_mp for p in padded]
    perm = np.concatenate([padded[b][d * r_loc[b]:(d + 1) * r_loc[b]]
                           for d in range(n_mp) for b in range(len(ws))])
    inv = np.empty(fi_ext.n_rows, np.int64)
    inv[perm] = np.arange(len(perm))

    layout, off = [], 0
    for w, r in zip(ws, r_loc):
        if r:
            layout.append((int(w), int(off), int(r)))
        off += r

    fi_p = dataclasses.replace(
        fi_ext,
        row_type=[fi_ext.row_type[i] for i in perm],
        row_prmtop=[fi_ext.row_prmtop[i] for i in perm],
        **{k: getattr(fi_ext, k)[perm] for k in RT.ROW_ARRAYS},
        dip_row=inv[fi_ext.dip_row].astype(fi_ext.dip_row.dtype),
        ace_rows=inv[fi_ext.ace_rows].astype(fi_ext.ace_rows.dtype),
    )
    return fi_p, layout


def _append_empty_rows(fi: FragmentIndex, n: int) -> FragmentIndex:
    """``fi`` with n empty rows appended (``sharding.py:122-143``)."""
    if n == 0:
        return fi
    pad = lambda a: np.pad(a, [(0, n)] + [(0, 0)] * (a.ndim - 1))
    return dataclasses.replace(
        fi, n_rows=fi.n_rows + n, row_type=fi.row_type + [""] * n,
        row_prmtop=fi.row_prmtop + [""] * n, **{k: pad(getattr(fi, k)) for k in RT.ROW_ARRAYS})


@dataclasses.dataclass(frozen=True)
class ReplicaBlock:
    """The replicas one rank runs: block ``dp_rank`` of ``n_replicas`` split
    over the ``n_dp`` indices of a mesh's dp axis (every rank of one mp row
    holds the same block).  Without a mesh, every replica."""

    n_replicas: int
    n_dp: int = 1
    dp_rank: int = 0
    group: Any = None          # the dp process group (None: no mesh)

    @classmethod
    def of(cls, n_replicas: int, mesh) -> "ReplicaBlock":
        if mesh is None:
            return cls(n_replicas)
        n_dp = mesh.size(0)
        if n_replicas % n_dp:
            raise ValueError(f"{n_replicas} replicas do not shard over dp={n_dp}")
        return cls(n_replicas, n_dp, mesh.get_local_rank("dp"), mesh.get_group("dp"))

    @property
    def size(self) -> int:
        return self.n_replicas // self.n_dp

    def take(self, items):
        """This block's part of a sequence or tensor over every replica."""
        return items[self.dp_rank * self.size:(self.dp_rank + 1) * self.size]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every block's ``t`` [size, ...] as one [n_replicas, ...]."""
        return t if self.group is None else all_gather_cat(t, self.group)


_STATE_TENSORS = ("positions", "velocities", "forces", "energy")


class _Replicas:
    """What the ensembles share over a mesh's dp axis: the block of replicas
    this rank runs (``block``), their generators (``generators``, a slice of
    ``replica_generators``), and the collectives that bring every replica's
    state to every rank and load a restart back into the blocks."""

    block: ReplicaBlock
    device: torch.device
    generators: list | None

    def _start(self, positions, temp_K: float, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Seed this block's generators, return its Maxwell-Boltzmann
        velocities [size,N,3] and ``positions`` on the device."""
        self.generators = self.block.take(
            replica_generators(seed, self.block.n_replicas, self.device))
        masses = self.masses.cpu().numpy()
        vel = torch.stack([L.maxwell_boltzmann_velocities(g, masses, temp_K)
                           for g in self.generators])
        return vel, torch.as_tensor(np.asarray(positions), dtype=torch.float32,
                                    device=self.device)

    def replica(self, state: L.MDState, r: int) -> L.MDState:
        """Local replica r's lone state (views into ``state``)."""
        return L.MDState(state.positions[r], state.velocities[r], state.forces[r],
                         state.energy[r], step=state.step,
                         aux=tree_map(lambda t: t[r], state.aux))

    def _step_each(self, state: L.MDState, n_calls: int, advance) -> L.MDState:
        """``n_calls`` x ``steps_per_call`` steps of every local replica alone,
        ``advance(lone, generator, n_steps)``; ``state`` is left as it was."""
        if self.generators is None:
            raise ValueError("run needs the generators initial_state makes")
        out = L.MDState(*(getattr(state, k).clone() for k in _STATE_TENSORS),
                        step=state.step, aux=tree_clone(state.aux))
        for _ in range(n_calls):
            for r, g in enumerate(self.generators):
                lone = self.replica(out, r)
                stepped = advance(lone, g, self.steps_per_call)
                for name in _STATE_TENSORS:
                    getattr(lone, name).copy_(getattr(stepped, name))
                tree_copy_(lone.aux, stepped.aux)
            out.step += self.steps_per_call
        return out

    def _gather_aux(self, aux):
        return tree_map(self.block.gather, aux)

    def _scatter_aux(self, aux):
        return tree_map(self.block.take, aux)

    def gather(self, state: L.MDState) -> L.MDState:
        """Every replica's state (the carry too) on every rank: a collective
        call of every rank of the mesh.  Without a mesh, ``state``."""
        if self.block.group is None:
            return state
        return L.MDState(*(self.block.gather(getattr(state, k)) for k in _STATE_TENSORS),
                         step=state.step, aux=self._gather_aux(state.aux))

    def scatter(self, state: L.MDState) -> L.MDState:
        """This rank's part of a state of every replica (``gather``'s
        inverse)."""
        if self.block.group is None:
            return state
        return L.MDState(*(self.block.take(getattr(state, k)).clone() for k in _STATE_TENSORS),
                         step=state.step,
                         aux=tree_map(torch.clone, self._scatter_aux(state.aux)))

    def rng_states(self) -> list[torch.Tensor]:
        """Every replica's generator state, in replica order (a collective
        call of every rank of the mesh)."""
        mine = [g.get_state() for g in self.generators]
        if self.block.group is None:
            return mine
        parts = [None] * self.block.n_dp
        dist.all_gather_object(parts, mine, group=self.block.group)
        return [s for part in parts for s in part]

    def set_rng_states(self, states) -> None:
        """Load this block's generators from the states of every replica."""
        if len(states) != self.block.n_replicas:
            raise ValueError(f"{len(states)} generator states for {self.block.n_replicas} "
                             "replicas")
        for g, s in zip(self.generators, self.block.take(list(states))):
            g.set_state(torch.as_tensor(s, dtype=torch.uint8).cpu())


@dataclasses.dataclass
class ShardedPotential:
    """The fragment potential of one protein with its dipeptide rows and
    ACE-NME units split in blocks over a mesh's mp axis, each rank holding
    one block and the same optimizations as the lone path: size-bucketed
    ViSNet batches, warm-started caps, the 16-slot ACE-NME batch
    (``sharding.py:146-340``).  Every rank of an mp row calls it at the same
    positions; it returns the all-reduced (E, F), the same bits on each.
    ``energy_forces(P)`` from a cold cap start equals the lone
    ``FragmentPotential.energy_forces`` up to the order of its sums."""

    params: dict
    cfg: ViSNetConfig
    group: Any                 # the mp process group
    n_mp: int
    mp_rank: int
    n_atoms: int
    opt_iters: int
    layout: list               # (bucket width, local offset, local rows)
    row: dict                  # this rank's block of rows
    ace: dict                  # this rank's block of ACE-NME units
    ht: HY.HydrogenTables      # the cap tables of its rows
    nb: NonbondedParams

    @classmethod
    def build(cls, prot: Protein, fi: FragmentIndex, params: dict, cfg: ViSNetConfig, mesh,
              opt_iters: int = 10, device=None) -> "ShardedPotential":
        """``mesh`` a ("dp", "mp") mesh of the world (``parallel.mesh``);
        ``device`` None means the card (raises without one)."""
        device = resolve_device(device)
        module = ViSNet(cfg, params).to(device, torch.float32)
        cfg = resolve_config(cfg, device)
        n_mp, mp_rank = mesh.size(1), mesh.get_local_rank("mp")
        fi_p, layout = bucket_shard_order(fi, n_mp)
        # the row axis is a multiple of n_mp already; row_multiple pads the
        # ACE-NME axis so that it splits evenly
        fi_p = RT._pad_rows(fi_p, n_mp)
        rt = RT.FragmentRuntime.build(fi_p, opt_iters=opt_iters, device=device)
        r_loc, c_loc = fi_p.n_rows // n_mp, len(fi_p.ace_rows) // n_mp
        rows = slice(mp_rank * r_loc, (mp_rank + 1) * r_loc)
        aces = slice(mp_rank * c_loc, (mp_rank + 1) * c_loc)
        dip_dst = np.where(fi_p.valid & ~fi_p.is_cap, fi_p.gather_idx, fi_p.n_atoms)
        on = lambda a, dtype: torch.as_tensor(np.asarray(a)[rows], dtype=dtype, device=device)
        row = dict(gather_idx=rt.gather_idx[rows], cap_dir_idx=rt.cap_dir_idx[rows],
                   cap_radius=rt.cap_radius[rows], is_cap=rt.is_cap[rows],
                   valid=rt.valid[rows], pad_pos=rt.pad_pos[rows],
                   row_z=on(fi_p.row_z, torch.int64), dip_dst=on(dip_dst, torch.int64),
                   row_has_atoms=on(fi_p.row_natom > 0, torch.bool))
        ace = {k: getattr(rt, k)[aces] for k in ("ace_rows", "ace_slots", "ace_z16",
                                                 "ace_mask16", "ace_dst16", "ace_park",
                                                 "ace_valid")}
        return cls(params=module.params(), cfg=cfg, group=mesh.get_group("mp"), n_mp=n_mp,
                   mp_rank=mp_rank, n_atoms=fi.n_atoms, opt_iters=opt_iters, layout=layout,
                   row=row, ace=ace, ht=rt.ht.rows(rows),
                   nb=NonbondedParams.build(prot, fi.exclusion_mask(), device))

    def local_energy_forces(self, P: torch.Tensor, cap_delta: torch.Tensor,
                            warm_iters: int):
        """(E, F [N,3], new cap offsets of this rank's rows) at P [N,3], the
        caps started ``cap_delta`` [R_loc,S,3] off their placement and
        optimized ``warm_iters`` L-BFGS iterations (``sharding.py:218-285``)."""
        row, ace, N = self.row, self.ace, self.n_atoms
        base = P[row["gather_idx"]]
        unit = HY._safe_unit(P[row["cap_dir_idx"]] - base)
        pos_geo = torch.where(row["is_cap"][..., None], base + unit * row["cap_radius"], base)
        pos_geo = torch.where(row["valid"][..., None], pos_geo, row["pad_pos"])
        free = row["is_cap"][..., None]
        pos0 = pos_geo + torch.where(free, cap_delta, torch.zeros_like(cap_delta))
        pos = HY.optimize_caps(self.ht, pos0, n_iter=warm_iters, group=self.group)
        new_delta = torch.where(free, pos - pos_geo, torch.zeros_like(pos))
        pos_all = all_gather_cat(pos, self.group)

        # one ViSNet call per size bucket on this rank's rows; the padded empty
        # rows' energies are taken out by selection, so that nothing they give
        # can reach E (0 * NaN would)
        energy = P.new_zeros(())
        forces = P.new_zeros((N + 1, 3))
        for w, off, r in self.layout:
            e_b, f_b = V.energy_and_forces(self.params, row["row_z"][off:off + r, :w],
                                           pos[off:off + r, :w], row["valid"][off:off + r, :w],
                                           self.cfg)
            has = row["row_has_atoms"][off:off + r]
            energy = energy + torch.where(has, e_b, torch.zeros_like(e_b)).sum()
            forces.index_add_(0, row["dip_dst"][off:off + r, :w].reshape(-1), f_b.reshape(-1, 3))

        # the ACE-NME batch at 16 slots, its padding slots parked
        units = torch.nn.functional.pad(pos_all[ace["ace_rows"], ace["ace_slots"]],
                                        (0, 0, 0, RT.S_ACE - ACENME_LEN))
        ace_pos = torch.where(ace["ace_mask16"][..., None], units, ace["ace_park"])
        e_a, f_a = V.energy_and_forces(self.params, ace["ace_z16"], ace_pos, ace["ace_mask16"],
                                       self.cfg)
        energy = energy - (e_a * ace["ace_valid"]).sum()
        forces.index_add_(0, ace["ace_dst16"].reshape(-1), -f_a.reshape(-1, 3))

        total = all_reduce_sum(torch.cat([energy.reshape(1), forces[:N].reshape(-1)]),
                               self.group)
        e_nb, f_nb = nonbonded_energy_forces(self.nb, P)
        return total[0] + e_nb, total[1:].reshape(N, 3) + f_nb, new_delta

    def _cold(self, P: torch.Tensor):
        zero = P.new_zeros(self.row["valid"].shape + (3,))
        return self.local_energy_forces(P, zero, self.opt_iters)

    def energy_forces(self, P: torch.Tensor):
        """One replica's (E, F) from a cold cap start (``opt_iters``
        iterations), P [N,3] the same on every rank of the mp row
        (``sharding.py:303-321``)."""
        e, f, _ = self._cold(P)
        return e, f

    def initial_cap_delta(self, P: torch.Tensor) -> torch.Tensor:
        """Cold-start cap offsets of this rank's rows (``sharding.py:323-340``)."""
        return self._cold(P)[2]

    def gather_cap_delta(self, delta: torch.Tensor) -> torch.Tensor:
        """Every rank's cap offsets [..., R_loc,S,3] as [..., R,S,3], the rows
        in ``bucket_shard_order``'s order."""
        return all_gather_cat(delta, self.group, dim=delta.dim() - 3)


@dataclasses.dataclass
class ReplicaEnsemble(_Replicas):
    """``n_replicas`` Langevin trajectories with a replica-batched force
    evaluation (BASELINE config 5: 64 Chignolin replicas on one card).
    ``ViSNetConfig(remat=True)`` keeps its memory to one chunk's edge rows.
    Over a mesh each rank batches its dp block (``sharding.py:404-423``)."""

    n_replicas: int
    steps_per_call: int
    warm_iters: int
    replica_chunk: int
    params: dict
    cfg: ViSNetConfig
    rt: RT.FragmentRuntime
    nb: NonbondedParams
    coeffs: L.LangevinCoeffs
    masses: torch.Tensor
    device: torch.device
    block: ReplicaBlock
    generators: list | None = None

    @classmethod
    def build(cls, prot: Protein, fi: FragmentIndex, params: dict, cfg: ViSNetConfig,
              n_replicas: int, timestep_fs: float = 1.0, temp_K: float = 300.0,
              friction_per_fs: float = 0.001, steps_per_call: int = 1, warm_iters: int = 1,
              replica_chunk: int = 8, device=None, mesh=None) -> "ReplicaEnsemble":
        """``params`` is the ViSNet parameter tree (the JAX layout, as
        ``models.params`` makes it), moved to the device as float32.
        ``device`` None means the card (raises without one).  ``mesh`` (a
        ("dp", "mp") mesh of the world, ``parallel.mesh``): this rank runs
        the replicas of its dp index, ``n_replicas`` / n_dp of them."""
        block = ReplicaBlock.of(n_replicas, mesh)
        device = resolve_device(device)
        module = ViSNet(cfg, params).to(device, torch.float32)
        cfg = resolve_config(cfg, device)
        return cls(
            n_replicas=n_replicas, steps_per_call=steps_per_call, warm_iters=warm_iters,
            replica_chunk=replica_chunk, params=module.params(), cfg=cfg,
            rt=RT.FragmentRuntime.build(fi, device=device),
            nb=NonbondedParams.build(prot, fi.exclusion_mask(), device),
            coeffs=L.LangevinCoeffs.build(prot.masses, timestep_fs, temp_K, friction_per_fs,
                                          device=device),
            masses=torch.as_tensor(np.asarray(prot.masses), dtype=torch.float32, device=device),
            device=device, block=block,
        )

    def potential(self, Ps: torch.Tensor, deltas: torch.Tensor):
        """(Ps [Rl,N,3], cap offsets [Rl,R,S,3]) -> (E [Rl], F [Rl,N,3], offsets)."""
        e_b, f_b, deltas = RT.ensemble_fragment_energy_forces_warm(
            self.params, self.rt, Ps, self.cfg, deltas, warm_iters=self.warm_iters,
            replica_chunk=self.replica_chunk)
        e_nb, f_nb = nonbonded_energy_forces(self.nb, Ps)
        return e_b + e_nb, f_b + f_nb, deltas

    def initial_state(self, positions, temp_K: float = 300.0, seed: int = 0,
                      opt_iters: int = 10) -> L.MDState:
        """This rank's replicas at ``positions`` [N,3] with Maxwell-Boltzmann
        velocities from their own generators (``replica_generators(seed)``,
        this block's slice, which then drive their noise), cold caps
        (``opt_iters`` L-BFGS iterations per replica) and real first forces
        from a warm step."""
        vel, P = self._start(positions, temp_K, seed)
        pos = P.expand(self.block.size, *P.shape).contiguous()
        deltas = RT.initial_cap_delta_batched(self.rt, pos, n_iter=opt_iters)
        # real first forces: zeros would give every replica a zero-force
        # first half-kick
        energy, forces, deltas = self.potential(pos, deltas)
        return L.MDState(positions=pos, velocities=vel, forces=forces, energy=energy,
                         aux=deltas)

    def run(self, state: L.MDState, n_calls: int) -> L.MDState:
        """``n_calls`` × ``steps_per_call`` batched Langevin steps."""
        if self.generators is None:
            raise ValueError("run needs the generators initial_state makes")
        for _ in range(n_calls * self.steps_per_call):
            state = L.langevin_step_batched(self.potential, self.coeffs, self.masses, state,
                                            generators=self.generators)
        return state


@dataclasses.dataclass
class EnsembleSimulation(_Replicas):
    """``n_replicas`` independent Langevin trajectories of one protein over a
    dp x mp mesh (``sharding.py:483-606``): each rank holds its dp block of
    replicas (every rank of an mp row the same ones) and steps each replica
    alone, eagerly, with the fragment-sharded potential (bucketed ViSNet
    batches and warm caps, as the lone path).  ``state.aux`` holds the cap
    offsets of this rank's rows [size, R_loc, S, 3]."""

    n_replicas: int
    steps_per_call: int
    warm_iters: int
    sp: ShardedPotential
    coeffs: L.LangevinCoeffs
    masses: torch.Tensor
    device: torch.device
    block: ReplicaBlock
    generators: list | None = None

    @classmethod
    def build(cls, prot: Protein, fi: FragmentIndex, params: dict, cfg: ViSNetConfig, mesh,
              n_replicas: int, timestep_fs: float = 1.0, temp_K: float = 300.0,
              friction_per_fs: float = 0.001, steps_per_call: int = 1, opt_iters: int = 10,
              warm_iters: int = 1, device=None) -> "EnsembleSimulation":
        """``device`` None means the card (raises without one)."""
        block = ReplicaBlock.of(n_replicas, mesh)
        device = resolve_device(device)
        sp = ShardedPotential.build(prot, fi, params, cfg, mesh, opt_iters=opt_iters,
                                    device=device)
        return cls(
            n_replicas=n_replicas, steps_per_call=steps_per_call, warm_iters=warm_iters, sp=sp,
            coeffs=L.LangevinCoeffs.build(prot.masses, timestep_fs, temp_K, friction_per_fs,
                                          device=device),
            masses=torch.as_tensor(np.asarray(prot.masses), dtype=torch.float32, device=device),
            device=device, block=block)

    def potential(self, P: torch.Tensor, delta: torch.Tensor):
        """One replica's warm step: (P [N,3], this rank's cap offsets) ->
        (E, F, offsets)."""
        return self.sp.local_energy_forces(P, delta, self.warm_iters)

    def initial_state(self, positions, temp_K: float = 300.0, seed: int = 0) -> L.MDState:
        """This rank's replicas at ``positions`` [N,3] with Maxwell-Boltzmann
        velocities from their own generators (``replica_generators(seed)``,
        this block's slice), and one identical start: the cold caps and
        first forces of one evaluation, broadcast (``sharding.py:565-600``)."""
        vel, P = self._start(positions, temp_K, seed)
        energy, forces, delta = self.sp._cold(P)
        rep = lambda t: t.expand(self.block.size, *t.shape).clone()
        return L.MDState(positions=rep(P), velocities=vel, forces=rep(forces),
                         energy=rep(energy), aux=rep(delta))

    def run(self, state: L.MDState, n_calls: int) -> L.MDState:
        """``n_calls`` x ``steps_per_call`` Langevin steps of every local
        replica, each alone on its own generator; ``state`` is left as it was.
        Every rank of an mp row makes the same calls (their collectives
        pair up)."""
        def advance(lone, generator, n_steps):
            for _ in range(n_steps):
                lone = L.langevin_step(self.potential, self.coeffs, self.masses, lone,
                                       generator=generator)
            return lone

        return self._step_each(state, n_calls, advance)

    def _gather_aux(self, aux):
        return self.sp.gather_cap_delta(self.block.gather(aux))

    def _scatter_aux(self, aux):
        r_loc = aux.shape[1] // self.sp.n_mp
        return self.block.take(aux)[:, self.sp.mp_rank * r_loc:(self.sp.mp_rank + 1) * r_loc]


@dataclasses.dataclass
class SolvatedReplicaEnsemble(_Replicas):
    """``n_replicas`` independent solvated QM/MM Langevin trajectories of one
    box (the reference samples on the solvated box,
    src/AIMD/simulator.py:119-137).  One solvated step fills the card, so a
    rank's replicas step one after another, as JAX's ``lax.map`` runs them;
    over a mesh each rank runs its dp block (``sharding.py:686-699``).

    The pair route is ``QMMMPotential.build``'s ``auto``, chosen once and
    logged: the cell buckets on a liquid box, since their assignment runs
    inside every step and each replica carries its own (JAX hard-codes
    ``dense``, sharding.py:662, because a per-replica list rebuild cannot
    stay static under its ``lax.map``); the pair set inside the cutoff is
    the same, the summation order differs.  The state holds every local
    replica's tensors on a leading axis, the carry (cell buckets with their
    sticky overflow flag, cap offsets) too."""

    n_replicas: int
    steps_per_call: int
    qmmm: QMMMPotential
    coeffs: L.LangevinCoeffs
    masses: torch.Tensor
    device: torch.device
    qm_idx: np.ndarray            # protein atom indices (the QM region)
    block: ReplicaBlock
    generators: list | None = None
    graph: GraphedLangevin | None = None

    @classmethod
    def build(cls, atoms: PDBAtoms, params: dict, cfg: ViSNetConfig, n_replicas: int,
              mesh=None, timestep_fs: float = 1.0, temp_K: float = 300.0,
              friction_per_fs: float = 0.001, steps_per_call: int = 1, warm_iters: int = 1,
              mm_backend: str = "ff19sb", device=None) -> "SolvatedReplicaEnsemble":
        """``atoms``: the solvated box (normalized atom order).  The QM side is
        the lone route's ``FragmentPotential`` with warm caps (``warm_iters``
        L-BFGS iterations a step), the MM side ``QMMMPotential``.  ``device``
        None means the card (raises without one); ``mesh``: this rank runs
        the replicas of its dp index."""
        block = ReplicaBlock.of(n_replicas, mesh)
        full = Protein.from_atoms(atoms)
        qm_idx = full.protein_indices()
        if len(qm_idx) == len(full):
            raise ValueError("input box has no solvent; use ReplicaEnsemble for vacuum "
                             "fragment-mode ensembles")
        device = resolve_device(device)
        prot = full.select(qm_idx)
        pot = FragmentPotential.build(prot, ViSNet(cfg, params).to(device, torch.float32), cfg,
                                      longrange="mm", device=device)
        P_prot = torch.as_tensor(prot.positions, dtype=torch.float32, device=device)
        qmmm = QMMMPotential.build(
            atoms, qm_stateful=lambda Pq, qa: pot.stateful_energy_forces(
                Pq, qa, warm_iters=warm_iters),
            qm_init_aux=pot.init_cap_delta(P_prot), mm_backend=mm_backend, device=device)
        log.info("SolvatedReplicaEnsemble: %d replicas of %d atoms (%d in the QM region), "
                 "%s pair route, %d on this rank", n_replicas, len(full), len(qm_idx),
                 qmmm.backend, block.size)
        return cls(
            n_replicas=n_replicas, steps_per_call=steps_per_call, qmmm=qmmm,
            coeffs=L.LangevinCoeffs.build(full.masses, timestep_fs, temp_K, friction_per_fs,
                                          device=device),
            masses=torch.as_tensor(np.asarray(full.masses), dtype=torch.float32, device=device),
            device=device, qm_idx=qm_idx, block=block)

    def initial_state(self, positions, temp_K: float = 300.0, seed: int = 0) -> L.MDState:
        """This rank's replicas at ``positions`` [N,3]: Maxwell-Boltzmann
        velocities from their own generators (``replica_generators(seed)``,
        this block's slice, which then drive their noise), and one identical
        start: the cold caps and first forces of one evaluation, broadcast."""
        vel, P = self._start(positions, temp_K, seed)
        energy, forces, aux = self.qmmm(P, self.qmmm.init_aux(P))
        rep = lambda t: t.expand(self.block.size, *t.shape).clone()
        return L.MDState(positions=rep(P), velocities=vel, forces=rep(forces),
                         energy=rep(energy), aux=tree_map(rep, aux))

    def run(self, state: L.MDState, n_calls: int) -> L.MDState:
        """``n_calls`` x ``steps_per_call`` Langevin steps of every local
        replica, each drawing its noise from its own generator in the lone
        step's order; ``state`` is left as it was.  On the card each replica's
        state is loaded into one captured step (captured at the first call)
        and replayed; on the CPU the steps run eagerly.  Raises when a
        replica's cell assignment overflowed (it drops pairs)."""
        out = self._step_each(state, n_calls, self._advance)
        for kind, flag in overflow_flags(out.aux):
            if bool(flag.any()):
                raise RuntimeError(f"{kind} overflow by step {out.step}: some replica's atoms "
                                   f"are missing from the pair sum")
        return out

    def _advance(self, lone: L.MDState, generator: torch.Generator, n_steps: int) -> L.MDState:
        if self.device.type != "cuda":
            for _ in range(n_steps):
                lone = L.langevin_step(self.qmmm, self.coeffs, self.masses, lone,
                                       generator=generator)
            return lone
        if self.graph is None:
            self.graph = GraphedLangevin(self.qmmm, self.coeffs, self.masses, lone, generator)
        self.graph.load(lone, generator)
        return self.graph.run(n_steps)
