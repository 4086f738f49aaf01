"""Command-line entry point of the PyTorch port: ``python -m ai2bmd_torch``.

Port of ``ai2bmd_tpu/cli.py:22-422``.  The parser has every option of the
JAX package's, with the same defaults and choices, and one more:
``--device {cuda,cpu}`` (default ``cuda``; the counterpart of the JAX CLI's
``JAX_PLATFORMS`` pin).  The run goes through ``resolve_device``, so without
a card and without ``--device cpu`` it raises; it never falls back to the
CPU, and on the card the MD loop is replays of one captured step.

Routes:
  * ``--preprocess``, or ``--solvent`` on an input without water (as the
    JAX CLI detects it): ``preprocess.Preprocessor`` (``--max-cyc``,
    ``--seed``, ``--preprocess-method``) solvates and equilibrates the
    protein into ``<log-dir>/<prot>-preeq.pdb``, or finds it there, and the
    run goes on with that box
  * ``ProteinSimulation``: fragment mode (``--fragment-longrange-calc mm`` or
    ``pme``), and whole-molecule mode with ``--mode visnet``; a solvated
    input (or ``--solvent``) runs subtractive QM/MM over the whole periodic
    box with the ff19SB engine (``--mm-method mm-engine``, and ``tinker`` /
    ``tinker-GPU``, which name the reference's co-process, as in the JAX
    package; ``--polarizable-mm`` adds the induced-dipole hybrid) or the
    polarizable AMOEBA engine (``--mm-method amoeba``), ``--rigid-water`` (SETTLE) and ``--no-write-solvent`` (a
    trajectory of the protein only); with ``--no-solvent`` it runs its
    protein alone in vacuum; an exception during the simulation exits 255,
    as the reference's runaway / solver errors do
  * ``--replicas > 1`` (or ``--mesh-mp > 1``): ``ReplicaEnsemble`` on one
    card for a vacuum input (or, with ``--no-solvent``, a solvated input's
    protein, as the lone route runs it; JAX's ensemble route ignores
    ``--no-solvent``), ``SolvatedReplicaEnsemble`` for a solvated one
    (ff19SB; ``--mm-method amoeba`` and ``--polarizable-mm`` there run
    ff19SB with a warning, as in the JAX package); each replica with its own DCD, the whole batched
    state (and every replica's generator state) checkpointed each record
    interval
  * weights: ``--ckpt-path`` (a Lightning .ckpt, or a converted .npz; with
    ``--ckpt-type <id>`` the file ``<ckpt-path>/visnet-uni-<id>.ckpt``) on
    every route, else random weights; a file that is not a checkpoint exits
    nonzero naming it

``--preprocess --preprocess-method AMOEBA`` minimizes the solvated box with
the whole AMOEBA force field (``Preprocessor._run_amoeba``), and the run goes
on with the box as after the FF19SB protocol.

Refused, naming the ROADMAP item that ports it: a mesh of more than one card
(item 17); and ``--matmul-precision`` other than
float32 (the port's products are float32 or 3xTF32 by design).  The
reference's ``--device-strategy``, ``--work-strategy`` and ``--chunk-size``
are accepted as no-ops, as in the JAX package; ``--mm-method``,
``--polarizable-mm``, ``--rigid-water`` and ``--write-solvent`` act only on
solvated runs.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ai2bmd-torch",
        description="ab initio biomolecular dynamics, PyTorch + CUDA port")
    p.add_argument("--base-dir", type=str, default=os.getcwd(),
                   help="directory for running the simulation")
    p.add_argument("--log-dir", type=str, default=None,
                   help="directory for results (default: <base>/Logs-<prot>)")
    p.add_argument("--ckpt-path", type=str, default=None,
                   help="ViSNet checkpoint: a Lightning .ckpt or a converted .npz; random "
                        "init when absent")
    p.add_argument("--ckpt-type", type=str, default=None,
                   help="checkpoint md5 id (reference compatibility; joined "
                        "with --ckpt-path as visnet-uni-<id>.ckpt)")
    p.add_argument("--prot-file", type=str, required=True)
    p.add_argument("--temp-k", type=int, default=300)
    p.add_argument("--timestep", type=float, default=1.0)
    p.add_argument("--sim-steps", type=int, default=1000)
    p.add_argument("--preeq-steps", type=int, default=2000)
    p.add_argument("--max-cyc", type=int, default=100,
                   help="max minimization cycles in preprocessing")
    p.add_argument("--constraints", action=argparse.BooleanOptionalAction,
                   default=False, help="constrain hydrogen bonds")
    p.add_argument("--solvent", action=argparse.BooleanOptionalAction, default=None,
                   help="explicit-solvent QM/MM (default: when the input has water or ions)")
    p.add_argument("--write-solvent", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--preprocess-method", type=str, default="FF19SB",
                   choices=["FF19SB", "AMOEBA"],
                   help="preprocessing pipeline (AMOEBA: minimization of the box with the "
                        "whole AMOEBA force field)")
    p.add_argument("--preprocess", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="solvate+equilibrate raw inputs (default: when the "
                        "input has no water and --solvent is requested)")
    p.add_argument("--mm-method", type=str, default="mm-engine",
                   choices=["mm-engine", "amoeba", "tinker", "tinker-GPU"],
                   help="solvent MM engine (solvated runs only)")
    p.add_argument("--polarizable-mm", action=argparse.BooleanOptionalAction,
                   default=False, help="polarizable solvent MM (solvated runs only)")
    p.add_argument("--rigid-water", action=argparse.BooleanOptionalAction,
                   default=False, help="SETTLE rigid waters (solvated runs only)")
    p.add_argument("--mode", type=str, default="fragment",
                   choices=["fragment", "visnet"])
    p.add_argument("--fragment-longrange-calc", type=str, default="mm",
                   choices=["mm", "pme"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restart", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--build-frames", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--record-per-steps", type=int, default=100)
    p.add_argument("--device-strategy", type=str, default=None,
                   help="(reference compatibility; no-op)")
    p.add_argument("--work-strategy", type=str, default=None,
                   help="(reference compatibility; no-op)")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="(reference compatibility; no-op)")
    p.add_argument("--mesh-dp", type=int, default=1,
                   help="replica-ensemble mesh axis size (more than one card: ROADMAP item 17)")
    p.add_argument("--mesh-mp", type=int, default=1,
                   help="fragment-sharding mesh axis size (more than one card: ROADMAP "
                        "item 17)")
    p.add_argument("--replicas", type=int, default=1,
                   help="number of ensemble replicas (>1 runs the replica-batched ensemble)")
    p.add_argument("--matmul-precision", type=str, default="float32",
                   choices=["float32", "bfloat16", "tensorfloat32"],
                   help="only float32: the port's products are float32 or 3xTF32")
    p.add_argument("--opt-iters", type=int, default=10,
                   help="cap-hydrogen L-BFGS iterations per step (stateless path)")
    p.add_argument("--model-preset", type=str, default="production",
                   choices=["production", "tiny"],
                   help="tiny = 2x32 debug model (smoke tests without a "
                        "checkpoint)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the run goes: the card (default; raises without one) or "
                        "the CPU, through the kernels' plain versions")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.matmul_precision != "float32":
        parser.error("--matmul-precision: the port runs float32 only (its products are "
                     "float32 or 3xTF32 by design)")

    logging.basicConfig(
        level=[logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)],
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("ai2bmd-torch")

    from ai2bmd_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    for flag in ("device_strategy", "work_strategy", "chunk_size"):
        if getattr(args, flag) is not None:
            log.info("--%s is a reference option with no effect here; ignored",
                     flag.replace("_", "-"))

    prot_name = os.path.basename(args.prot_file).rsplit(".", 1)[0]
    log_dir = args.log_dir or os.path.join(args.base_dir, f"Logs-{prot_name}")
    os.makedirs(log_dir, exist_ok=True)

    # tee all output into a timestamped logfile (reference main.py:27-28)
    from ai2bmd_torch.utils.logging_utils import tee_output, untee_output
    from ai2bmd_torch.utils.signals import register_print_stack_on_sigusr2

    tee_output(log_dir, prot_name)
    try:
        # opt-in hang debugging: kill -USR2 <pid> dumps all thread stacks
        register_print_stack_on_sigusr2(out_dir=log_dir)
        return _run(args, device, prot_name, log_dir, log)
    finally:
        untee_output()


def _run(args, device, prot_name: str, log_dir: str, log) -> int:
    ckpt = args.ckpt_path
    if ckpt and args.ckpt_type:
        ckpt = os.path.join(ckpt, f"visnet-uni-{args.ckpt_type}.ckpt")

    needs_preprocess = args.preprocess
    if needs_preprocess is None:
        needs_preprocess = bool(args.solvent) and not _is_solvated(args.prot_file)
    if needs_preprocess:
        from ai2bmd_torch.preprocess import Preprocessor

        pre = Preprocessor(log_dir=log_dir, max_cyc=args.max_cyc, seed=args.seed,
                           method=args.preprocess_method, device=device)
        args.prot_file = pre.run(args.prot_file)     # the run goes on with the box

    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.simulators import ProteinSimulation

    sim_cfg = SimulationConfig(
        timestep_fs=args.timestep,
        temp_K=float(args.temp_k),
        record_per_steps=args.record_per_steps,
        seed=args.seed,
        preeq_steps=args.preeq_steps,
        hydrogen_constraints=args.constraints,
    )

    model_cfg = None
    if args.model_preset == "tiny":
        from ai2bmd_torch.models.visnet import ViSNetConfig

        model_cfg = ViSNetConfig(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)

    if args.replicas > 1 or args.mesh_mp > 1:
        return _run_ensemble(args, device, ckpt, log_dir, model_cfg, log)

    sim = ProteinSimulation.from_pdb(
        args.prot_file,
        log_dir=log_dir,
        mode=args.mode,
        longrange=args.fragment_longrange_calc,
        solvent=args.solvent,
        write_solvent=args.write_solvent,
        ckpt_path=ckpt,
        model_cfg=model_cfg,
        sim_cfg=sim_cfg,
        opt_iters=args.opt_iters,
        polarizable_mm=args.polarizable_mm,
        rigid_water=args.rigid_water,
        mm_backend="amoeba" if args.mm_method == "amoeba" else "ff19sb",
        device=device,
    )
    print(_model_line(sim.potential.cfg, device), flush=True)
    if sim.qmmm is not None:
        print(f"QM/MM: {sim.qmmm.n_atoms} atoms in the box, {len(sim.qmmm.sel)} in the QM "
              f"region; {sim.qmmm.backend} pairs, {sim.qmmm.engine} MM, PME mesh {sim.qmmm.mesh}"
              f"{', rigid water (SETTLE)' if sim.sim.constraint is not None else ''}", flush=True)
    try:
        sim.simulate(args.sim_steps, restart=args.restart)
    except Exception as exc:  # the reference exits -1 on runaway / solver errors
        log.exception("%s", exc)
        return 255

    if args.build_frames and not args.restart:
        _build_frames(log_dir, prot_name)
    return 0


def _model_line(cfg, device) -> str:
    """The model and the kernels its layers run on ``device``."""
    if device.type != "cuda":
        path = "plain versions on the CPU"
    elif cfg.plain_edge_core:
        path = f"the plain edge core on the card ({cfg.activation!r}/{cfg.attn_activation!r})"
    elif cfg.fused_layer:
        path = "full-layer kernels K5/K6"
    else:
        path = "edge-core kernels K1, K7/K8 (remat)" if cfg.remat else "edge-core kernels K1-K3"
    return (f"ViSNet {cfg.num_layers} x {cfg.hidden_channels}, {cfg.num_heads} heads: "
            f"{path}")


def _is_solvated(prot_file: str) -> bool:
    from ai2bmd_torch.host import load_protein

    prot = load_protein(prot_file)
    return len(prot.protein_indices()) < len(prot)


def _build_frames(log_dir: str, prot_name: str):
    """Split the xyz trajectory into per-frame files (reference
    build_frames_from_traj, simulator.py:205-223) under <log>/frames and
    copy the joined trajectory into <log>/results."""
    import shutil

    traj = os.path.join(log_dir, f"{prot_name}-traj.xyz")
    if not os.path.exists(traj):
        return
    frames_dir = os.path.join(log_dir, "frames")
    results_dir = os.path.join(log_dir, "results")
    os.makedirs(frames_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)
    with open(traj) as f:
        lines = f.read().splitlines(keepends=False)
    i = frame = 0
    while i < len(lines):
        n = int(lines[i].strip())
        block = lines[i:i + 2 + n]
        step = block[1].split("step=")[1].split()[0] if "step=" in block[1] else frame
        with open(os.path.join(frames_dir, f"structure{int(step):0>5}.xyz"), "w") as f:
            f.write("\n".join(block) + "\n")
        i += 2 + n
        frame += 1
    shutil.copy(traj, results_dir)


def _mesh_devices(args, device) -> int:
    """Cards the JAX CLI's mesh arithmetic (cli.py:280-282) would use."""
    import torch

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    n_dp = min(args.mesh_dp, n_dev)
    n_mp = args.mesh_mp if args.mesh_dp * args.mesh_mp == n_dev else n_dev // n_dp
    return n_dp * n_mp


def _run_ensemble(args, device, ckpt, log_dir, model_cfg, log) -> int:
    """Replica-ensemble MD on one card (the JAX CLI's single-card branches,
    cli.py:284-317): independent Langevin trajectories, of fragment mode with
    the "mm" long range and a replica-batched force evaluation for a vacuum
    input (``--mode`` and ``--fragment-longrange-calc`` do not apply, as in
    the JAX package), of solvated QM/MM (``SolvatedReplicaEnsemble``) for a
    solvated one.  Every replica records its own DCD, and the whole ensemble
    state is checkpointed each record interval (``--restart`` resumes it,
    writing ``-restart`` trajectories)."""
    import numpy as np

    from ai2bmd_torch.host import build_fragment_index, load_protein
    from ai2bmd_torch.io.trajectory import DCDTrajectory
    from ai2bmd_torch.parallel import ReplicaEnsemble, SolvatedReplicaEnsemble
    from ai2bmd_torch.simulators import load_model

    n_cards = _mesh_devices(args, device)
    if n_cards > 1:
        raise NotImplementedError(
            f"an ensemble mesh over {n_cards} cards is not ported yet (ROADMAP.md, Queue 1 "
            f"item 17); the port's ensembles run on one card")
    prot_name = os.path.basename(args.prot_file).rsplit(".", 1)[0]
    full = load_protein(args.prot_file)
    solvated = len(full.protein_indices()) < len(full)
    if solvated and args.solvent is False:
        # --no-solvent: the protein alone, in vacuum, as the lone route runs it
        full, solvated = full.select(full.protein_indices()), False
    params, cfg = load_model(ckpt, model_cfg, seed=args.seed)
    log.info("replica ensemble on %s: %d replicas", device, args.replicas)
    common = dict(n_replicas=args.replicas, timestep_fs=args.timestep,
                  temp_K=float(args.temp_k), steps_per_call=args.record_per_steps,
                  warm_iters=1, device=device)
    if solvated:
        if args.polarizable_mm:
            # JAX's ensemble route never passes the flag on (ai2bmd_tpu/cli.py:295-302)
            log.warning("solvated ensembles run the fixed-charge ff19sb engine (as the JAX "
                        "package's do); use --replicas 1 for --polarizable-mm")
        if args.mm_method == "amoeba":
            log.warning("solvated ensembles run the ff19sb engine (as the JAX package's do); "
                        "use --replicas 1 for --mm-method amoeba")
        ens = SolvatedReplicaEnsemble.build(full.atoms, params, cfg, **common)
        q = ens.qmmm
        print(f"QM/MM: {q.n_atoms} atoms in the box, {len(q.sel)} in the QM region; "
              f"{q.backend} pairs, PME mesh {q.mesh}; {args.replicas} replicas",
              flush=True)
    else:
        ens = ReplicaEnsemble.build(full, build_fragment_index(full.atoms), params, cfg,
                                    **common)

    ckpt_path = f"{log_dir}/{prot_name}-{args.replicas}x-ensemble-restart.npz"
    state = ens.initial_state(full.positions, temp_K=float(args.temp_k), seed=args.seed)
    suffix = ""
    if args.restart and os.path.exists(ckpt_path):
        state = _load_ensemble_restart(ckpt_path, state, ens)
        # continuation trajectories get a -restart suffix (as a lone
        # trajectory's restart does)
        suffix = "-restart"

    trajs = [
        DCDTrajectory(f"{log_dir}/{prot_name}-r{i:03d}-traj{suffix}.dcd", len(full),
                      timestep_fs=args.timestep, save_interval=args.record_per_steps,
                      cell=full.cell if solvated else None)
        for i in range(args.replicas)
    ]
    n_calls = max(1, (args.sim_steps - state.step) // args.record_per_steps)
    try:
        for _ in range(n_calls):
            state = ens.run(state, 1)
            pos = state.positions.cpu().numpy()
            e = state.energy.cpu().numpy()
            for traj, p in zip(trajs, pos):
                traj.write(p)
            _save_ensemble_restart(ckpt_path, state, ens.generators)
            print(f"Step {state.step}: Epot mean = {e.mean():.3f}eV "
                  f"(min {e.min():.3f}, max {e.max():.3f})", flush=True)
    finally:
        for traj in trajs:
            traj.close()
    out = f"{log_dir}/{args.replicas}x-ensemble-final.npz"
    np.savez(out, positions=state.positions.cpu().numpy(),
             velocities=state.velocities.cpu().numpy())
    print(f"wrote {out} + {len(trajs)} per-replica DCDs")
    return 0


_ENSEMBLE_FIELDS = ("positions", "velocities", "forces", "energy")


def _ensemble_arrays(state) -> dict:
    """The batched MDState's tensors by name; the carry leaf by leaf
    (``aux_0``, ``aux_1``, ...: the cap offsets, or a solvated replica's cell
    buckets and cap offsets)."""
    from ai2bmd_torch.utils.tree import tree_leaves

    return {**{k: getattr(state, k) for k in _ENSEMBLE_FIELDS},
            **{f"aux_{i}": leaf for i, leaf in enumerate(tree_leaves(state.aux))}}


def _save_ensemble_restart(path: str, state, generators):
    """Checkpoint every tensor of the batched MDState, its step, and each
    replica's generator state, so an interrupted ensemble resumes where it
    stopped."""
    import numpy as np

    np.savez(
        path + ".tmp.npz",
        step=np.asarray(state.step),
        rng_states=np.stack([g.get_state().numpy() for g in generators]),
        **{k: t.cpu().numpy() for k, t in _ensemble_arrays(state).items()},
    )
    os.replace(path + ".tmp.npz", path)


def _load_ensemble_restart(path: str, template, ens):
    import numpy as np
    import torch

    from ai2bmd_torch.md.langevin import MDState
    from ai2bmd_torch.utils.tree import tree_unflatten

    want = _ensemble_arrays(template)
    with np.load(path) as z:
        saved = sorted(k for k in z.files if k not in ("rng_states", "step"))
        if saved != sorted(want):
            raise ValueError(f"ensemble restart {path} holds {saved}, expected {sorted(want)} "
                             f"(a checkpoint of another route?)")
        arrays = {k: z[k] for k in z.files}
    for k, t in want.items():
        if arrays[k].shape != tuple(t.shape):
            raise ValueError(f"ensemble restart {path}: {k} has shape {arrays[k].shape}, "
                             f"expected {tuple(t.shape)} (different replica count or protein?)")
    if len(arrays["rng_states"]) != len(ens.generators):
        raise ValueError(f"ensemble restart {path} holds {len(arrays['rng_states'])} generator "
                         f"states for {len(ens.generators)} replicas")
    for g, s in zip(ens.generators, arrays["rng_states"]):
        g.set_state(torch.from_numpy(s.copy()))
    t = {k: torch.as_tensor(arrays[k], dtype=tmpl.dtype, device=tmpl.device)
         for k, tmpl in want.items()}
    aux = tree_unflatten(template.aux, [v for k, v in t.items() if k.startswith("aux_")])
    state = MDState(step=int(arrays["step"]), aux=aux, **{k: t[k] for k in _ENSEMBLE_FIELDS})
    print(f"resumed ensemble from {path} at step {state.step}", flush=True)
    return state


if __name__ == "__main__":
    sys.exit(main())
