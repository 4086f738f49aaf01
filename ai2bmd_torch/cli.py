"""Command-line entry point of the PyTorch port: ``python -m ai2bmd_torch``.

Port of ``ai2bmd_tpu/cli.py:22-422``.  The parser has every option of the
JAX package's, with the same defaults and choices, and one more:
``--device {cuda,cpu}`` (default ``cuda``; the counterpart of the JAX CLI's
``JAX_PLATFORMS`` pin).  The run goes through ``resolve_device``, so without
a card and without ``--device cpu`` it raises; it never falls back to the
CPU, and on the card the MD loop is replays of one captured step.

Routes:
  * the vacuum paths (``ProteinSimulation``): fragment mode, and whole-molecule
    mode with ``--mode visnet``; a solvated input with ``--no-solvent`` runs
    its protein alone in vacuum; an exception during the simulation exits
    255, as the reference's runaway / solver errors do
  * ``--replicas > 1`` (or ``--mesh-mp > 1``): ``ReplicaEnsemble`` on one
    card, each replica with its own DCD, the whole batched state (and every
    replica's generator state) checkpointed each record interval
  * weights: ``--ckpt-path`` (a Lightning .ckpt, or a converted .npz; with
    ``--ckpt-type <id>`` the file ``<ckpt-path>/visnet-uni-<id>.ckpt``) on
    every route, else random weights; a file that is not a checkpoint exits
    nonzero naming it

Refused, naming the ROADMAP item that ports them: ``--fragment-longrange-calc
pme`` in fragment mode (item 12), explicit solvent (``--solvent``, or a
solvated input without ``--no-solvent``) and ``--replicas`` on a solvated
input, whatever ``--solvent`` says (item 13), ``--preprocess`` (item 14), a
mesh of more than one card (item 17), and
``--matmul-precision`` other than float32 (the port's products are float32
or 3xTF32 by design).  The reference's
``--device-strategy``, ``--work-strategy`` and ``--chunk-size`` are accepted
as no-ops, as in the JAX package; ``--mm-method``, ``--polarizable-mm``,
``--rigid-water`` and ``--write-solvent`` act only on solvated runs.
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
                   help="explicit-solvent QM/MM (default: auto-detect; ROADMAP item 13)")
    p.add_argument("--write-solvent", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--preprocess-method", type=str, default="FF19SB",
                   choices=["FF19SB", "AMOEBA"],
                   help="preprocessing pipeline (ROADMAP item 14)")
    p.add_argument("--preprocess", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="solvate+equilibrate raw inputs (default: when the "
                        "input has no water and --solvent is requested; ROADMAP item 14)")
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
        raise NotImplementedError(
            "--preprocess (solvate, minimize, heat, equilibrate) is not ported yet "
            "(ROADMAP.md, Queue 1 item 14)")

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
        ckpt_path=ckpt,
        model_cfg=model_cfg,
        sim_cfg=sim_cfg,
        opt_iters=args.opt_iters,
        device=device,
    )
    print(_model_line(sim.potential.cfg, device), flush=True)
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
    """Replica-ensemble MD on one card (the JAX CLI's ``n_mp == 1`` branch,
    cli.py:303-317): independent Langevin trajectories of fragment mode with
    the "mm" long range (``--mode`` and ``--fragment-longrange-calc`` do not
    apply, as in the JAX package) and a replica-batched force evaluation.  Every replica records its own DCD,
    and the whole ensemble state is checkpointed each record interval
    (``--restart`` resumes it, writing ``-restart`` trajectories)."""
    import numpy as np

    from ai2bmd_torch.host import build_fragment_index, load_protein
    from ai2bmd_torch.io.trajectory import DCDTrajectory
    from ai2bmd_torch.parallel import ReplicaEnsemble
    from ai2bmd_torch.simulators import load_model

    n_cards = _mesh_devices(args, device)
    if n_cards > 1:
        raise NotImplementedError(
            f"an ensemble mesh over {n_cards} cards is not ported yet (ROADMAP.md, Queue 1 "
            f"item 17); the port's ReplicaEnsemble runs on one card")
    prot_name = os.path.basename(args.prot_file).rsplit(".", 1)[0]
    full = load_protein(args.prot_file)
    if len(full.protein_indices()) < len(full):
        raise NotImplementedError(
            f"{args.prot_file} holds water or ions: solvated replica ensembles are not ported "
            f"yet (ROADMAP.md, Queue 1 item 13)")
    params, cfg = load_model(ckpt, model_cfg, seed=args.seed)
    log.info("replica ensemble on %s: %d replicas", device, args.replicas)
    ens = ReplicaEnsemble.build(
        full, build_fragment_index(full.atoms), params, cfg,
        n_replicas=args.replicas,
        timestep_fs=args.timestep,
        temp_K=float(args.temp_k),
        steps_per_call=args.record_per_steps,
        warm_iters=1,
        device=device,
    )

    ckpt_path = f"{log_dir}/{prot_name}-{args.replicas}x-ensemble-restart.npz"
    state = ens.initial_state(full.positions, temp_K=float(args.temp_k), seed=args.seed)
    suffix = ""
    if args.restart and os.path.exists(ckpt_path):
        state = _load_ensemble_restart(ckpt_path, state, ens, log)
        # continuation trajectories get a -restart suffix (as a lone
        # trajectory's restart does)
        suffix = "-restart"

    trajs = [
        DCDTrajectory(f"{log_dir}/{prot_name}-r{i:03d}-traj{suffix}.dcd", len(full),
                      timestep_fs=args.timestep, save_interval=args.record_per_steps)
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


_ENSEMBLE_FIELDS = ("positions", "velocities", "forces", "energy", "aux")


def _save_ensemble_restart(path: str, state, generators):
    """Checkpoint every tensor of the batched MDState, its step, and each
    replica's generator state, so an interrupted ensemble resumes where it
    stopped."""
    import numpy as np

    np.savez(
        path + ".tmp.npz",
        step=np.asarray(state.step),
        rng_states=np.stack([g.get_state().numpy() for g in generators]),
        **{k: getattr(state, k).cpu().numpy() for k in _ENSEMBLE_FIELDS},
    )
    os.replace(path + ".tmp.npz", path)


def _load_ensemble_restart(path: str, template, ens, log):
    import numpy as np
    import torch

    from ai2bmd_torch.md.langevin import MDState

    with np.load(path) as z:
        arrays = {k: z[k] for k in (*_ENSEMBLE_FIELDS, "rng_states", "step")}
    for k in _ENSEMBLE_FIELDS:
        want = tuple(getattr(template, k).shape)
        if arrays[k].shape != want:
            raise ValueError(f"ensemble restart {path}: {k} has shape {arrays[k].shape}, "
                             f"expected {want} (different replica count or protein?)")
    if len(arrays["rng_states"]) != len(ens.generators):
        raise ValueError(f"ensemble restart {path} holds {len(arrays['rng_states'])} generator "
                         f"states for {len(ens.generators)} replicas")
    for g, s in zip(ens.generators, arrays["rng_states"]):
        g.set_state(torch.from_numpy(s.copy()))
    t = {k: torch.as_tensor(arrays[k], dtype=getattr(template, k).dtype,
                            device=getattr(template, k).device) for k in _ENSEMBLE_FIELDS}
    state = MDState(step=int(arrays["step"]), **t)
    log.info("resumed ensemble from %s at step %d", path, state.step)
    return state


if __name__ == "__main__":
    sys.exit(main())
