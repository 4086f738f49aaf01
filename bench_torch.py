"""Benchmark of the PyTorch + CUDA port: Chignolin fragment-mode MD
throughput on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card:

    python3 bench_torch.py

Prints ONE JSON line with the keys of ``bench.py`` (the JAX package's bench,
which stays as it is): ``metric``, ``value`` (ns/day = 86.4 / ms per step),
``unit``, ``vs_baseline`` (ns/day over ``bench.py``'s estimate of the
reference, 3.5 ns/day) and ``ms_per_step_f32``; and beside them:
``ms_per_step_eager`` (the same workload issued step by step from Python),
``ms_per_step_fused_layer`` (the full-layer kernels K5/K6 through the graph)
and its eager twin, ``device_busy_share_*`` and ``kernels_per_step_*`` of
each graphed path (from a profiler window of replays), and the card's
``device`` and ``power_limit`` as ``nvidia-smi`` reports them.  With
``AI2BMD_BENCH_MIXED`` set (bench.py's variable) it also times the same step
in the mixed-precision mode, ``ViSNetConfig(edge_dtype=torch.bfloat16)``
(the bfloat16 instantiations of K1-K3), and adds bench.py's
``ms_per_step_mixed`` and ``ns_day_mixed`` with the path's eager, kernel and
busy figures; without it the output is as it was.

Workload, as ``bench.py``: Chignolin (``examples/chig.pdb``), the production
``ViSNetConfig()`` (9 layers x 256, 8 heads, lmax 2, 5 A cutoff) with the
port's ``init_params`` from seed 0 (random weights: the step's cost does not
depend on them, so its cost, not its values, compares with the JAX bench),
``FragmentPotential(longrange="mm")``, caps cold-started (10 L-BFGS
iterations), then warm (1 iteration a step), Langevin at 1 fs, 300 K,
0.001 / fs.

Method: the Langevin step is captured as one CUDA graph
(``ai2bmd_torch.md.GraphedLangevin``; the noise is drawn outside it, before
each replay), and STEPS replays are timed with CUDA events, best of REPEATS,
as ``bench.py`` times one compiled scan of STEPS steps.  Float32 throughout
(TF32 off; the edge kernels' products are 3xTF32, within float32's error).
Runs only on the card: without one it raises.  Imports no JAX.

``python3 bench_torch.py --solvated`` times the solvated Chignolin step
instead (``examples/chig_preprocessed/chig-preeq.pdb``, 17,882 atoms:
subtractive QM/MM, the QM side the same 9 x 256 fragment potential, the MM
side the ff19SB engine with cell-bucket pairs and PME), graphed, 1 fs,
flexible water, and prints one JSON line with ``ms_per_step``, ``ns_day``,
``kernels_per_step``, ``device_busy_share``, ``peak_memory_gib``,
``device`` and ``power_limit``.  Random weights would blow the box up
within ~100 steps, so the script (not the library) applies the JAX
package's benchmark stabilizers (``ai2bmd_tpu/simulators.py:41-83``): the
output head scaled by HEAD_SCALE, and the protein's own MM term added back,
which makes the step classical MD of the whole box while every production
term still runs (plus one protein-sized MM evaluation).  It readies the
first benchmark cell of solvated runs and claims nothing.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

BASELINE_NS_DAY = 3.5          # bench.py:42
STEPS = 200
REPEATS = 3
EAGER_STEPS = 20
PROFILE_STEPS = 3
SOLVATED = "examples/chig_preprocessed/chig-preeq.pdb"
HEAD_SCALE = 1e-30             # AI2BMD_RANDOM_HEAD_SCALE of the JAX package's e2e bench


def _events_ms(torch, fn, n):
    """Mean device-stream ms of n calls of fn(), by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _profile(torch, fn, n):
    """(device kernels per call, device busy share) over n calls of fn(),
    from a torch.profiler (CUPTI) trace: device time summed over the
    window's device events, over its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(events) / n, sum(e.device_time_total for e in events) / wall_us


def solvated(torch, dev, name, power_limit):
    """The graphed solvated step with the benchmark stabilizers; one JSON line."""
    from ai2bmd_torch.host import load_protein
    from ai2bmd_torch.md import GraphedLangevin
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.physics.qmmm import QMMMPotential
    from ai2bmd_torch.potentials import FragmentPotential

    full = load_protein(SOLVATED)
    prot = full.select(full.protein_indices())
    cfg = ViSNetConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    params["std"] = params["std"] * HEAD_SCALE            # stabilizer 1: the scaled head
    params["atomref"] = params["atomref"] * HEAD_SCALE
    pot = FragmentPotential.build(prot, ViSNet(cfg, params), cfg, device=dev)
    P_prot = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    qmmm = QMMMPotential.build(
        full.atoms, qm_stateful=lambda P, a: pot.stateful_energy_forces(P, a, warm_iters=1),
        qm_init_aux=pot.init_cap_delta(P_prot), device=dev)

    def potential(P, aux):                                # stabilizer 2: protein MM re-added
        e, f, aux = qmmm(P, aux)
        e1, f1 = qmmm.mm_prot_energy_forces(P[qmmm.sel])
        return e + e1, f.index_add(0, qmmm.sel, f1), aux

    P = torch.as_tensor(full.positions, dtype=torch.float32, device=dev)
    masses = torch.as_tensor(full.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(full.masses, 1.0, 300.0, 0.001, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    e0, f0, aux0 = potential(P, qmmm.init_aux(P))
    state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, full.masses, 300.0), f0, e0,
                      aux=aux0)
    torch.cuda.reset_peak_memory_stats()
    graphed = GraphedLangevin(potential, coeffs, masses, state, gen)
    graphed.run(1)
    times = [_events_ms(torch, lambda: graphed.run(1), STEPS) for _ in range(REPEATS)]
    s = graphed.state
    if not bool(torch.isfinite(s.positions).all() and torch.isfinite(s.energy)):
        raise RuntimeError(f"solvated: non-finite state after {s.step} graphed steps")
    if bool(s.aux[0].overflow):
        raise RuntimeError("solvated: a cell overflowed its bucket")
    kernels, busy = _profile(torch, lambda: graphed.run(1), PROFILE_STEPS)
    ms = min(times)
    print(json.dumps({
        "metric": "ns/day solvated Chignolin 17,882-atom QM/MM MD (ViSNet 9x256 f32 QM, "
                  "ff19SB + TIP3P + PME MM, 1 fs, PyTorch + CUDA port, one step as one CUDA "
                  "graph, single GPU; random weights with the benchmark stabilizers)",
        "ms_per_step": ms,
        "ns_day": 86.4 / ms,
        "kernels_per_step": kernels,
        "device_busy_share": busy,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "steps": STEPS,
        "repeats": REPEATS,
        "device": name,
        "power_limit": power_limit,
    }))


def main():
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ai2bmd_torch.utils.device import require_cuda

    dev = require_cuda()
    from ai2bmd_torch.host import example_pdb, load_protein
    from ai2bmd_torch.md import GraphedLangevin
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.potentials import FragmentPotential

    name, power_limit = [s.strip() for s in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].split(",")]
    if "--solvated" in sys.argv[1:]:
        return solvated(torch, dev, name, power_limit)
    prot = load_protein(example_pdb("chig"))
    cfg = ViSNetConfig()                       # production config: 9 layers x 256
    params = init_params(cfg, torch.Generator().manual_seed(0))
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device=dev)

    out = {}
    paths = [("f32", {}), ("fused_layer", dict(fused_layer=True))]
    if os.environ.get("AI2BMD_BENCH_MIXED"):
        paths.append(("mixed", dict(edge_dtype=torch.bfloat16)))
    for label, kw in paths:
        c = dataclasses.replace(cfg, **kw)
        pot = FragmentPotential.build(prot, ViSNet(c, params), c, longrange="mm", device=dev)
        warm = lambda P, aux, pot=pot: pot.stateful_energy_forces(P, aux, warm_iters=1)
        gen = torch.Generator(device=dev).manual_seed(0)
        vel = L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0)
        e0, f0, aux0 = warm(P, pot.init_cap_delta(P))
        state = L.MDState(P, vel, f0, e0, aux=aux0)

        # the same steps issued eagerly from Python, for comparison
        eager = {"s": state}
        step = lambda: eager.update(s=L.langevin_step(warm, coeffs, masses, eager["s"],
                                                      generator=gen))
        step()
        out["ms_per_step_eager" + ("" if label == "f32" else "_" + label)] = _events_ms(
            torch, step, EAGER_STEPS)

        graphed = GraphedLangevin(warm, coeffs, masses, eager["s"], gen)
        graphed.run(1)
        times = [_events_ms(torch, lambda: graphed.run(1), STEPS) for _ in range(REPEATS)]
        s = graphed.state
        if not bool(torch.isfinite(s.positions).all() and torch.isfinite(s.energy)):
            raise RuntimeError(f"{label}: non-finite state after {s.step} graphed steps")
        out[f"ms_per_step_{label}"] = min(times)
        kernels, busy = _profile(torch, lambda: graphed.run(1), PROFILE_STEPS)
        out[f"kernels_per_step_{label}"] = kernels
        out[f"device_busy_share_{label}"] = busy
        del graphed, pot

    ms = out["ms_per_step_f32"]
    ns_day = 86.4 / ms
    print(json.dumps({
        "metric": "ns/day Chignolin 175-atom fragment-mode MD (ViSNet 9x256 f32, 1 fs, "
                  "PyTorch + CUDA port, one step as one CUDA graph, single GPU; random init "
                  "weights; step cost is weight-independent)",
        "value": ns_day,
        "unit": "ns/day",
        "vs_baseline": ns_day / BASELINE_NS_DAY,
        **out,
        "ns_day_fused_layer": 86.4 / out["ms_per_step_fused_layer"],
        **({"ns_day_mixed": 86.4 / out["ms_per_step_mixed"]} if "ms_per_step_mixed" in out
           else {}),
        "steps": STEPS,
        "repeats": REPEATS,
        "device": name,
        "power_limit": power_limit,
    }))


if __name__ == "__main__":
    main()
