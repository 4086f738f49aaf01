#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ai2bmd_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and the final line
is not printed):

  1. environment: torch / CUDA / nvcc / triton versions and the card;
     a machine without a CUDA device stops here
  2. build the kernels from ai2bmd_torch/ops/csrc with nvcc, one process per
     source, all started together
  3. each kernel (K1 edge_fwd in all four flag pairs, K2 edge_bwd_msg,
     K3 edge_bwd_upd, K4 cap_grad, K5 vislayer_fwd and K6 vislayer_bwd for
     both values of `last`, K7 edge_bwd_msg_rc, K8 edge_bwd_upd_rc) against
     its plain PyTorch version on the card at the main path's shapes: max
     abs / relative error against a stated tolerance, bitwise repeatability,
     times in turns (CUDA events per call, and device time from a profiler
     trace, kept only when every kernel name holds the events of the calls
     traced), and the share of the bound (the larger of bytes over 3.35 TB/s
     and FLOPs over the peak of the unit that does the products: 165 TFLOP/s
     for the 3xTF32 tensor-core products of K1-K3 and K5-K8, 67 TFLOP/s of
     float32 FMA for K4); K3/K8 sum their g_edge into a copy of a
     message-path g_edge; K3, K5, K6 and K8 with device ms by stage
     (kernel name) at every shape and summed over the shapes; K7/K8 also
     against K2/K3 on K1's stash of the same inputs (bitwise equal), and K3,
     K7 and K8 again at one ensemble chunk's batch sizes (8 x the
     single-protein B); K4 also
     over 64 replicas' rows, each replica perturbed on its own, against its
     plain version and against launches over each replica alone, with its
     design (slots per atom in its per-atom lists), its device time at the
     lone shape and over the 64 replicas, and a sha256 of its output bytes
     on these fixed inputs (`--cap-hash` prints only those, so that the
     script can be run against another commit's package).  Before
     them: the tensor-core product helper alone (tf32x3_mm) against its
     plain model and a float64 product, and the rate of the mma.sync
     instruction it is built on; after them: shared memory, blocks per SM,
     registers and spills of K1/K2/K7 and of each K3/K8/K5/K6 stage at each
     slot count, and a yardstick that no kernel uses: cuBLAS float32 running
     only the products of K1, K2, K3, K5, K6, K7 and K8.  Then K1 (four flag
     pairs), K2, K3, K7 and K8 at the whole-molecule shapes (B = 1, A = 176,
     288 and 752: Chignolin, Trp-cage and abd as one molecule), where the centre
     passes walk their sources in chunks of 48 rows: the same checks
     (tolerance, bitwise repeats, K7/K8 against K2/K3 on K1's stash, device
     ms, bound and share) and the chunked passes' occupancy and grid fill;
     K5 and K6 (both `last`) at the same shapes, before them (the profiler's
     device times fail for the rest of a process from K7 at A = 752 on);
     and K1 (four flag pairs), K2, K3, K7, K8, K5 and K6 at heads of 8, 16
     and 64 channels (H = 32, 64 and 256 with 4 heads, B x A = 4 x 40 and
     1 x 176) against their plain versions and for bitwise repeats.
     `--edge-hash` prints only the sha256 of K1, K2, K3, K7 and K8's outputs
     on phase 3's fixed fragment-shape inputs, and `--layer-hash` those of
     K5 and K6, so that the script can be run against another commit's
     package (the chunked kernels and the head-width template must give the
     parent's bits at A <= 48 and 32-channel heads)
  4. the slice through the edge-core kernels K1-K3: Chignolin, production
     ViSNet (9 x 256, random weights from seed 0), FragmentPotential("mm"),
     cold caps (10 L-BFGS iterations), then warm Langevin steps at 1 fs /
     300 K; launch counters reset just before and read just after; step 0
     held against the same port on the CPU in float64 through the plain
     versions (limit 1e-3 eV/A); a profiled window of 3 steps gives the
     device busy share.  Then the warm step captured as one CUDA graph
     (ai2bmd_torch.md.GraphedLangevin) from the eager run's state: the
     capture's peak memory; its first 5 replays held against eager steps
     from the same state on the same noise (max|dx|, max|dF| within 1e-3);
     TIMED_STEPS replays timed; a profiled window of 3 replays (kernels per
     step, busy share) whose trace must name cap_grad_kernel and K1-K3's
     kernels; energies and positions finite
  4b. the same slice through the full-layer kernels K5/K6
     (AI2BMD_FUSED_LAYER=1): every ViSNet layer of every batch launches K5
     and K6 once per force evaluation and K1-K3 never; step 0 held against
     phase 4's step 0 and against the CPU float64 run; then the graphed step
     as in phase 4, its replay trace naming cap_grad_kernel and K5/K6's
     kernels
  5. the replica ensemble (BASELINE config 5): ReplicaEnsemble of 64
     Chignolin replicas at 9 x 256 with ViSNetConfig(remat=True), chunks of
     8 replicas; initial state (cold caps, first forces) and 1 + 3 batched
     Langevin steps with the launch counters reset just before and read
     just after: per force evaluation K1 and K7 launch 8 chunks x 4 batches
     x 9 layers times and K8 x 8 layers, K2/K3 never; every replica's
     initial forces held against phase 4's step 0; one chunk run with
     remat=True and remat=False, forces compared and peak device memory
     printed; ms per step and per replica-step (smoke figures)
  6. the user-facing path, at 9 x 256 with phase 4's weights: (a)
     ProteinSimulation.from_pdb("examples/chig.pdb") and simulate(40) after a
     ladder of 5 x 4 steps, recorded every 10, with the H-bond restraint:
     launch counters (K1-K4, from the cold start, warm-up and capture),
     replays (5 x 4 + 40), the first forces against phase 4's step 0, the
     first record interval after the ladder against eager steps from the
     same state and generator state, and again with every H-bond spring
     pulling (thresholds shortened in place), a profiled record interval
     naming cap_grad_kernel and K1-K3's kernels, the XYZ / DCD / metrics /
     restart files; (b) `python -m ai2bmd_torch` as subprocesses: a
     300-step timing run (its steady ms/step from its metrics CSV, beside
     phase 4's graphed figure; DCD against XYZ frames), 20 steps then
     --restart 10 against 30 straight with --constraints (positions and
     velocities within 1e-6, forces within 1e-3, the same generator
     state); (c)
     --replicas 8 (8 DCDs, the final npz).  These runs step at 0.05 fs (the
     timing run 0.01 fs): random weights heat vacuum Chignolin past the
     runaway guard within ~10-20 fs
  7. whole-molecule mode at 9 x 256: (a) phase 4's weights written by
     save_converted to build/chip_smoke_user/ and read back by load_model,
     every leaf bitwise equal; (b) Chignolin through ViSNetPotential (one
     molecule, A = 176): launch counters of one force evaluation (K1 9, K2
     9, K3 8, K4 0), step 0 against the port on the CPU in float64 (limit
     1e-3 eV/A), the Langevin step captured by GraphedLangevin, its first 5
     replays against eager steps on the same noise, TIMED_STEPS replays
     timed, a profiled window whose trace names K1-K3's kernels; (c)
     `python -m ai2bmd_torch --mode visnet --ckpt-path <that npz>` for 300
     steps at 0.01 fs (its steady ms/step beside (b)'s; the forces of its
     restart file against (b)'s potential at the same positions); (d) abd
     (A = 752), one force evaluation with remat=True (K1 without a stash,
     K7/K8) and one with remat=False (K1-K3), launch counters, peak device
     memory and max|dF| between them (limit 1e-3); (e) the same weights
     through the full-layer kernels K5/K6 (fused_layer): Chignolin's
     launches of one evaluation (K5 9, K6 9, nothing else), step 0 against
     (b)'s CPU float64 forces and (b)'s K1-K3 forces, the graphed step (5
     replays against eager steps, timed replays beside (b)'s, a trace
     naming K5/K6's stages), the CLI under AI2BMD_FUSED_LAYER=1 (its model
     line names K5/K6), and abd through K5/K6 (peak memory, max|dF| against
     (d)'s K1-K3 forces)
  8. the repaired faults: (a) ProteinSimulation.from_pdb with the CLI's
     tiny preset (heads of 8 channels) on the card, through K1-K3 and with
     AI2BMD_FUSED_LAYER=1 through K5/K6: launch counters, step 0 against the
     CPU float64 run, 3 graphed steps; (b) warm_caps=False at 9 x 256: the
     stateless step (a cold cap solve) captured, replays against eager
     steps, ms/step beside phase 4's; (c) `python -m ai2bmd_torch
     --no-solvent` on the solvated Chignolin box, 20 steps, the protein's
     175 atoms in its DCD
  9. the solvated slice at 9 x 256: (a) FragmentPotential(longrange="pme")
     on Chignolin's CRYST1 cell: launches of one evaluation, step 0 against
     the CPU float64 run, the graphed step against eager steps, ms/step
     beside phase 4's "mm"; (b) ProteinSimulation.from_pdb on the solvated
     Chignolin box (17,882 atoms, subtractive QM/MM, cell-bucket pairs,
     PME): build seconds, step 0 against the port on the CPU in float64
     (solvent atoms within 1e-3 eV/A, protein atoms within the float32
     spread of the subtractive combiner, 2e-2), launches of one evaluation,
     each part's device ms alone (QM, cell assignment, pairs, PME with the
     bonded terms, the protein MM), 5 graphed replays against eager steps,
     20 replays timed, a profiled window, peak memory; again with
     rigid_water=True (SETTLE's constraint violation after the steps); (c)
     the CLI on the box with and without --no-write-solvent (frames of
     17,882 and 175 atoms, steady ms/step); (d) a model of 4 heads of 64
     channels (2 x 256) through the kernels K1-K3, beside 8 heads of 32,
     and one with another activation than silu (tanh) through the explicit
     plain route: its log line, LAUNCHES["plain_edge_core"] > 0 there (and
     0 after every other phase); each with step 0 against the CPU float64
     run, 3 graphed steps and the ms of 20 replays
  10. preprocessing and solvated replicas, at 9 x 256 with phase 4's
     weights: (a) Preprocessor on examples/chig.pdb at the default padding
     with short stages (PRE_SHORT: 20 minimization cycles, 3 heat stages of
     20 steps, one NVT chunk of 500 steps, 20 NPT steps): the box's atoms,
     the energy before and after the minimization (it must fall), T after
     each heat stage, the NPT cell and <P>, ms per step of each stage (CUDA
     events), one dense MM evaluation at the minimized positions against
     the port on the CPU in float64 (solvent atoms within 1e-3 eV/A,
     protein atoms within PRE_PROTEIN_SPREAD, the float32 spread), the final
     state's pressure against the CPU float64 value (PRESSURE_REL of the
     virial's scale), NPT steps replayed from the captured step against
     eager steps on the same noise (1e-4 A after one step; after 5 the
     float32 residue of the excluded pairs' LJ has grown as between two
     eager runs, reported) (the stages are replays of captured steps); (b)
     `python -m
     ai2bmd_torch --prot-file examples/chig.pdb --solvent` with (a)'s outputs
     in --log-dir: the skip line and 4 solvated steps; (c)
     SolvatedReplicaEnsemble of 4 replicas of chig-preeq.pdb (cellpair):
     step-0 forces of every replica against phase 9b's lone step (1e-4
     eV/A), the capture's launches per evaluation equal to phase 9b's,
     replica r's first 5 steps against a lone GraphedLangevin on its
     generator (1e-4 A, 1e-3 eV/A), the replicas diverge, K1-K4's device
     kernels per replica-step in a trace equal to the lone replay's, ms per
     replica-step, aggregate ns/day, peak memory; (d) the CLI's --replicas 2
     on the box, 4 steps, then --restart to 8 (per-replica DCDs, the resume
     line)
  11. the polarizable routes on the solvated Chignolin box at 9 x 256, each
     one captured step through ProteinSimulation.from_pdb: (a)
     pair_backend="nl", its [N, K] list rebuilt inside the captured step by
     the cell build (the list build's device ms alone), step 0 against phase
     9b's cellpair forces and against the port on the CPU in float64 (9b's
     limits); (b) polarizable_mm=True (the induced-dipole hybrid), step 0
     against float64; (c) mm_backend="amoeba": the AMOEBA MM with the QM
     term at zero in float32 against float64 on the card, on the synthetic
     box of tests/test_qmmm_amoeba.py (within twice the JAX package's own
     float32 spread there, tools/amoeba_f32_spread.py) and on the solvated
     box (9b's limits), then the step; each route with the launches of one
     evaluation (K1-K4 on the QM side), each part captured alone (QM, the
     list build, the full box's MM, the protein's MM), 5 replays against
     eager steps, 10 replays timed, no overflow, peak memory, a trace of the
     full box's MM (kernels, the top 8 by device time); (d) the CLI
     on the box with --mm-method amoeba, then --polarizable-mm, 3 steps each
  12. AMOEBA preprocessing and pure-AMOEBA MD: (a) Preprocessor(method=
     "AMOEBA", max_cyc=AMOEBA_MAX_CYC) on examples/chig.pdb at the 10 A
     padding (3,615 atoms, cutoff 9 A, K = 576, 12 PCG iterations, each
     descent cycle a replay of one captured step): the box, the list and the
     mesh, each chunk's E and RMS |F| (E must fall), the stage's wall
     seconds, the ms of one captured cycle, peak memory, no overflow, both
     PDBs; (b) AmoebaMD's energy and forces in float32 against float64 on
     the card, on the ala2 box of tools/amoeba_md_f32_spread.py (within
     twice the JAX package's own float32 spread there) and on (a)'s box
     (FORCE_LIMIT); (c) AMOEBA_CHECK_CYCLES captured descent cycles against
     eager ones from the same state (the same decisions, positions within
     FORCE_LIMIT); (d) AMOEBA_MD_STEPS GraphedLangevin steps at 1 fs and
     300 K from the box (ms/step, finite, no overflow); (e) the CLI with
     --preprocess --preprocess-method AMOEBA --max-cyc AMOEBA_CLI_CYC on
     examples/chig.pdb (exit 0, the pair written, 2 solvated steps).  No
     kernel launches in this phase (no ViSNet on its path)
  13. one JSON line of kernel results, the card's name and power limit, and
     the final JSON line.

`--stop-after 2|3` ends after that phase, without the final line (for a
first check of a kernel change); `--solvated-only` runs phases 9 and 10
alone after the build, without it; `--polarizable-only` phase 11 alone;
`--amoeba-only` phase 12 alone; `--preprocess-full` runs only
Preprocessor() with its default stages on examples/chig.pdb (each stage's
wall seconds and ms per step), then the AMOEBA protocol at its default 100
cycles (wall seconds, ms per cycle), without it.  Phase 5 runs eagerly (no
graph).  Imports no JAX.  The ms/step figures it prints are smoke figures,
not a benchmark.
"""

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

SHAPES = [(2, 24), (4, 32), (4, 40), (9, 16)]   # Chignolin's (B, A) ViSNet batches
# Chignolin, Trp-cage and abd as one molecule, padded to 8 (abd's width, the
# largest the bundled proteins give, checks the source passes' loops too)
WHOLE_SHAPES = [(1, 176), (1, 288), (1, 752)]
H, NH, S = 256, 8, 8
CUTOFF = 5.0
# float32 sums of up to 2H = 512 products, taken in another order than the
# plain version's cuBLAS products, differ by ~1e-6 of the values' scale
EDGE_TOL = 1e-4
# analytic cap gradient against float32 autograd of the energy (the TPU
# kernel's bar against jax.grad was 2e-4 of the largest gradient)
CAP_TOL = 1e-4
FORCE_LIMIT = 1e-3          # eV/A, BASELINE.md:55-58
WARM_STEPS, TIMED_STEPS = 5, 20
GRAPH_CHECK_STEPS = 5       # replayed steps held against eager steps on the same noise
# kernels the replay trace of each path must name (besides K4's cap_grad_kernel)
EDGE_KERNELS = ("edge_fwd_kernel", "edge_bwd_msg_centre", "edge_bwd_upd_centre")
LAYER_KERNELS = ("vislayer_fwd_centre2", "vislayer_bwd_centre", "vislayer_bwd_source")
N_LAYERS = 9
N_REPLICAS, REPLICA_CHUNK, ENSEMBLE_STEPS = 64, 8, 3   # BASELINE config 5
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): float32 outside the
# tensor cores; TF32 in the tensor cores over the three passes of the 3xTF32
# split, in float32 products; HBM3.
PEAK_F32, PEAK_TF32X3, PEAK_BYTES = 67e12, 495e12 / 3, 3.35e12
# which unit does each kernel's products (bound(): tc = 3xTF32, f32 = FMA)
BOUND_PEAK = {
    "edge_fwd": "3xTF32 tensor cores, 165 TFLOP/s",
    "edge_bwd_msg": "3xTF32 tensor cores, 165 TFLOP/s",
    "edge_bwd_upd": "3xTF32 tensor cores, 165 TFLOP/s",
    "cap_grad": "float32 FMA, 67 TFLOP/s",
    "vislayer_fwd": "3xTF32 tensor cores, 165 TFLOP/s",
    "vislayer_bwd": "3xTF32 tensor cores, 165 TFLOP/s",
    "edge_bwd_msg_rc": "3xTF32 tensor cores, 165 TFLOP/s",
    "edge_bwd_upd_rc": "3xTF32 tensor cores, 165 TFLOP/s",
}


def need(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _trace(torch, fn, reps):
    """{kernel name: [events, device us]} of reps calls of fn() in one
    torch.profiler (CUPTI) trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n = out.setdefault(e.name, [0, 0.0])
            n[0] += 1
            n[1] += e.device_time_total
    return out


def device_ms(torch, fn, reps=10, by_name=None, tries=3):
    """Summed device time of the kernels fn() runs, per call, from a
    torch.profiler (CUPTI) trace of reps calls.  A trace can drop some of a
    kernel's events or all of them, so a trace of one call is taken first,
    and the trace of reps calls is kept only if it holds reps times as many
    events of each kernel name as that one and no other name; else both are
    taken again, up to ``tries`` times, then None.  ``by_name``, a dict,
    receives the ms per call of each kernel name."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        one, many = _trace(torch, fn, 1), _trace(torch, fn, reps)
        if one and one.keys() == many.keys() and all(
                many[n][0] == reps * c for n, (c, _) in one.items()):
            break
    else:
        return None
    if by_name is not None:
        for n, (_, us) in many.items():
            by_name[n] = by_name.get(n, 0.0) + us / 1e3 / reps
    return sum(us for _, us in many.values()) / 1e3 / reps


def short_name(kernel: str) -> str:
    """'void (anonymous namespace)::stage<false>(ai2bmd::Layer)' -> 'stage<false>'."""
    kernel = kernel.replace("(anonymous namespace)::", "").replace("ai2bmd::", "")
    m = re.search(r"(\w+(?:<[^(]*>)?)\(", kernel)
    return m.group(1) if m else kernel[:60]


def in_turns(torch, kernel, plain, parts=None, reps=20):
    """Per-call times of the kernel and its plain version, in turns (plain,
    kernel, kernel, plain): CUDA events around a loop of calls, which
    include the host's issue time when it exceeds the device's, and the
    device time alone from a profiler trace.  Returns a dict; ``parts``, a
    dict, receives the kernel's device ms by kernel name."""
    p1 = cuda_ms(torch, plain, reps)
    k1 = cuda_ms(torch, kernel, reps)
    k2 = cuda_ms(torch, kernel, reps)
    p2 = cuda_ms(torch, plain, reps)
    parts = {} if parts is None else parts
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "device_ms": device_ms(torch, kernel, min(reps, 10), by_name=parts),
           "plain_device_ms": device_ms(torch, plain, min(reps, 10))}
    print(f"    time per call: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms "
          f"(events); device: kernel {fmt_ms(out['device_ms'])}, plain "
          f"{fmt_ms(out['plain_device_ms'])}")
    if len(parts) > 1:
        print("    kernel stages (device ms): " + ", ".join(
            f"{short_name(n)} {ms:.4f}" for n, ms in parts.items()))
    return out


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def add_times(res, t):
    for key, val in t.items():
        if val is None or res.get(key, 0.0) is None:
            res[key] = None
        else:
            res[key] = res.get(key, 0.0) + val


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbyte, tc=0.0, f32=0.0):
    """The least time the card could take: the largest of the tensor-core
    FLOPs (3xTF32) over their peak, the float32 FMA FLOPs over theirs (the
    two units can run at once) and bytes (each input read once, each output
    written once) over the memory rate."""
    t_op = max(tc / PEAK_TF32X3, f32 / PEAK_F32) * 1e3
    t_by = nbyte / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_op, t_by), "bound_by": "operations" if t_op >= t_by else "bytes",
            "gflop": (tc + f32) / 1e9, "mbytes": nbyte / 1e6}


def add_bound(res, b, times=None):
    """Sum a call's bound, FLOPs and bytes into a kernel's result (bound_by:
    the larger part), and print the share of the bound the call reached."""
    for key in ("bound_ms", "gflop", "mbytes"):
        res[key] = res.get(key, 0.0) + b[key]
    res.setdefault("_by", {}).setdefault(b["bound_by"], 0.0)
    res["_by"][b["bound_by"]] += b["bound_ms"]
    if times is not None:
        dev = times.get("device_ms") or times["ms"]
        print(f"    bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['gflop']:.3f} GFLOP, "
              f"{b['mbytes']:.3f} MB); {100 * b['bound_ms'] / dev:.1f}% of bound at {dev:.4f} ms")


def finish(res):
    by = res.pop("_by", {"operations": 0.0})
    res["bound_by"] = max(by, key=by.get)
    res.setdefault("library_ms", None)       # no single PyTorch call computes these
    return res


def compare(name, got, ref, tol):
    """Max abs error of each output; raises past tol * max(1, max|ref|)."""
    worst = 0.0
    for label, g, r in zip(ref.keys(), got, ref.values()):
        if r is None:
            need(g is None, f"{name}: {label} should be absent")
            continue
        need(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)} != {tuple(r.shape)}")
        need(bool(g.isfinite().all()), f"{name}: {label} has non-finite values")
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        bound = tol * max(1.0, scale)
        print(f"    {label:9s} max|d| {err:.3e}  rel {err / max(scale, 1e-30):.3e}  "
              f"bound {bound:.3e}")
        need(err <= bound, f"{name}: {label} differs from the plain version by {err:.3e}")
        worst = max(worst, err)
    return worst


def bitwise(name, fn):
    a, b = fn(), fn()
    same = all((x is None and y is None) or bool((x == y).all()) for x, y in zip(a, b))
    print(f"    bitwise repeatable: {same}")
    need(same, f"{name}: two runs differ")


def edge_inputs(torch, gen, B, A, dev, H=H):
    from ai2bmd_torch.models.visnet import spherical_harmonics

    r = lambda *s, sc=0.3: (torch.randn(s, generator=gen) * sc).to(dev)
    pos = torch.randn((B, A, 3), generator=gen) * 2.5
    vec = pos[:, None] - pos[:, :, None]
    dist = vec.norm(dim=-1)
    eye = torch.eye(A, dtype=torch.bool)
    adj = ((dist < CUTOFF) | eye).float()
    unit = vec / dist.clamp(min=1e-6)[..., None] * (~eye)[..., None]
    w = lambda n_in, n_out: r(n_in, n_out, sc=(2.0 / (n_in + n_out)) ** 0.5)
    return dict(
        q=r(B, A, H), k=r(B, A, H), v=r(B, A, H), vec=r(B, A, S, H),
        edge=(r(B, A, A, H) * adj.to(dev)[..., None]).contiguous(),
        d_sh=spherical_harmonics(unit, 2).contiguous().to(dev),
        dist=dist.to(dev), adj=adj.to(dev),
        w_dkv=w(H, 2 * H), b_dkv=r(2 * H, sc=0.1), w_s=w(H, 2 * H), b_s=r(2 * H, sc=0.1),
        wt=r(B, A, S, H), wsrc=r(B, A, S, H), w_f=w(H, H), b_f=r(H, sc=0.1),
    )


MSG_KEYS = ("g_q", "g_k", "g_v", "g_vec", "g_edge", "g_d_sh", "g_dist")
UPD_KEYS = ("g_edge", "g_wt", "g_wsrc")


def edge_case(torch, K, gen, B, A, dev, H=H, NH=NH):
    """Inputs at (B, A) and width H with NH heads, K1's stash of them, random
    cotangents, and a random message-path g_edge for K3/K8 to sum into: the
    arguments of K2, K3, K7 and K8."""
    a = edge_inputs(torch, gen, B, A, dev, H)
    core = (a["q"], a["k"], a["v"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"],
            a["w_dkv"], a["b_dkv"], a["w_s"], a["b_s"], CUTOFF, NH)
    upd = dict(wt=a["wt"], wsrc=a["wsrc"], w_f=a["w_f"], b_f=a["b_f"])
    _, _, _, zdkv, zs, zf = K.edge_fwd(*core, **upd, store=True)
    g_x = (torch.randn((B, A, H), generator=gen)).to(dev)
    g_va = (torch.randn((B, A, S, H), generator=gen)).to(dev)
    g_df = (torch.randn((B, A, A, H), generator=gen) * a["adj"].cpu()[..., None]).to(dev)
    g_edge = (torch.randn((B, A, A, H), generator=gen) * a["adj"].cpu()[..., None]).to(dev)
    return dict(
        a=a, core=core, upd=upd, g_edge=g_edge,
        msg=(a["q"], a["k"], a["v"], a["vec"], zdkv, zs, a["d_sh"], a["dist"], a["adj"],
             a["w_dkv"], a["w_s"], g_x, g_va, CUTOFF, NH),
        upd_args=(a["adj"], a["wt"], a["wsrc"], a["w_f"], zf, g_df),
        msg_rc=(*core[:12], g_x, g_va, CUTOFF, NH),
        upd_rc=(a["edge"], a["adj"], a["wt"], a["wsrc"], a["w_f"], a["b_f"], g_df),
    )


def check_msg_rc(torch, K, c, B, A, results, timed):
    """K7 at (B, A) against its plain version and against K2 on K1's stash
    of the same inputs, bitwise repeats, times and bound (summed into the
    kernel's results when ``timed``)."""
    name, args = "edge_bwd_msg_rc", c["msg_rc"]
    label = f"{name} B={B} A={A}"
    print(f"  {label}")
    run = lambda: K.edge_bwd_msg_rc(*args)
    res = results[name]
    res["max_abs_err"] = max(res["max_abs_err"], compare(
        label, run(), dict(zip(MSG_KEYS, K.edge_bwd_msg_rc_plain(*args))), EDGE_TOL))
    print("    against edge_bwd_msg on K1's stash (bitwise):")
    compare(label, run(), dict(zip(MSG_KEYS, K.edge_bwd_msg(*c["msg"]))), 0.0)
    bitwise(label, run)
    t = in_turns(torch, run, lambda: K.edge_bwd_msg_rc_plain(*args))
    add_bound(res if timed else {}, bound(nbytes(*args[:14], *run()),
                                          tc=2 * B * A * A * 8 * H * H), t)
    if timed:
        add_times(res, t)


def check_upd(torch, K, c, B, A, results, timed, rc):
    """K3 (rc False) or K8 (rc True) at (B, A), summing into a copy of the
    same message-path g_edge: against its plain version (K8 also against K3
    on K1's stash), bitwise repeats, times, stages and bound (summed into
    the kernel's results when ``timed``); device ms in all and by stage
    (centre pass, g_edge product, source pass) summed over the lone or the
    chunk shapes."""
    name = "edge_bwd_upd_rc" if rc else "edge_bwd_upd"
    kernel, plain = ((K.edge_bwd_upd_rc, K.edge_bwd_upd_rc_plain) if rc else
                     (K.edge_bwd_upd, K.edge_bwd_upd_plain))
    args, g0 = (c["upd_rc"] if rc else c["upd_args"]), c["g_edge"]
    label = f"{name} B={B} A={A}"
    print(f"  {label} (g_edge summed in place)")
    run = lambda: kernel(*args, g_edge=g0.clone())
    res = results[name]
    ref = dict(zip(UPD_KEYS, plain(*args, g0.clone())))
    res["max_abs_err"] = max(res["max_abs_err"], compare(label, run(), ref, EDGE_TOL))
    if rc:
        print("    against edge_bwd_upd on K1's stash (bitwise):")
        compare(label, run(), dict(zip(UPD_KEYS, K.edge_bwd_upd(*c["upd_args"],
                                                                g_edge=g0.clone()))), 0.0)
    bitwise(label, run)
    buf_k, buf_p = g0.clone(), g0.clone()     # timed calls keep summing into these
    parts = {}
    t = in_turns(torch, lambda: kernel(*args, g_edge=buf_k), lambda: plain(*args, buf_p), parts)
    add_bound(res if timed else {}, bound(nbytes(*args, g0, *run()),
                                          tc=(4 if rc else 2) * B * A * A * H * H), t)
    if timed:
        add_times(res, t)
    sums = res.setdefault("stage_sums", {}).setdefault("lone" if timed else "chunk", {})
    add_times(sums, {"all": t["device_ms"], **{short_name(n): ms for n, ms in parts.items()}})


def check_edge_shape(torch, K, c, B, A, results):
    """K1 (four flag pairs), K2, K3, K7 and K8 at (B, A) on edge_case ``c``:
    against their plain versions, bitwise repeats, times and bounds summed
    into ``results``."""
    fwd_keys = ("x_agg", "vec_agg", "df", "zdkv", "zs", "zf")
    core, upd = c["core"], c["upd"]
    plain = K.edge_fwd_plain(*core, **upd)
    for update in (True, False):
        for store in (True, False):
            name = f"edge_fwd B={B} A={A} update={int(update)} store={int(store)}"
            print(f"  {name}")
            kw = upd if update else {}
            run = lambda kw=kw, store=store: K.edge_fwd(*core, **kw, store=store)
            ref = dict(zip(fwd_keys, plain if update else K.edge_fwd_plain(*core)))
            if not update:
                ref["df"] = ref["zf"] = None
            if not store:
                ref["zdkv"] = ref["zs"] = ref["zf"] = None
            err = compare(name, run(), ref, EDGE_TOL)
            bitwise(name, run)
            res = results["edge_fwd"]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if update and store:
                t = in_turns(torch, run, lambda kw=kw: K.edge_fwd_plain(*core, **kw))
                add_times(res, t)
                add_bound(res, bound(nbytes(*core[:12], *upd.values(), *run()),
                                     tc=2 * B * A * A * 5 * H * H), t)
    del plain

    msg_args = c["msg"]
    name = f"edge_bwd_msg B={B} A={A}"
    print(f"  {name}")
    run = lambda: K.edge_bwd_msg(*msg_args)
    res = results["edge_bwd_msg"]
    res["max_abs_err"] = max(res["max_abs_err"], compare(
        name, run(), dict(zip(MSG_KEYS, K.edge_bwd_msg_plain(*msg_args))), EDGE_TOL))
    bitwise(name, run)
    t = in_turns(torch, run, lambda: K.edge_bwd_msg_plain(*msg_args))
    add_times(res, t)
    add_bound(res, bound(nbytes(*msg_args[:13], *run()), tc=2 * B * A * A * 4 * H * H), t)

    check_upd(torch, K, c, B, A, results, True, rc=False)
    check_msg_rc(torch, K, c, B, A, results, timed=True)
    check_upd(torch, K, c, B, A, results, True, rc=True)


def check_edge_kernels(torch, dev, results):
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(0)
    for B, A in SHAPES:
        check_edge_shape(torch, K, edge_case(torch, K, gen, B, A, dev), B, A, results)

    # K3, K7 and K8 at the batch sizes the ensemble (phase 5) launches K7/K8
    # at: one chunk of REPLICA_CHUNK replicas folds into each ViSNet batch
    print(f"  K3, K7, K8 at one ensemble chunk's shapes ({REPLICA_CHUNK} replicas per batch; "
          f"times printed, not summed into the kernels line)")
    for B, A in SHAPES:
        c = edge_case(torch, K, gen, REPLICA_CHUNK * B, A, dev)
        check_upd(torch, K, c, REPLICA_CHUNK * B, A, results, False, rc=False)
        check_msg_rc(torch, K, c, REPLICA_CHUNK * B, A, results, timed=False)
        check_upd(torch, K, c, REPLICA_CHUNK * B, A, results, False, rc=True)
        del c
    for name in ("edge_bwd_upd", "edge_bwd_upd_rc"):
        for where, sums in results[name].pop("stage_sums").items():
            print(f"  {name}, device ms summed over the four {where} shapes: " + ", ".join(
                f"{k} {fmt_ms(v)}" for k, v in sums.items()))


EDGE_NAMES = ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "edge_bwd_msg_rc", "edge_bwd_upd_rc")


def check_whole_molecule_kernels(torch, dev, out):
    """K1 (four flag pairs), K2, K3, K7 and K8 at WHOLE_SHAPES, where every
    centre pass walks its sources in chunks of 48 rows: the checks of the
    fragment shapes (check_edge_shape).  Adds {kernel: results} to
    ``out[A]``."""
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(5)
    for B, A in WHOLE_SHAPES:
        res = {n: {"max_abs_err": 0.0} for n in EDGE_NAMES}
        check_edge_shape(torch, K, edge_case(torch, K, gen, B, A, dev), B, A, res)
        for name in ("edge_bwd_upd", "edge_bwd_upd_rc"):
            for sums in res[name].pop("stage_sums").values():
                print(f"  {name} B={B} A={A}, device ms by stage: " + ", ".join(
                    f"{k} {fmt_ms(v)}" for k, v in sums.items()))
        out[A].update(res)
        torch.cuda.empty_cache()


def edge_hashes(torch, dev):
    """sha256 of the output bytes of K1 (four flag pairs), K2, K3, K7 and K8
    (each summing into a copy of the same g_edge for K3/K8) on phase 3's
    fixed fragment-shape inputs: seed 0, SHAPES in order.  Uses only the
    wrappers every tree of the port has, so that ``--edge-hash`` can run
    this script against another commit's package to compare the kernels
    bit for bit."""
    import hashlib

    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(0)
    h = {n: hashlib.sha256() for n in EDGE_NAMES}

    def add(name, outs):
        torch.cuda.synchronize()
        for t in outs:
            if t is not None:
                h[name].update(t.cpu().numpy().tobytes())

    for B, A in SHAPES:
        c = edge_case(torch, K, gen, B, A, dev)
        for update in (True, False):
            for store in (True, False):
                add("edge_fwd", K.edge_fwd(*c["core"], **(c["upd"] if update else {}),
                                           store=store))
        add("edge_bwd_msg", K.edge_bwd_msg(*c["msg"]))
        add("edge_bwd_upd", K.edge_bwd_upd(*c["upd_args"], g_edge=c["g_edge"].clone()))
        add("edge_bwd_msg_rc", K.edge_bwd_msg_rc(*c["msg_rc"]))
        add("edge_bwd_upd_rc", K.edge_bwd_upd_rc(*c["upd_rc"], g_edge=c["g_edge"].clone()))
    out = {n: x.hexdigest() for n, x in h.items()}
    for n, d in out.items():
        print(f"  {n} output sha256 over the fragment shapes {SHAPES}: {d}")
    return out


def check_tf32x3(torch, dev):
    """The tensor-core product helper alone (tf32x3_mm) at H = 256 and
    K = 256, 512 over Chignolin's largest batch's edge rows: against its
    plain model (the same split in cuBLAS float32 products) within EDGE_TOL,
    and its error against a float64 product within 10x that of a float32
    product (cuBLAS, allow_tf32 off); bitwise repeatable."""
    from ai2bmd_torch.ops import tf32x3 as T

    gen = torch.Generator().manual_seed(3)
    rows = 4 * 40 * 40
    for K in (H, 2 * H):
        x = (torch.randn((rows, K), generator=gen) * 0.3).to(dev)
        w = (torch.randn((K, H), generator=gen) * (2.0 / (K + H)) ** 0.5).to(dev)
        name = f"tf32x3_mm M={rows} K={K} N={H}"
        print(f"  {name}")
        got = T.mm_tf32x3(x, w)
        ref64 = x.double() @ w.double()
        err = lambda y: float((y.double() - ref64).abs().max())
        e_k, e_32, e_1 = err(got), err(x @ w), err(T.round_tf32(x) @ T.round_tf32(w))
        print(f"    max|d| against float64: helper {e_k:.3e}, float32 product {e_32:.3e} "
              f"(ratio {e_k / e_32:.2f}, limit 10), one TF32 pass {e_1:.3e}")
        need(e_k <= 10 * e_32, f"{name}: the split is {e_k / e_32:.1f}x a float32 product's error")
        compare(name, (got,), {"against plain model": T.mm_tf32x3_plain(x, w)}, EDGE_TOL)
        bitwise(name, lambda: (T.mm_tf32x3(x, w),))
        ms_k = device_ms(torch, lambda: T.mm_tf32x3(x, w))
        ms_c = device_ms(torch, lambda: x @ w)
        if ms_k and ms_c:
            gf = 2 * rows * K * H / 1e9
            print(f"    device: helper {ms_k:.4f} ms ({gf / ms_k:.1f} TFLOP/s), cuBLAS float32 "
                  f"{ms_c:.4f} ms ({gf / ms_c:.1f} TFLOP/s)")
    # the rate of mma.sync itself: 8 independent products a warp, no loads
    from ai2bmd_torch.ops import _build

    blocks, iters = 2 * torch.cuda.get_device_properties(0).multi_processor_count, 4096
    out = torch.empty(blocks * 256, device=dev)
    run = lambda: _build.call("tf32_mma_rate_launch", [_build.P, _build.I, _build.I],
                              _build.ptr(out), blocks, iters)
    ms = device_ms(torch, run) or cuda_ms(torch, run, 5)
    tflops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8 / ms / 1e9
    print(f"  mma.sync m16n8k8 TF32 alone ({blocks} blocks of 8 warps, 8 independent products "
          f"a warp): {tflops:.1f} TFLOP/s TF32, {tflops / 3:.1f} in 3xTF32 float32 products")


def report_occupancy(torch, results, whole):
    """Shared memory per block, blocks per SM, registers and spill bytes of
    each edge centre pass, and of K3/K8's row-tile product, at each of
    Chignolin's slot counts, which the ensemble's chunks share (the
    launchers' own sizes, through cudaOccupancyMaxActiveBlocksPerMultiprocessor);
    the largest shape's go into the kernels line, for K3/K8 their centre
    pass's.  Then the edge kernels' and K5/K6's centre passes at
    WHOLE_SHAPES (chunked centre passes), with their grids against one wave
    of blocks per SM x SMs, into ``whole``."""
    import ctypes

    from ai2bmd_torch.ops import _build

    lib = _build.library()
    I, P = ctypes.c_int, ctypes.c_void_p
    for fn, n in (("edge_fwd_occupancy", 5), ("edge_bwd_msg_occupancy", 4),
                  ("edge_bwd_upd_occupancy", 4), ("vislayer_fwd_occupancy", 4),
                  ("vislayer_bwd_occupancy", 4)):
        getattr(lib, fn).argtypes = [I] * n + [P]
        getattr(lib, fn).restype = I

    def occ(fn, *args):
        out = (ctypes.c_int * 4)()
        rc = getattr(lib, fn)(*args, ctypes.cast(out, P))
        need(rc == 0, f"{fn}{args}: CUDA error {rc}")
        return dict(smem_bytes=out[0], blocks_per_sm=out[1], registers=out[2], spill_bytes=out[3])

    for B, A in sorted(SHAPES, key=lambda s: s[1]):
        for label, name, fn, args in (
                ("K1 update store", "edge_fwd", "edge_fwd_occupancy", (A, H, S, 1, 1)),
                ("K1 update", None, "edge_fwd_occupancy", (A, H, S, 1, 0)),
                ("K1 store", None, "edge_fwd_occupancy", (A, H, S, 0, 1)),
                ("K1", None, "edge_fwd_occupancy", (A, H, S, 0, 0)),
                ("K2", "edge_bwd_msg", "edge_bwd_msg_occupancy", (A, H, S, 0)),
                ("K7", "edge_bwd_msg_rc", "edge_bwd_msg_occupancy", (A, H, S, 1)),
                ("K3 centre", "edge_bwd_upd", "edge_bwd_upd_occupancy", (A, H, 0, 1)),
                ("K8 centre", "edge_bwd_upd_rc", "edge_bwd_upd_occupancy", (A, H, 1, 1)),
                ("K3/K8 product", None, "edge_bwd_upd_occupancy", (A, H, 0, 2)),
                *((f"K5 {st}", "vislayer_fwd" if k == 2 else None, "vislayer_fwd_occupancy",
                   (A, H, S, k)) for k, st in enumerate(K5_STAGES)),
                *((f"K6 {st}", "vislayer_bwd" if k == 1 else None, "vislayer_bwd_occupancy",
                   (A, H, S, k)) for k, st in enumerate(K6_STAGES))):
            o = occ(fn, *args)
            print(f"  {label:16s} A={A}: {o['smem_bytes']} B shared memory per block, "
                  f"{o['blocks_per_sm']} blocks per SM, {o['registers']} registers, "
                  f"{o['spill_bytes']} B local (spill) per thread")
            if name is not None:
                results[name].update(o)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, A in WHOLE_SHAPES:
        for label, name, fn, args, blocks in (
                ("K1 update store", "edge_fwd", "edge_fwd_occupancy", (A, H, S, 1, 1), B * A),
                ("K1 update", None, "edge_fwd_occupancy", (A, H, S, 1, 0), B * A),
                ("K1 store", None, "edge_fwd_occupancy", (A, H, S, 0, 1), B * A),
                ("K1", None, "edge_fwd_occupancy", (A, H, S, 0, 0), B * A),
                ("K2", "edge_bwd_msg", "edge_bwd_msg_occupancy", (A, H, S, 0), B * A),
                ("K7", "edge_bwd_msg_rc", "edge_bwd_msg_occupancy", (A, H, S, 1), B * A),
                ("K3 centre", "edge_bwd_upd", "edge_bwd_upd_occupancy", (A, H, 0, 1),
                 B * A * H // 256),
                ("K8 centre", "edge_bwd_upd_rc", "edge_bwd_upd_occupancy", (A, H, 1, 1), B * A),
                ("K3/K8 product", None, "edge_bwd_upd_occupancy", (A, H, 0, 2),
                 -(-B * A * A // 128) * (H // 64)),
                ("K5 centre 1", None, "vislayer_fwd_occupancy", (A, H, S, 3), B * A),
                ("K5 centre 2", "vislayer_fwd", "vislayer_fwd_occupancy", (A, H, S, 5), B * A),
                ("K5 edge tile", None, "vislayer_fwd_occupancy", (A, H, S, 2),
                 -(-B * A * A // 128) * (3 * H // 64)),
                ("K6 centre", "vislayer_bwd", "vislayer_bwd_occupancy", (A, H, S, 5), B * A),
                ("K6 edge rows", None, "vislayer_bwd_occupancy", (A, H, S, 2), B * A * A)):
            o = occ(fn, *args)
            waves = blocks / (o["blocks_per_sm"] * sms)
            print(f"  {label:16s} B={B} A={A} (chunks of 48): {o['smem_bytes']} B shared memory "
                  f"per block, {o['blocks_per_sm']} blocks per SM, {o['registers']} registers, "
                  f"{o['spill_bytes']} B local (spill) per thread; grid {blocks} blocks, "
                  f"{waves:.2f} of a wave of {o['blocks_per_sm']} x {sms}")
            if name is not None:
                whole[A][name].update(o, grid_blocks=blocks, waves=waves)


# the stages vislayer_{fwd,bwd}_occupancy report, in their order
K5_STAGES = ("qkv/o tile", "proj tile", "edge tile", "centre 1", "W_s tile", "centre 2")
K6_STAGES = ("node ^T tile", "edge tile", "edge rows", "W_s tile", "W_s^T tile", "centre",
             "g_edge tile", "source", "gvec tile", "g_wt")


def cublas_yardstick(torch, dev, results):
    """cuBLAS float32 (allow_tf32 off) over the flattened [B*A*A, .] edge
    rows, the products of K1 (5 H^2 per edge cell), K2 (4 H^2), K7 (8 H^2),
    K3 (H^2) and K8 (2 H^2) only, and of K5 and K6 (the updating layer's,
    edge, node and vector rows), summed over Chignolin's four shapes: a
    yardstick printed beside the kernels, not a library_ms (it is not the
    same function)."""
    gen = torch.Generator().manual_seed(4)
    r = lambda *s: (torch.randn(s, generator=gen) * 0.3).to(dev)
    w_dkv, w_s, w_f, w_sT, w_dkvT = r(H, 2 * H), r(H, 2 * H), r(H, H), r(2 * H, H), r(2 * H, H)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tot = {"edge_fwd": 0.0, "edge_bwd_msg": 0.0, "edge_bwd_msg_rc": 0.0,
               "edge_bwd_upd": 0.0, "edge_bwd_upd_rc": 0.0}
        for B, A in SHAPES:
            n = B * A * A
            e, vij, g1, g2, gz = r(n, H), r(n, H), r(n, 2 * H), r(n, 2 * H), r(n, H)
            fwd = lambda: (e @ w_dkv, vij @ w_s, e @ w_f)
            bwd = lambda: (g1 @ w_sT, g2 @ w_dkvT)
            rc = lambda: (e @ w_dkv, vij @ w_s, g1 @ w_sT, g2 @ w_dkvT)
            upd = lambda: (gz @ w_f.T,)
            upd_rc = lambda: (e @ w_f, gz @ w_f.T)
            for name, fn in (("edge_fwd", fwd), ("edge_bwd_msg", bwd), ("edge_bwd_msg_rc", rc),
                             ("edge_bwd_upd", upd), ("edge_bwd_upd_rc", upd_rc)):
                ms = device_ms(torch, fn) or cuda_ms(torch, fn, 20)
                tot[name] += ms
            del e, vij, g1, g2, gz
        # K5/K6's products (the updating layer), node and vector rows included
        w_qkv, w_o, w_cat, w_ef = r(H, 3 * H), r(H, 3 * H), r(H, 5 * H), r(H, 3 * H)
        tot["vislayer_fwd"] = tot["vislayer_bwd"] = 0.0
        for B, A in SHAPES:
            n, m, mv = B * A * A, B * A, B * S * A
            e, vij, xn, vn, xa = r(n, H), r(n, H), r(m, H), r(mv, H), r(m, H)
            g2, g3, x3, xv = r(n, 2 * H), r(n, 3 * H), r(m, 3 * H), r(mv, 5 * H)
            fwd = lambda: (xn @ w_qkv, vn @ w_cat, e @ w_ef, vij @ w_s, xa @ w_o)
            bwd = lambda: (xn @ w_qkv, vn @ w_cat, xa @ w_o[:, :2 * H], x3 @ w_o.T, e @ w_ef,
                           vij @ w_s, g2 @ w_s.T, g3 @ w_ef.T, x3 @ w_qkv.T, xv @ w_cat.T)
            for name, fn in (("vislayer_fwd", fwd), ("vislayer_bwd", bwd)):
                tot[name] += device_ms(torch, fn) or cuda_ms(torch, fn, 20)
            del e, vij, xn, vn, xa, g2, g3, x3, xv
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for name, ms in tot.items():
        res = results[name]
        res["cublas_f32_products_ms"] = ms
        kern = res.get("device_ms") or res.get("ms")
        print(f"  {name}: cuBLAS float32, products only, {ms:.4f} ms over the four shapes, "
              f"{res['gflop'] / ms:.1f} TFLOP/s; the kernel {kern:.4f} ms device, "
              f"{res['gflop'] / kern:.1f} TFLOP/s in its products")


def cap_inputs(torch, dev, prot):
    """Phase 3's fixed inputs of K4: Chignolin's runtime, its dipeptide rows
    as placed (template) and perturbed by 0.05 A, and 64 replicas' rows,
    each replica perturbed on its own (a CPU generator, seed 1)."""
    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.host import build_fragment_index

    rt = RT.FragmentRuntime.build(build_fragment_index(prot.atoms), device=dev)
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(1)
    base = RT.build_row_positions(rt, P)
    lone = {label: (base + sigma * torch.randn(base.shape, generator=gen).to(dev)).contiguous()
            for label, sigma in (("template", 0.0), ("perturbed", 0.05))}
    reps = (base + 0.05 * torch.randn((N_REPLICAS, *base.shape), generator=gen).to(dev))
    return rt, lone, reps.contiguous()


def cap_hashes(torch, dev, prot, timed=False):
    """sha256 of K4's output bytes on phase 3's fixed inputs (perturbed lone
    rows, and the 64 replicas' rows), and with ``timed`` K4's device ms per
    call on each.  Uses only what every tree of the port has
    (FragmentRuntime, amber_grad_rows), so that ``--cap-hash`` can run this
    script against another commit's package to compare K4 bit for bit and
    in time."""
    import hashlib

    from ai2bmd_torch.ops import caps as C

    rt, lone, reps = cap_inputs(torch, dev, prot)
    out, ms = {}, {}
    for label, pos in (("lone", lone["perturbed"]), (f"{N_REPLICAS} replicas", reps)):
        g = C.amber_grad_rows(rt.ht.caps, pos)
        torch.cuda.synchronize()
        out[label] = hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest()
        if timed:
            ms[label] = device_ms(torch, lambda pos=pos: C.amber_grad_rows(rt.ht.caps, pos), 50)
    print("  cap_grad output sha256: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    if timed:
        print("  K4 device time per call: " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in ms.items()))
    return out


def check_cap_kernel(torch, dev, prot, results):
    from ai2bmd_torch.ops import caps as C

    rt, lone, reps = cap_inputs(torch, dev, prot)
    ptr = rt.ht.caps.kernel[-2].cpu()
    per_atom = (ptr[:, 1:] - ptr[:, :-1]).float()
    NB, NA, ND, NP = rt.ht.caps.sizes
    NE = 2 * NB + 3 * NA + 4 * ND + 2 * NP
    print(f"  K4 design: one block of 128 threads per row; {NE} (term, endpoint) slots a row, "
          f"{int(ptr[:, -1].sum())} of {ptr.shape[0] * NE} in the rows' per-atom lists; slots "
          f"per atom: mean {float(per_atom.mean()):.1f}, max {int(per_atom.max())}")
    times = {}
    for label, pos in lone.items():
        name = f"cap_grad R={pos.shape[0]} S={pos.shape[1]} {label}"
        print(f"  {name}")
        run = lambda pos=pos: (C.amber_grad_rows(rt.ht.caps, pos),)
        res = results["cap_grad"]
        res["max_abs_err"] = max(res["max_abs_err"], compare(
            name, run(), {"grad": C.amber_grad_rows_plain(rt.ht.caps, pos)}, CAP_TOL))
        bitwise(name, run)
        if label == "perturbed":
            t = in_turns(torch, run, lambda pos=pos: C.amber_grad_rows_plain(rt.ht.caps, pos))
            add_times(res, t)
            add_bound(res, bound(nbytes(pos, *rt.ht.caps.kernel[:-2], *run()),
                                 f32=cap_flop(rt, pos)), t)
            times["lone"] = t["device_ms"]

    # the ensemble's form: every replica's rows, each replica perturbed on
    # its own, in one launch that reads row p's tables at p % R
    pos = reps
    name = f"cap_grad Rl={N_REPLICAS} R={pos.shape[1]} S={pos.shape[2]} per-replica perturbed"
    print(f"  {name}")
    run = lambda: (C.amber_grad_rows(rt.ht.caps, pos),)
    res = results["cap_grad"]
    got = run()[0]
    res["max_abs_err"] = max(res["max_abs_err"], compare(
        name, (got,), {"grad": C.amber_grad_rows_plain(rt.ht.caps, pos)}, CAP_TOL))
    alone = all(bool(torch.equal(got[r], C.amber_grad_rows(rt.ht.caps, pos[r].contiguous())))
                for r in range(N_REPLICAS))
    print(f"    each replica's rows bitwise equal to a launch over that replica alone: {alone}")
    need(alone, f"{name}: the replica launch differs from the lone launches")
    bitwise(name, run)
    t = in_turns(torch, run, lambda: C.amber_grad_rows_plain(rt.ht.caps, pos))
    add_bound({}, bound(nbytes(pos, *rt.ht.caps.kernel[:-2], *run()), f32=cap_flop(rt, pos)), t)
    times[f"{N_REPLICAS} replicas"] = t["device_ms"]
    print("  K4 device time per call: " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in times.items()))
    cap_hashes(torch, dev, prot)


def cap_flop(rt, pos):
    """Operations of K4 over pos [..., R,S,3]: ~30 FLOPs per bond and pair
    term, ~60 per angle, ~120 per dihedral, per row (an estimate; bytes
    bound it)."""
    NB, NA, ND, NP = rt.ht.caps.sizes
    return (pos.numel() // (pos.shape[-2] * 3)) * (30 * NB + 60 * NA + 120 * ND + 30 * NP)


def layer_inputs(torch, gen, B, A, dev, H=H):
    """A fused layer's inputs at shape (B, A) and width H: a graph from
    random positions (the last fragment's last 3 slots masked), random
    streams, and cotangents.  Sphere-major vec and d_sh."""
    from ai2bmd_torch.models.visnet import ViSNetConfig, dense_graph

    pos = torch.randn((B, A, 3), generator=gen) * 2.5
    mask = torch.ones((B, A), dtype=torch.bool)
    mask[-1, A - 3:] = False
    adj, _, dist, d_sh = dense_graph(pos, mask, ViSNetConfig())
    adj = adj.float()
    r = lambda *s, sc: torch.randn(s, generator=gen) * sc
    t = dict(x=r(B, A, H, sc=0.5), vec=r(B, S, A, H, sc=0.3),
             edge=r(B, A, A, H, sc=0.2) * adj[..., None], d_sh=d_sh.permute(0, 3, 1, 2),
             dist=dist, adj=adj, gx2=r(B, A, H, sc=1.0), gvec2=r(B, S, A, H, sc=1.0),
             gedge2=r(B, A, A, H, sc=1.0) * adj[..., None])
    return {k: v.contiguous().to(dev) for k, v in t.items()}


def layer_flop(B, A, last, H=H):
    """FLOPs of K5 and K6 for one call: the products only (2 per multiply-add);
    K6 recomputes o1|o2 = x_agg @ W_o[:, :2H] (o3 is not needed)."""
    cells, atoms, vrows = B * A * A, B * A, B * S * A
    fwd = cells * (4 if last else 5) + atoms * 6 + vrows * (3 if last else 5)
    bwd = cells * (8 if last else 10) + atoms * 11 + vrows * (6 if last else 10)
    return 2 * fwd * H * H, 2 * bwd * H * H


def layer_weights_on(torch, FL, params, gen, last, dev, H=H, NH=NH):
    """The first (or, ``last``, the last) layer's fused-layer weights of
    ``params``, LayerNorm scale / bias and vector norm weight perturbed from
    ``gen``, on ``dev``."""
    w = [t.clone() for t in FL.layer_weights(params["layers"][-1 if last else 0], H, NH, last)]
    for n in range(3):                      # LayerNorm scale / bias, vector norm weight
        w[n] = w[n] + 0.1 * torch.randn(w[n].shape, generator=gen)
    return [t.to(dev).contiguous() for t in w]


def check_layer_shape(torch, FL, w, a, B, A, last, results, reps=20, H=H, NH=NH):
    """K5, then K6 on K5's x_agg, at (B, A) on layer_inputs ``a``: against
    their plain versions, bitwise repeats, times, stage times and bound;
    the updating layer's (``last`` False) summed into ``results``."""
    args = (a["x"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"], w, CUTOFF, NH, last)
    flop_f, flop_b = layer_flop(B, A, last, H)
    name = f"vislayer_fwd B={B} A={A} last={int(last)}"
    print(f"  {name}")
    run = lambda: FL.vislayer_fwd(*args)
    ref = dict(zip(("x2", "vec2", "edge2", "x_agg"), FL.vislayer_fwd_plain(*args)))
    res = results["vislayer_fwd"]
    res["max_abs_err"] = max(res["max_abs_err"], compare(name, run(), ref, EDGE_TOL))
    del ref
    bitwise(name, run)
    parts = {}
    t = in_turns(torch, run, lambda: FL.vislayer_fwd_plain(*args), parts, reps)
    b = bound(nbytes(*args[:6], *w, *run()), tc=flop_f)
    add_bound(res if not last else {}, b, t)
    if not last:
        add_times(res, t)
    add_stage_sums(res, last, t, parts)

    xagg = run()[3]
    bargs = (*args[:7], xagg, a["gx2"], a["gvec2"], a["gedge2"], CUTOFF, NH, last)
    name = f"vislayer_bwd B={B} A={A} last={int(last)}"
    print(f"  {name}")
    run = lambda: FL.vislayer_bwd(*bargs)
    ref = dict(zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"), FL.vislayer_bwd_plain(*bargs)))
    res = results["vislayer_bwd"]
    res["max_abs_err"] = max(res["max_abs_err"], compare(name, run(), ref, EDGE_TOL))
    del ref
    bitwise(name, run)
    parts = {}
    t = in_turns(torch, run, lambda: FL.vislayer_bwd_plain(*bargs), parts, reps)
    b = bound(nbytes(*bargs[:6], *w, *bargs[7:11], *run()), tc=flop_b)
    add_bound(res if not last else {}, b, t)
    if not last:
        add_times(res, t)
    add_stage_sums(res, last, t, parts)


def print_stage_sums(results, where):
    for name in ("vislayer_fwd", "vislayer_bwd"):
        for last, sums in results[name].pop("stage_sums").items():
            print(f"  {name}, device ms {where}, {last}: " + ", ".join(
                f"{k} {fmt_ms(v)}" for k, v in sums.items()))


def check_layer_kernels(torch, dev, results):
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import vislayer as FL

    gen = torch.Generator().manual_seed(2)
    params = init_params(ViSNetConfig(), gen)
    for last in (False, True):
        w = layer_weights_on(torch, FL, params, gen, last, dev)
        for B, A in SHAPES:
            check_layer_shape(torch, FL, w, layer_inputs(torch, gen, B, A, dev), B, A, last,
                              results)
    print_stage_sums(results, "summed over the four shapes")


def check_whole_layer_kernels(torch, dev, whole):
    """K5 and K6, both ``last`` variants, at WHOLE_SHAPES (Chignolin,
    Trp-cage and abd as one molecule), where their centre passes walk the
    sources in chunks of 48 rows: the checks of the fragment shapes, with
    fewer timed calls.  Adds {kernel: results} to ``whole[A]``."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import vislayer as FL

    gen = torch.Generator().manual_seed(6)
    params = init_params(ViSNetConfig(), gen)
    ws = {last: layer_weights_on(torch, FL, params, gen, last, dev) for last in (False, True)}
    for B, A in WHOLE_SHAPES:
        res = {n: {"max_abs_err": 0.0} for n in ("vislayer_fwd", "vislayer_bwd")}
        a = layer_inputs(torch, gen, B, A, dev)
        for last in (False, True):
            check_layer_shape(torch, FL, ws[last], a, B, A, last, res, reps=5)
        print_stage_sums(res, f"at B={B} A={A}")
        whole[A].update(res)
        del a
        torch.cuda.empty_cache()


# the head widths other than 32 channels that the kernels are instantiated
# for, at the widths that reach them: the CLI's tiny preset (H = 32, 4
# heads), H = 64 with 4 heads and H = 256 with 4 heads of 64 channels (two
# warps a head); at a fragment shape and a whole molecule
HEAD_CASES = ((32, 4), (64, 4), (256, 4))
HEAD_SHAPES = ((4, 40), (1, 176))


def check_head_widths(torch, dev, results):
    """K1 (four flag pairs), K2, K3, K7, K8, K5 and K6 (both ``last``) at
    heads of 8, 16 and 64 channels (HEAD_CASES, HEAD_SHAPES): against their
    plain versions within EDGE_TOL and bitwise repeatable.  Each kernel's
    largest error goes to results[kernel]["head_widths"]["DH=.."]."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import vislayer as FL
    from ai2bmd_torch.ops import vismp as K

    gen = torch.Generator().manual_seed(7)
    fwd_keys = ("x_agg", "vec_agg", "df", "zdkv", "zs", "zf")

    def check(name, run, ref, dh, label):
        err = compare(label, run(), ref, EDGE_TOL)
        bitwise(label, run)
        hw = results[name].setdefault("head_widths", {})
        hw[f"DH={dh}"] = max(hw.get(f"DH={dh}", 0.0), err)

    for h, nh in HEAD_CASES:
        dh = h // nh
        params = init_params(ViSNetConfig(hidden_channels=h, num_heads=nh), gen)
        ws = {last: layer_weights_on(torch, FL, params, gen, last, dev, h, nh)
              for last in (False, True)}
        for B, A in HEAD_SHAPES:
            tag = f"H={h} nh={nh} (DH={dh}) B={B} A={A}"
            c = edge_case(torch, K, gen, B, A, dev, h, nh)
            core, upd = c["core"], c["upd"]
            for update in (True, False):
                for store in (True, False):
                    label = f"edge_fwd {tag} update={int(update)} store={int(store)}"
                    print(f"  {label}")
                    kw = upd if update else {}
                    ref = dict(zip(fwd_keys, K.edge_fwd_plain(*core, **kw)))
                    if not store:
                        ref["zdkv"] = ref["zs"] = ref["zf"] = None
                    check("edge_fwd", lambda kw=kw, store=store: K.edge_fwd(*core, **kw, store=store),
                          ref, dh, label)
            for name, args in (("edge_bwd_msg", c["msg"]), ("edge_bwd_msg_rc", c["msg_rc"])):
                print(f"  {name} {tag}")
                check(name, lambda name=name, args=args: getattr(K, name)(*args),
                      dict(zip(MSG_KEYS, getattr(K, name + "_plain")(*args))), dh, f"{name} {tag}")
            for name, args in (("edge_bwd_upd", c["upd_args"]), ("edge_bwd_upd_rc", c["upd_rc"])):
                print(f"  {name} {tag}")
                g0 = c["g_edge"]
                check(name, lambda name=name, args=args: getattr(K, name)(*args, g_edge=g0.clone()),
                      dict(zip(UPD_KEYS, getattr(K, name + "_plain")(*args, g0.clone()))), dh,
                      f"{name} {tag}")
            del c
            a = layer_inputs(torch, gen, B, A, dev, h)
            for last in (False, True):
                args = (a["x"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"], ws[last],
                        CUTOFF, nh, last)
                label = f"vislayer_fwd {tag} last={int(last)}"
                print(f"  {label}")
                check("vislayer_fwd", lambda args=args: FL.vislayer_fwd(*args),
                      dict(zip(("x2", "vec2", "edge2", "x_agg"), FL.vislayer_fwd_plain(*args))),
                      dh, label)
                bargs = (*args[:7], FL.vislayer_fwd(*args)[3], a["gx2"], a["gvec2"], a["gedge2"],
                         CUTOFF, nh, last)
                label = f"vislayer_bwd {tag} last={int(last)}"
                print(f"  {label}")
                check("vislayer_bwd", lambda bargs=bargs: FL.vislayer_bwd(*bargs),
                      dict(zip(("g_x", "g_vec", "g_edge", "g_d_sh", "g_dist"),
                               FL.vislayer_bwd_plain(*bargs))), dh, label)


def layer_hashes(torch, dev, timed=False):
    """sha256 of K5's and K6's output bytes, both ``last`` variants, on
    fixed fragment-shape inputs (seed 2, SHAPES in order, K6 on K5's
    x_agg), and with ``timed`` their device ms a call summed over the
    shapes, in all and by stage.  Uses only what every tree of the port
    has, so that ``--layer-hash`` can run this script against another
    commit's package to compare K5/K6 bit for bit and in time."""
    import hashlib

    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import vislayer as FL

    gen = torch.Generator().manual_seed(2)
    params = init_params(ViSNetConfig(), gen)
    h = {n: hashlib.sha256() for n in ("vislayer_fwd", "vislayer_bwd")}

    def add(name, outs):
        torch.cuda.synchronize()
        for t in outs:
            h[name].update(t.cpu().numpy().tobytes())

    sums = {}
    for last in (False, True):
        w = layer_weights_on(torch, FL, params, gen, last, dev)
        for B, A in SHAPES:
            a = layer_inputs(torch, gen, B, A, dev)
            args = (a["x"], a["vec"], a["edge"], a["d_sh"], a["dist"], a["adj"], w, CUTOFF, NH,
                    last)
            fwd = FL.vislayer_fwd(*args)
            add("vislayer_fwd", fwd)
            bargs = (*args[:7], fwd[3], a["gx2"], a["gvec2"], a["gedge2"], CUTOFF, NH, last)
            add("vislayer_bwd", FL.vislayer_bwd(*bargs))
            if timed:
                for name, fn in (("vislayer_fwd", lambda: FL.vislayer_fwd(*args)),
                                 ("vislayer_bwd", lambda: FL.vislayer_bwd(*bargs))):
                    parts = {}
                    ms = device_ms(torch, fn, 20, by_name=parts)
                    add_times(sums.setdefault(f"{name} last={int(last)}", {}),
                              {"all": ms, **{short_name(n): t for n, t in parts.items()}})
    out = {n: x.hexdigest() for n, x in h.items()}
    for n, d in out.items():
        print(f"  {n} output sha256 over the fragment shapes {SHAPES}, both last: {d}")
    for label, t in sums.items():
        print(f"  {label} device ms a call summed over the fragment shapes: " + ", ".join(
            f"{k} {fmt_ms(v)}" for k, v in t.items()))
    return out


def add_stage_sums(res, last, t, parts):
    """Sum a call's device ms, in all and by kernel name, into the kernel's
    stage sums for its ``last`` variant."""
    sums = res.setdefault("stage_sums", {}).setdefault(f"last={int(last)}", {})
    add_times(sums, {"all": t["device_ms"], **{short_name(n): ms for n, ms in parts.items()}})


def profile_steps(torch, step, state, n=3, label="steps", steps_per_call=1):
    """Device busy share of n calls of ``step`` (``steps_per_call`` MD steps
    each) and the kernels that take the time.  Returns kernels per MD step,
    busy ms per MD step, the busy share and the set of device kernel names
    in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n *= steps_per_call
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    print(f"  profiled {n} {label}: {len(kernels) / n:.0f} device kernels per step, device busy "
          f"{busy_us / n / 1e3:.3f} ms of {wall_us / n / 1e3:.3f} ms per step "
          f"({100 * busy_us / wall_us:.1f}% busy, profiler on)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / n / 1e3:8.3f} ms/step  {name[:100]}")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    gaps = sorted((b[0] - a[1] for a, b in zip(spans, spans[1:])), reverse=True)
    print(f"    device idle between its first and last kernel: "
          f"{sum(g for g in gaps if g > 0) / n / 1e3:.3f} ms/step; largest gaps (us): "
          + ", ".join(f"{g:.1f}" for g in gaps[:5]))
    return dict(kernels_per_step=len(kernels) / n, busy_ms=busy_us / n / 1e3,
                busy_share=busy_us / wall_us, names=set(by_name))


def build_potential(torch, dev, prot, fused: bool):
    """FragmentPotential for Chignolin at 9 x 256 (random weights, seed 0) on
    the card; ``fused`` selects the full-layer kernels the way a user does,
    with AI2BMD_FUSED_LAYER=1."""
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.potentials import FragmentPotential

    cfg = ViSNetConfig()                                   # 9 layers x 256, 8 heads, lmax 2
    params = init_params(cfg, torch.Generator().manual_seed(0))
    old = os.environ.pop("AI2BMD_FUSED_LAYER", None)
    if fused:
        os.environ["AI2BMD_FUSED_LAYER"] = "1"
    try:
        pot = FragmentPotential.build(prot, ViSNet(cfg, params), cfg, longrange="mm", device=dev)
    finally:
        os.environ.pop("AI2BMD_FUSED_LAYER", None)
        if old is not None:
            os.environ["AI2BMD_FUSED_LAYER"] = old
    need(pot.cfg.fused_layer == fused, f"fused_layer is {pot.cfg.fused_layer}, wanted {fused}")
    return pot, cfg, params


def drive(torch, dev, prot, pot, card, path_kernels):
    """Cold caps, step 0, WARM_STEPS + TIMED_STEPS warm Langevin steps, with the
    launch counters reset just before and read just after; then a profiled
    window; then the same steps as replays of one CUDA graph
    (``drive_graphed``), whose trace must name ``path_kernels``.  Returns
    (launches, ms_step, P, aux0, aux1, e0, f0, graphed figures)."""
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.ops import LAUNCHES, reset_launches

    print(f"  buckets (rows x slots): "
          f"{[(len(b.rows), b.width) for b in pot.rt.dip_buckets]} + ACE-NME "
          f"{tuple(pot.rt.ace_z16.shape)}")
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = lambda s: L.langevin_step(pot.stateful_energy_forces, coeffs, masses, s,
                                     generator=gen)

    torch.cuda.synchronize()
    reset_launches()
    aux0 = pot.init_cap_delta(P)                           # cold caps, 10 iterations
    e0, f0, aux1 = pot.stateful_energy_forces(P, aux0)     # step 0, warm caps
    state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0), f0, e0,
                      aux=aux1)
    energies = [e0]
    for _ in range(WARM_STEPS):
        state = step(state)
        energies.append(state.energy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state = step(state)
        energies.append(state.energy)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches = dict(LAUNCHES)
    energies = torch.stack(energies)
    print(f"  steps: {state.step} warm Langevin steps after step 0; launches {launches}")
    print(f"  energies (eV): first {float(energies[0]):.6f}  last {float(energies[-1]):.6f}")
    need(bool(energies.isfinite().all()), "non-finite energy in the run")
    need(bool(state.positions.isfinite().all() and state.forces.isfinite().all()),
         "non-finite positions or forces in the run")
    need(state.step >= 20, "fewer than 20 warm steps")
    print(f"  steady state: {ms_step:.3f} ms/step over {TIMED_STEPS} steps "
          f"(smoke figure, not a benchmark; host clock, synchronised; {card})")
    eager = profile_steps(torch, step, state)
    graphed = drive_graphed(torch, pot.stateful_energy_forces, coeffs, masses, state, gen, card,
                            ("cap_grad_kernel", *path_kernels))
    print(f"  eager / graphed: {ms_step:.3f} / {graphed['ms_step']:.3f} ms/step, "
          f"{eager['kernels_per_step']:.0f} / {graphed['kernels_per_step']:.0f} kernels per "
          f"step, {100 * eager['busy_share']:.1f}% / {100 * graphed['busy_share']:.1f}% busy")
    return launches, ms_step, P, aux0, aux1, e0, f0, graphed


def drive_graphed(torch, potential, coeffs, masses, state, gen, card, trace_kernels):
    """The step of ``potential`` (the stateful protocol) captured as one CUDA
    graph (GraphedLangevin) from ``state``: peak memory of the capture; the
    first GRAPH_CHECK_STEPS replays held against eager langevin_step calls
    from the same state on the same noise (max|dx|, max|dF|, limit
    FORCE_LIMIT: the force stitch sums with atomics, so not bitwise);
    TIMED_STEPS replays timed by the host clock and by CUDA events; a
    profiled window of replays whose trace must name every kernel of
    ``trace_kernels``.  Returns ms/step (host, events), kernels per step and
    busy share."""
    from ai2bmd_torch.md import GraphedLangevin
    from ai2bmd_torch.md import langevin as L

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    graphed = GraphedLangevin(potential, coeffs, masses, state, gen)
    torch.cuda.synchronize()
    print(f"  graph: {time.perf_counter() - t0:.1f} s (warm-up "
          f"{graphed.setup_seconds['warmup']:.1f} s, capture {graphed.setup_seconds['capture']:.1f}"
          f" s); peak device memory above the {base / 2**20:.1f} MiB held before: "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB")
    ref, dx, dF = state, 0.0, 0.0
    for _ in range(GRAPH_CHECK_STEPS):
        got = graphed.run(1)
        ref = L.langevin_step(potential, coeffs, masses, ref,
                              xi=graphed.buffers.xi, eta=graphed.buffers.eta)
        dx = max(dx, float((got.positions - ref.positions).abs().max()))
        dF = max(dF, float((got.forces - ref.forces).abs().max()))
    print(f"  first {GRAPH_CHECK_STEPS} replayed steps vs eager steps on the same noise: "
          f"max|dx| {dx:.3e} A, max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT})")
    need(dx <= FORCE_LIMIT and dF <= FORCE_LIMIT,
         f"replayed steps differ from eager steps: dx {dx:.3e}, dF {dF:.3e}")
    energies = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        energies.append(graphed.run(1).energy.clone())
    end.record()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    ms_events = start.elapsed_time(end) / TIMED_STEPS
    s = graphed.state
    need(bool(torch.stack(energies).isfinite().all()), "non-finite energy in the graphed run")
    need(bool(s.positions.isfinite().all() and s.forces.isfinite().all()),
         "non-finite positions or forces in the graphed run")
    print(f"  graphed: {ms_step:.3f} ms/step (host clock, synchronised), {ms_events:.3f} (CUDA "
          f"events) over {TIMED_STEPS} replays after step {s.step - TIMED_STEPS} (smoke "
          f"figure; {card})")
    prof = profile_steps(torch, lambda _: graphed.run(1), None, label="replayed steps")
    for name in trace_kernels:
        need(any(name in n for n in prof["names"]), f"the replay trace names no {name}")
    print(f"  the replay trace names {', '.join(trace_kernels)}")
    return dict(ms_step=ms_step, ms_events=ms_events, **prof)


def run_slice(torch, dev, prot, card):
    """Phase 4: the slice through K1-K3; returns its launches, ms/step and the
    step-0 references phase 4b is held against."""
    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.potentials import FragmentPotential

    pot, cfg, params = build_potential(torch, dev, prot, fused=False)
    launches, ms_step, P, aux0, aux1, e0, f0, graphed = drive(torch, dev, prot, pot, card,
                                                              EDGE_KERNELS)
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad"):
        need(launches[name] > 0, f"kernel {name} was not launched on the main path")
    for name in ("vislayer_fwd", "vislayer_bwd", "edge_bwd_msg_rc", "edge_bwd_upd_rc",
                 "tf32x3_mm"):
        need(launches[name] == 0, f"{name} ran on the edge-core path")

    # step 0 against the same port on the CPU in float64 (plain versions)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    longrange="mm", device="cpu")
    P64 = P.to(cpu, torch.float64)
    e_ref, f_ref, aux_ref = pot64.stateful_energy_forces(P64, aux0.to(cpu, torch.float64))
    dF = float((f0.to(cpu, torch.float64) - f_ref).abs().max())
    dE = abs(float(e0) - float(e_ref))
    # and at fixed cap positions: the rows the card's step 0 used
    pos_card = RT.build_row_positions(pot.rt, P) + aux1
    _, f_fix = RT._fragment_terms(pot.module.params(), pot.rt, pos_card, cfg)
    _, f_fix_ref = RT._fragment_terms(pot64.module.params(), pot64.rt,
                                      pos_card.to(cpu, torch.float64), cfg)
    dF_fix = float((f_fix.to(cpu, torch.float64) - f_fix_ref).abs().max())
    print(f"  step 0 vs CPU float64 plain: |dE| {dE:.3e} eV, max|dF| {dF:.3e} eV/A "
          f"(limit {FORCE_LIMIT}); fixed caps max|dF| {dF_fix:.3e} eV/A; "
          f"max|F| {float(f_ref.abs().max()):.3f} eV/A; reference took "
          f"{time.perf_counter() - t0:.1f} s")
    need(dF <= FORCE_LIMIT, f"step-0 forces differ from the float64 reference by {dF:.3e}")
    need(dF_fix <= FORCE_LIMIT, f"fixed-cap forces differ by {dF_fix:.3e}")
    return launches, ms_step, graphed, dict(aux0=aux0, e0=e0, f0=f0, e_ref=e_ref, f_ref=f_ref)


def run_fused_slice(torch, dev, prot, card, ref):
    """Phase 4b: the slice through K5/K6, held against phase 4's step 0."""
    pot, _, _ = build_potential(torch, dev, prot, fused=True)
    launches, ms_step, _, aux0, _, e0, f0, graphed = drive(torch, dev, prot, pot, card,
                                                           LAYER_KERNELS)
    evals = 1 + WARM_STEPS + TIMED_STEPS
    per_eval = N_LAYERS * (len(pot.rt.dip_buckets) + 1)
    for name in ("vislayer_fwd", "vislayer_bwd"):
        need(launches[name] == per_eval * evals,
             f"{name}: {launches[name]} launches, expected {per_eval} x {evals} force evaluations")
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "edge_bwd_msg_rc", "edge_bwd_upd_rc"):
        need(launches[name] == 0, f"{name} ran on the full-layer path")
    need(launches["cap_grad"] > 0, "cap_grad was not launched on the full-layer path")
    same_caps = bool(torch.equal(aux0, ref["aux0"]))
    cpu = torch.device("cpu")
    f64 = f0.to(cpu, torch.float64)
    dF_card = float((f64 - ref["f0"].to(cpu, torch.float64)).abs().max())
    dF_ref = float((f64 - ref["f_ref"]).abs().max())
    print(f"  step 0 (cold-cap offsets bitwise equal to phase 4's: {same_caps}): "
          f"vs K1-K3 on the card |dE| {abs(float(e0) - float(ref['e0'])):.3e} eV, "
          f"max|dF| {dF_card:.3e} eV/A; vs CPU float64 plain |dE| "
          f"{abs(float(e0) - float(ref['e_ref'])):.3e} eV, max|dF| {dF_ref:.3e} eV/A "
          f"(limit {FORCE_LIMIT})")
    need(same_caps, "the full-layer run started from other cap offsets than phase 4")
    need(dF_card <= FORCE_LIMIT, f"step-0 forces differ from the K1-K3 path by {dF_card:.3e}")
    need(dF_ref <= FORCE_LIMIT, f"step-0 forces differ from the float64 reference by {dF_ref:.3e}")
    return launches, ms_step, graphed


def run_ensemble(torch, dev, prot, card, ref):
    """Phase 5: BASELINE config 5 through ReplicaEnsemble with remat=True
    (K1 without a stash, K7/K8), held against phase 4's step 0; one chunk
    with remat on and off.  Returns its launches."""
    from ai2bmd_torch.frag import runtime as RT
    from ai2bmd_torch.host import build_fragment_index
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.parallel import ReplicaEnsemble

    cfg = ViSNetConfig(remat=True)                 # 9 layers x 256, 8 heads, lmax 2
    params = init_params(cfg, torch.Generator().manual_seed(0))
    ens = ReplicaEnsemble.build(prot, build_fragment_index(prot.atoms), params, cfg,
                                n_replicas=N_REPLICAS, timestep_fs=1.0, temp_K=300.0,
                                friction_per_fs=0.001, replica_chunk=REPLICA_CHUNK, device=dev)
    need(ens.cfg.remat and not ens.cfg.fused_layer, f"ensemble config {ens.cfg}")
    batches = len(ens.rt.dip_buckets) + 1
    chunks = N_REPLICAS // REPLICA_CHUNK
    print(f"  {N_REPLICAS} replicas in {chunks} chunks of {REPLICA_CHUNK}; ViSNet batches per "
          f"chunk (fragments x slots): "
          f"{[(REPLICA_CHUNK * len(b.rows), b.width) for b in ens.rt.dip_buckets]} + ACE-NME "
          f"({REPLICA_CHUNK * ens.rt.ace_z16.shape[0]}, {ens.rt.ace_z16.shape[1]})")

    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ens.initial_state(prot.positions, temp_K=300.0, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    f_init = state.forces
    state = ens.run(state, 1)                      # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ens.run(state, ENSEMBLE_STEPS)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / ENSEMBLE_STEPS
    launches = dict(LAUNCHES)
    peak_run = torch.cuda.max_memory_allocated()
    evals = 2 + ENSEMBLE_STEPS
    print(f"  initial state {t_init:.1f} s; {state.step} steps; {evals} force evaluations; "
          f"launches {launches}; peak device memory {peak_run / 2**30:.2f} GiB")
    want = {"edge_fwd": chunks * batches * N_LAYERS, "edge_bwd_msg_rc": chunks * batches * N_LAYERS,
            "edge_bwd_upd_rc": chunks * batches * (N_LAYERS - 1),
            "edge_bwd_msg": 0, "edge_bwd_upd": 0, "vislayer_fwd": 0, "vislayer_bwd": 0,
            "tf32x3_mm": 0}
    for name, per_eval in want.items():
        need(launches[name] == per_eval * evals,
             f"{name}: {launches[name]} launches, expected {per_eval} x {evals} force evaluations")
    need(launches["cap_grad"] > 0, "cap_grad was not launched by the ensemble")
    need(bool(state.positions.isfinite().all() and state.forces.isfinite().all()
              and state.energy.isfinite().all()), "non-finite ensemble state")
    need(state.positions.shape == (N_REPLICAS, len(prot), 3), "ensemble positions shape")
    need(not bool(torch.equal(state.positions[0], state.positions[1])), "replicas did not diverge")
    profile_steps(torch, lambda s: ens.run(s, 1), state, n=1)

    cpu = torch.device("cpu")
    dF = float((f_init.to(cpu, torch.float64) - ref["f0"].to(cpu, torch.float64)[None])
               .abs().max())
    print(f"  initial forces of all {N_REPLICAS} replicas vs phase 4's step 0: max|dF| "
          f"{dF:.3e} eV/A (limit {FORCE_LIMIT})")
    need(dF <= FORCE_LIMIT, f"ensemble initial forces differ from phase 4 by {dF:.3e}")

    # one chunk with remat on and off: the same forces, the memory they hold
    Ps, deltas = state.positions[:REPLICA_CHUNK], state.aux[:REPLICA_CHUNK]
    forces, peaks = {}, {}
    for remat in (True, False):
        c = dataclasses.replace(ens.cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, forces[remat], _ = RT.ensemble_fragment_energy_forces_warm(
            ens.params, ens.rt, Ps, c, deltas, replica_chunk=REPLICA_CHUNK)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(), base)
        print(f"  one chunk (R = {REPLICA_CHUNK}), remat={remat}: max_memory_allocated "
              f"{peaks[remat][0] / 2**20:.1f} MiB, {(peaks[remat][0] - base) / 2**20:.1f} MiB "
              f"above the {base / 2**20:.1f} MiB held before the call")
    dF = float((forces[True] - forces[False]).abs().max())
    ratio = (peaks[True][0] - peaks[True][1]) / (peaks[False][0] - peaks[False][1])
    print(f"  remat=True vs remat=False forces: max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT}); "
          f"peak above the base, True / False: {ratio:.3f}")
    need(dF <= FORCE_LIMIT, f"remat changed the forces by {dF:.3e}")
    print(f"  ensemble: {ms_step:.3f} ms/step, {ms_step / N_REPLICAS:.4f} ms per replica-step, "
          f"{N_REPLICAS * 86.4 / ms_step:.3f} ns/day aggregate over {ENSEMBLE_STEPS} steps "
          f"(smoke figure, not a benchmark; host clock, synchronised)")
    print(f"  {card}")
    return launches


# Phase 6 runs vacuum Chignolin with random weights, which heats past the
# Simulator's runaway guard (1.5 x 300 K) within ~10-20 fs (PERF.md, section
# 6).  The guard stays; the runs step at a shorter timestep so that they stay
# under it.  A step's work does not depend on the timestep.
USER_DT_FS = 0.05             # the library run (60 steps) and the continuity runs (30 steps)
TIMING_DT_FS = 0.01           # the CLI timing run (300 steps)
PREEQ_STEPS, RECORD, PROD_STEPS = 4, 10, 40
CLI_STEPS, CLI_RECORD = 300, 100
ENSEMBLE_CLI = ["--replicas", "8", "--sim-steps", "4", "--record-per-steps", "2"]
# the H-bond restraint's thresholds are shortened by this much (A) for one
# replayed interval, so that the H-X springs pull inside the captured step
HBOND_PULL = 0.3
# a restarted run against an uninterrupted one, 30 steps at USER_DT_FS: only
# the stitch's atomic sums may part them (on the H100 sound runs read
# max|dx| 0 and max|dv| below 1e-8)
RESTART_LIMIT = 1e-6          # A and A/t


def _cli_cmd(log_dir, *args, prot_file="examples/chig.pdb"):
    return [sys.executable, "-m", "ai2bmd_torch", "--prot-file", prot_file,
            "--log-dir", log_dir, "--no-solvent", *args]


def _cli_wait(name, proc, timeout=600):
    """Wait for a CLI subprocess (killed at ``timeout``); fail on a nonzero
    exit with the end of its output."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise RuntimeError(f"CLI run {name} did not finish in {timeout} s")
    need(proc.returncode == 0, f"CLI run {name} exited {proc.returncode}:\n{out[-3000:]}\n"
                               f"{err[-3000:]}")
    return out


def _cli_start(cmd, fused_layer=False):
    """Start a CLI subprocess; ``fused_layer`` sets AI2BMD_FUSED_LAYER=1 in its
    environment, as a user selects the full-layer kernels."""
    env = {k: v for k, v in os.environ.items() if k != "AI2BMD_FUSED_LAYER"}
    if fused_layer:
        env["AI2BMD_FUSED_LAYER"] = "1"
    return subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)


def _metrics(path):
    rows = open(path).read().splitlines()
    need(rows and rows[0].startswith("step,"), f"{path} has no header")
    return [dict(zip(rows[0].split(","), map(float, r.split(",")))) for r in rows[1:]]


def run_user_library(torch, dev, root, ref):
    """Phase 6a: ProteinSimulation.from_pdb at 9 x 256 on the card,
    PREEQ_STEPS a ladder stage, then simulate(PROD_STEPS): launch counters,
    replay count, the first forces against phase 4's step 0, the first record
    interval after the ladder against eager steps from the same state and
    generator state, the same with every H-bond spring pulling, a profiled
    record interval, the files.  The run has the H-bond restraint on."""
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.md.constraints import restraint_energy_forces
    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.simulators import ProteinSimulation
    from ai2bmd_torch.io.trajectory import read_dcd

    log_dir = os.path.join(root, "library")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ps = ProteinSimulation.from_pdb(
        "examples/chig.pdb", log_dir=log_dir, model_cfg=ViSNetConfig(),
        sim_cfg=SimulationConfig(timestep_fs=USER_DT_FS, preeq_steps=PREEQ_STEPS,
                                 record_per_steps=RECORD, hydrogen_constraints=True),
        device=dev)
    sim = ps.sim
    need(sim.hbond is not None and len(sim.hbond.pairs) == 78, "no H-bond restraint")
    calls = []                          # (state in, generator state before, state out)
    advance = sim.advance

    def recorded(state, n):
        before = sim.generator.get_state()
        out = advance(state, n)
        calls.append((state, before, out))
        return out

    sim.advance = recorded
    lines = []
    final = ps.simulate(PROD_STEPS, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    stages = len(sim.cfg.preeq_restraints_kcal)
    print(f"  from_pdb + simulate({PROD_STEPS}) after {stages} x {PREEQ_STEPS} ladder steps at "
          f"{USER_DT_FS} fs: {wall:.1f} s; {lines[-2]}")
    print(f"  launches {launches}; graph replays {sim.graph.replays}")
    for name in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad"):
        need(launches[name] > 0, f"{name} was not launched on the user path")
    need(sim.graph.replays == stages * PREEQ_STEPS + PROD_STEPS,
         f"{sim.graph.replays} replays, expected {stages * PREEQ_STEPS + PROD_STEPS}")
    need(final.step == stages * PREEQ_STEPS + PROD_STEPS, f"final step {final.step}")

    cpu = torch.device("cpu")
    dF0 = float((calls[0][0].forces.to(cpu, torch.float64)
                 - ref["f0"].to(cpu, torch.float64)).abs().max())

    def against_eager(s_in, gen_state, got, what):
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        s = s_in
        for _ in range(RECORD):
            s = L.langevin_step(sim.full_potential, sim.coeffs, sim.masses, s, generator=g)
        dx = float((got.positions - s.positions).abs().max())
        dF = float((got.forces - s.forces).abs().max())
        print(f"  {what}, replays vs eager steps from the same state and generator state: "
              f"max|dx| {dx:.3e} A, max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT})")
        need(dx <= FORCE_LIMIT and dF <= FORCE_LIMIT,
             f"{what}: replays differ from eager steps: dx {dx:.3e}, dF {dF:.3e}")

    print(f"  initial forces vs phase 4's step 0: max|dF| {dF0:.3e} eV/A (limit {FORCE_LIMIT})")
    need(dF0 <= FORCE_LIMIT, f"user-path initial forces differ from phase 4 by {dF0:.3e}")
    against_eager(*calls[stages], "first record interval after the ladder")
    need(bool(final.positions.isfinite().all() and final.forces.isfinite().all()
              and final.energy.isfinite()), "non-finite final state on the user path")
    # the graph reads the thresholds where they lie: shortened in place,
    # every spring pulls in the replays that follow
    rt = sim.hbond.rt.clone()
    sim.hbond.rt.sub_(HBOND_PULL)
    e_r, f_r = restraint_energy_forces(sim.hbond, final.positions)
    pairs = sim.hbond.pairs
    bond = (final.positions[pairs[:, 0]] - final.positions[pairs[:, 1]]).norm(dim=-1)
    n_pull = int((bond > sim.hbond.rt).sum())
    print(f"  H-bond thresholds shortened by {HBOND_PULL} A: {n_pull} of {len(pairs)} springs "
          f"pull, restraint {float(e_r):.3f} eV, max|F| {float(f_r.abs().max()):.3f} eV/A")
    need(float(e_r) > 1.0 and 2 * n_pull >= len(pairs), "the restraint does not pull")
    gen_state = sim.generator.get_state()
    against_eager(final, gen_state, sim.advance(final, RECORD),
                  "a record interval with every H-bond spring pulling")
    sim.hbond.rt.copy_(rt)

    prof = profile_steps(torch, lambda st: sim.advance(st, RECORD), final, n=1,
                         label="replayed steps of one record interval", steps_per_call=RECORD)
    for name in ("cap_grad_kernel", *EDGE_KERNELS):
        need(any(name in n for n in prof["names"]), f"the user path's trace names no {name}")
    rows = _metrics(os.path.join(log_dir, "chig-metrics.csv"))
    frames = read_dcd(os.path.join(log_dir, "chig-traj.dcd"))
    xyz = open(os.path.join(log_dir, "chig-traj.xyz")).read().count("step=")
    n_rec = PROD_STEPS // RECORD
    need(len(rows) == n_rec and frames.shape == (n_rec, 175, 3) and xyz == n_rec,
         f"files: {len(rows)} metrics rows, DCD {frames.shape}, {xyz} XYZ frames; want {n_rec}")
    need(os.path.exists(os.path.join(log_dir, "chig-restart.npz")), "no restart file")
    need(all(map(math.isfinite, (r["epot_eV"] for r in rows))) and bool(
        torch.isfinite(torch.as_tensor(frames)).all()), "non-finite energies or frames")
    print(f"  files: {n_rec} XYZ / DCD frames and metrics rows, a restart file; the trace names "
          f"cap_grad_kernel and {', '.join(EDGE_KERNELS)}")


def run_user_cli(torch, root, graphed_ms, card):
    """Phase 6b/6c: the CLI as subprocesses.  A timing run of CLI_STEPS steps
    alone; then, side by side, an interrupted run (20 steps), an
    uninterrupted one (30 steps) and the 8-replica ensemble; then the restart
    of the interrupted run (10 steps), held to the uninterrupted run's
    restart file (RESTART_LIMIT, FORCE_LIMIT, the generator state bitwise).
    Returns the CLI's steady ms/step."""
    import numpy as np

    from ai2bmd_torch.io.trajectory import read_dcd

    d = lambda name: os.path.join(root, name)
    t0 = time.perf_counter()
    out = _cli_wait("timing", _cli_start(_cli_cmd(
        d("timing"), "--preeq-steps", "0", "--sim-steps", str(CLI_STEPS), "--record-per-steps",
        str(CLI_RECORD), "--timestep", str(TIMING_DT_FS))))
    wall = time.perf_counter() - t0
    need("Simulation finished!" in out, "the timing run did not finish")
    rows = _metrics(d("timing/chig-metrics.csv"))
    need(len(rows) == CLI_STEPS // CLI_RECORD, f"{len(rows)} metrics rows")
    steady = [r["ms_per_step"] for r in rows[1:]]
    cli_ms = sum(steady) / len(steady)
    dcd = read_dcd(d("timing/chig-traj.dcd"))
    xyz_lines = open(d("timing/chig-traj.xyz")).read().splitlines()
    xyz = np.array([[float(v) for v in ln.split()[1:4]] for ln in xyz_lines
                    if len(ln.split()) == 4]).reshape(dcd.shape)
    dxyz = float(np.abs(dcd - xyz).max())
    need(dxyz <= 1e-5, f"DCD and XYZ frames differ by {dxyz:.3e} A")
    print(f"  CLI timing run, {CLI_STEPS} steps at {TIMING_DT_FS} fs, record every "
          f"{CLI_RECORD}: exit 0 in {wall:.1f} s (process start, kernels loaded, cold caps, "
          f"capture); metrics ms/step {[r['ms_per_step'] for r in rows]}; DCD vs XYZ frames "
          f"max {dxyz:.1e} A")
    print(f"  CLI steady {cli_ms:.3f} ms/step ({86.4 * TIMING_DT_FS / cli_ms:.4f} ns/day at "
          f"{TIMING_DT_FS} fs, {86.4 / cli_ms:.4f} at 1 fs) against phase 4's graphed "
          f"{graphed_ms:.3f} ms/step ({card})")

    cont = ["--preeq-steps", "0", "--record-per-steps", "10", "--timestep", str(USER_DT_FS),
            "--constraints"]
    t0 = time.perf_counter()
    procs = {"interrupted": _cli_start(_cli_cmd(d("restart"), *cont, "--sim-steps", "20")),
             "uninterrupted": _cli_start(_cli_cmd(d("straight"), *cont, "--sim-steps", "30")),
             "ensemble": _cli_start(_cli_cmd(d("ensemble"), *ENSEMBLE_CLI))}
    outs = {name: _cli_wait(name, p) for name, p in procs.items()}
    _cli_wait("restart", _cli_start(_cli_cmd(d("restart"), *cont, "--sim-steps", "10",
                                             "--restart")))
    wall = time.perf_counter() - t0
    frames = read_dcd(d("restart/chig-traj-restart.dcd"))
    last = _metrics(d("restart/chig-metrics.csv"))[-1]["step"]
    need(frames.shape == (1, 175, 3), f"chig-traj-restart.dcd holds {frames.shape}")
    need(last == 30, f"the restarted run's last metrics row is at step {last}")
    with np.load(d("restart/chig-restart.npz")) as a, np.load(d("straight/chig-restart.npz")) as b:
        need(int(a["step"]) == int(b["step"]) == 30, "restart files not at step 30")
        dx = float(np.abs(a["positions"] - b["positions"]).max())
        dv = float(np.abs(a["velocities"] - b["velocities"]).max())
        dF = float(np.abs(a["forces"] - b["forces"]).max())
        same_rng = np.array_equal(a["rng_state"], b["rng_state"])
    print(f"  CLI continuity at {USER_DT_FS} fs with --constraints: 20 steps, then --restart 10, "
          f"against 30 straight: max|dx| {dx:.3e} A, max|dv| {dv:.3e} A/t (limit "
          f"{RESTART_LIMIT}), max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT}), generator states "
          f"{'equal' if same_rng else 'DIFFERENT'}; chig-traj-restart.dcd 1 frame, last metrics "
          f"row at step 30")
    need(same_rng, "the restarted run's generator state differs from the uninterrupted run's")
    need(dx <= RESTART_LIMIT and dv <= RESTART_LIMIT and dF <= FORCE_LIMIT,
         f"the restarted run left the uninterrupted one: dx {dx:.3e}, dv {dv:.3e}, dF {dF:.3e}")

    ens = d("ensemble")
    dcds = sorted(f for f in os.listdir(ens) if f.endswith(".dcd"))
    need(len(dcds) == 8 and all(read_dcd(os.path.join(ens, f)).shape == (2, 175, 3)
                                for f in dcds), f"ensemble DCDs {dcds}")
    need(os.path.exists(os.path.join(ens, "8x-ensemble-final.npz")), "no ensemble final npz")
    print(f"  CLI {' '.join(ENSEMBLE_CLI)}: exit 0, 8 DCDs of 2 frames, 8x-ensemble-final.npz; "
          f"{outs['ensemble'].strip().splitlines()[-2]}; the four runs took {wall:.1f} s")
    return cli_ms


# Phase 7: one force evaluation of whole-molecule mode launches K1 once a
# layer, K2 once a layer and K3 on the 8 updating layers (K7/K8 in their
# place with remat), or with fused_layer K5 and K6 once a layer, and no cap
# kernel
WHOLE_DT_FS = 0.05            # the library run's timestep, as USER_DT_FS
WHOLE_A = {"chig": 176, "abd": 752}


def whole_launches(remat: bool = False, fused: bool = False) -> dict:
    want = dict.fromkeys(("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "edge_bwd_msg_rc",
                          "edge_bwd_upd_rc", "cap_grad", "vislayer_fwd", "vislayer_bwd",
                          "tf32x3_mm"), 0)
    if fused:
        want.update(vislayer_fwd=N_LAYERS, vislayer_bwd=N_LAYERS)
        return want
    msg, upd = ("edge_bwd_msg_rc", "edge_bwd_upd_rc") if remat else ("edge_bwd_msg",
                                                                     "edge_bwd_upd")
    want.update(edge_fwd=N_LAYERS, **{msg: N_LAYERS, upd: N_LAYERS - 1})
    return want


def cli_model_line(txt, want):
    """The CLI's line naming the kernels its model runs; fails unless it
    names ``want``."""
    line = next((ln for ln in txt.splitlines() if ln.startswith("ViSNet ")), "")
    need(want in line, f"the CLI ran {line!r}, not {want}")
    return line


def run_whole_molecule(torch, dev, prot, card, root):
    """Phase 7: whole-molecule mode at 9 x 256.  (a) the checkpoint round
    trip, (b) Chignolin through ViSNetPotential with the CPU float64
    reference and the graphed step, (c) the CLI with --mode visnet
    --ckpt-path, (d) abd with remat on and off, (e) Chignolin and abd
    through the full-layer kernels K5/K6 (fused_layer), held against (b)
    and (d).  Returns its figures."""
    import numpy as np

    from ai2bmd_torch.host import example_pdb, load_protein
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.models.checkpoint import save_converted
    from ai2bmd_torch.models.params import flatten, init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import ViSNetPotential
    from ai2bmd_torch.simulators import load_model

    t_phase = time.perf_counter()
    out = {}
    # (a) phase 4's weights through save_converted and load_model
    cfg = ViSNetConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    os.makedirs(root, exist_ok=True)
    npz = os.path.join(root, "visnet-chig-9x256.npz")
    save_converted(npz, params, cfg)
    params2, cfg2 = load_model(npz)
    a, b = flatten(params), flatten(params2)
    same = len(a) == len(b) and all(pa == pb and torch.equal(x, y) for (pa, x), (pb, y) in zip(a, b))
    print(f"  (a) save_converted -> {os.path.relpath(npz)} ({os.path.getsize(npz) / 2**20:.1f} "
          f"MiB), load_model: {len(b)} leaves bitwise equal: {same}; config equal: {cfg2 == cfg}")
    need(same and cfg2 == cfg, "the converted checkpoint does not read back bitwise")

    # (b) Chignolin as one molecule
    pot = ViSNetPotential.build(prot.numbers, ViSNet(cfg2, params2), cfg2, device=dev)
    need(pot.pad_to == WHOLE_A["chig"], f"Chignolin padded to {pot.pad_to}")
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    pot.energy_forces(P)                     # kernels loaded, caches warm
    torch.cuda.synchronize()
    reset_launches()
    e0, f0 = pot.energy_forces(P)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"  (b) Chignolin, {len(prot)} atoms as one molecule of {pot.pad_to} slots; one force "
          f"evaluation launches {launches}")
    for name, n in whole_launches(False).items():
        need(launches[name] == n, f"{name}: {launches[name]} launches, expected {n}")
    out["launches"] = launches
    t0 = time.perf_counter()
    pot64 = ViSNetPotential.build(prot.numbers, ViSNet(cfg2, params2).to(torch.float64), cfg2,
                                  device="cpu")
    e_ref, f_ref = pot64.energy_forces(P.to("cpu", torch.float64))
    dF = float((f0.to("cpu", torch.float64) - f_ref).abs().max())
    print(f"  step 0 vs CPU float64 plain: |dE| {abs(float(e0) - float(e_ref)):.3e} eV, max|dF| "
          f"{dF:.3e} eV/A (limit {FORCE_LIMIT}); max|F| {float(f_ref.abs().max()):.3f} eV/A; "
          f"reference took {time.perf_counter() - t0:.1f} s")
    need(dF <= FORCE_LIMIT, f"whole-molecule step-0 forces differ from float64 by {dF:.3e}")
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, WHOLE_DT_FS, 300.0, 0.001, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0), f0, e0)
    out["graphed"] = drive_graphed(torch, L.lift_potential(pot.energy_forces), coeffs, masses,
                                   state, gen, card, EDGE_KERNELS)
    need(not any("cap_grad" in n for n in out["graphed"]["names"]),
         "the whole-molecule trace names a cap kernel")

    # (c) the CLI on that checkpoint
    d = os.path.join(root, "whole")
    t0 = time.perf_counter()
    txt = _cli_wait("whole-molecule", _cli_start(_cli_cmd(
        d, "--mode", "visnet", "--ckpt-path", npz, "--preeq-steps", "0", "--sim-steps",
        str(CLI_STEPS), "--record-per-steps", str(CLI_RECORD), "--timestep", str(TIMING_DT_FS))))
    wall = time.perf_counter() - t0
    need("Simulation finished!" in txt, "the whole-molecule CLI run did not finish")
    rows = _metrics(os.path.join(d, "chig-metrics.csv"))
    need(len(rows) == CLI_STEPS // CLI_RECORD, f"{len(rows)} metrics rows")
    out["cli_ms"] = sum(r["ms_per_step"] for r in rows[1:]) / (len(rows) - 1)
    with np.load(os.path.join(d, "chig-restart.npz")) as r:
        P_r, F_r, step_r = r["positions"], r["forces"], int(r["step"])
    _, f_r = pot.energy_forces(torch.as_tensor(P_r, device=dev))
    dF_cli = float(np.abs(f_r.cpu().numpy() - F_r).max())
    print(f"  (c) python -m ai2bmd_torch --mode visnet --ckpt-path {os.path.relpath(npz)}, "
          f"{CLI_STEPS} steps at {TIMING_DT_FS} fs: exit 0 in {wall:.1f} s; metrics ms/step "
          f"{[r['ms_per_step'] for r in rows]}; steady {out['cli_ms']:.3f} against (b)'s graphed "
          f"{out['graphed']['ms_step']:.3f}; its forces at step {step_r} (restart file) against "
          f"(b)'s potential at the same positions: max|dF| {dF_cli:.3e} eV/A "
          f"(limit {FORCE_LIMIT})")
    need(step_r == CLI_STEPS and dF_cli <= FORCE_LIMIT,
         f"the CLI's forces differ from the library's by {dF_cli:.3e} at step {step_r}")
    print(f"  the CLI's model: {cli_model_line(txt, 'edge-core kernels K1-K3')}")
    del pot, pot64, state

    # (d) abd as one molecule, remat on and off
    abd = load_protein(example_pdb("abd"))
    P_abd = torch.as_tensor(abd.positions, dtype=torch.float32, device=dev)
    forces, out["abd_peak_gib"], out["abd_launches"] = {}, {}, {}
    for remat in (True, False):
        c = dataclasses.replace(cfg2, remat=remat)
        pa = ViSNetPotential.build(abd.numbers, ViSNet(c, params2), c, device=dev)
        need(pa.pad_to == WHOLE_A["abd"], f"abd padded to {pa.pad_to}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        _, forces[remat] = pa.energy_forces(P_abd)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = out["abd_launches"][remat] = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        out["abd_peak_gib"][remat] = peak / 2**30
        print(f"  (d) abd, {len(abd)} atoms as one molecule of {pa.pad_to} slots, remat={remat}: "
              f"one force evaluation {secs:.2f} s (first at this shape); launches {launches}; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above "
              f"the {base / 2**30:.2f} held before)")
        for name, n in whole_launches(remat).items():
            need(launches[name] == n, f"abd remat={remat}: {name} {launches[name]}, expected {n}")
        need(bool(forces[remat].isfinite().all()), f"abd remat={remat}: non-finite forces")
        del pa
    dF = float((forces[True] - forces[False]).abs().max())
    print(f"  abd remat=True vs remat=False: max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT})")
    need(dF <= FORCE_LIMIT, f"abd: remat changed the forces by {dF:.3e}")
    run_whole_fused(torch, dev, prot, card, root, cfg2, params2, npz, P, f0, f_ref, abd,
                    forces[False], out)
    print(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


def run_whole_fused(torch, dev, prot, card, root, cfg, params, npz, P, f0, f_ref, abd,
                    f_abd, out):
    """Phase 7(e): whole-molecule mode through K5/K6 (fused_layer=True).
    Chignolin: launches of one evaluation (K5 9, K6 9, nothing else), step 0
    against (b)'s CPU float64 forces and (b)'s K1-K3 forces, the graphed
    step (5 replays against eager steps, timed replays, a trace naming
    K5/K6's stages) beside (b)'s in this call, and the CLI under
    AI2BMD_FUSED_LAYER=1; then abd, one evaluation, its peak memory and its
    forces against (d)'s K1-K3 run."""
    import numpy as np

    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import ViSNetPotential

    cfg_f = dataclasses.replace(cfg, fused_layer=True)
    pot = ViSNetPotential.build(prot.numbers, ViSNet(cfg_f, params), cfg_f, device=dev)
    need(pot.cfg.fused_layer and pot.pad_to == WHOLE_A["chig"], f"fused potential {pot.cfg}")
    pot.energy_forces(P)
    torch.cuda.synchronize()
    reset_launches()
    e1, f1 = pot.energy_forces(P)
    torch.cuda.synchronize()
    launches = out["fused_launches"] = dict(LAUNCHES)
    print(f"  (e) Chignolin as one molecule through K5/K6: one force evaluation launches "
          f"{launches}")
    for name, n in whole_launches(fused=True).items():
        need(launches[name] == n, f"fused: {name}: {launches[name]} launches, expected {n}")
    cpu = torch.device("cpu")
    f64 = f1.to(cpu, torch.float64)
    dF_ref = float((f64 - f_ref).abs().max())
    dF_edge = float((f64 - f0.to(cpu, torch.float64)).abs().max())
    print(f"  step 0 vs CPU float64 plain: max|dF| {dF_ref:.3e} eV/A; vs K1-K3 on the card "
          f"(b): max|dF| {dF_edge:.3e} eV/A (limit {FORCE_LIMIT})")
    need(dF_ref <= FORCE_LIMIT, f"K5/K6 whole-molecule forces differ from float64 by {dF_ref:.3e}")
    need(dF_edge <= FORCE_LIMIT, f"K5/K6 whole-molecule forces differ from K1-K3 by {dF_edge:.3e}")
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, WHOLE_DT_FS, 300.0, 0.001, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0), f1, e1)
    out["fused_graphed"] = drive_graphed(torch, L.lift_potential(pot.energy_forces), coeffs,
                                         masses, state, gen, card, LAYER_KERNELS)
    names = out["fused_graphed"]["names"]
    need(not any("cap_grad" in n or "edge_fwd_kernel" in n for n in names),
         "the K5/K6 whole-molecule trace names a cap or K1 kernel")
    print(f"  graphed ms/step in this call: K5/K6 {out['fused_graphed']['ms_step']:.3f} "
          f"(events {out['fused_graphed']['ms_events']:.3f}), K1-K3 (b) "
          f"{out['graphed']['ms_step']:.3f} (events {out['graphed']['ms_events']:.3f}); {card}")

    d = os.path.join(root, "whole_fused")
    t0 = time.perf_counter()
    txt = _cli_wait("whole-molecule K5/K6", _cli_start(_cli_cmd(
        d, "--mode", "visnet", "--ckpt-path", npz, "--preeq-steps", "0", "--sim-steps",
        str(CLI_STEPS), "--record-per-steps", str(CLI_RECORD), "--timestep", str(TIMING_DT_FS)),
        fused_layer=True))
    wall = time.perf_counter() - t0
    need("Simulation finished!" in txt, "the K5/K6 whole-molecule CLI run did not finish")
    line = cli_model_line(txt, "full-layer kernels K5/K6")
    rows = _metrics(os.path.join(d, "chig-metrics.csv"))
    need(len(rows) == CLI_STEPS // CLI_RECORD, f"{len(rows)} metrics rows")
    out["fused_cli_ms"] = sum(r["ms_per_step"] for r in rows[1:]) / (len(rows) - 1)
    with np.load(os.path.join(d, "chig-restart.npz")) as r:
        P_r, F_r, step_r = r["positions"], r["forces"], int(r["step"])
    _, f_r = pot.energy_forces(torch.as_tensor(P_r, device=dev))
    dF_cli = float(np.abs(f_r.cpu().numpy() - F_r).max())
    print(f"  AI2BMD_FUSED_LAYER=1 python -m ai2bmd_torch --mode visnet --ckpt-path "
          f"{os.path.relpath(npz)}: {line!r}; exit 0 in {wall:.1f} s; metrics ms/step "
          f"{[r['ms_per_step'] for r in rows]}; steady {out['fused_cli_ms']:.3f} against (c)'s "
          f"{out['cli_ms']:.3f}; its forces at step {step_r} against (e)'s potential: max|dF| "
          f"{dF_cli:.3e} eV/A (limit {FORCE_LIMIT})")
    need(step_r == CLI_STEPS and dF_cli <= FORCE_LIMIT,
         f"the K5/K6 CLI's forces differ from the library's by {dF_cli:.3e} at step {step_r}")
    del pot, state

    P_abd = torch.as_tensor(abd.positions, dtype=torch.float32, device=dev)
    pa = ViSNetPotential.build(abd.numbers, ViSNet(cfg_f, params), cfg_f, device=dev)
    need(pa.pad_to == WHOLE_A["abd"], f"abd padded to {pa.pad_to}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    _, f_fused = pa.energy_forces(P_abd)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    out["abd_peak_gib"]["fused"] = peak / 2**30
    dF = float((f_fused - f_abd).abs().max())
    print(f"  (e) abd, {len(abd)} atoms as one molecule of {pa.pad_to} slots, through K5/K6: "
          f"one force evaluation {secs:.2f} s (first at this shape); launches {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
          f"{base / 2**30:.2f} held before); against (d)'s K1-K3 forces max|dF| {dF:.3e} eV/A "
          f"(limit {FORCE_LIMIT})")
    for name, n in whole_launches(fused=True).items():
        need(launches[name] == n, f"abd K5/K6: {name} {launches[name]}, expected {n}")
    need(bool(f_fused.isfinite().all()), "abd K5/K6: non-finite forces")
    need(dF <= FORCE_LIMIT, f"abd: K5/K6 forces differ from K1-K3 by {dF:.3e}")
    del pa


# Phase 8: the repaired faults on the card.  The CLI's tiny preset: 2 x 32,
# 4 heads of 8 channels (cli.py)
TINY = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)
SOLVATED = "examples/chig_preprocessed/chig-preeq.pdb"
COLD_STEPS = 5                # warm_caps=False: replays held against eager steps
EDGE_PATH = ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd")
LAYER_PATH = ("vislayer_fwd", "vislayer_bwd")


def run_faults(torch, dev, card, root, warm_ms):
    """Phase 8: (a) ProteinSimulation.from_pdb with the tiny preset (heads of
    8 channels) and no device, through K1-K3 and, with AI2BMD_FUSED_LAYER=1,
    K5/K6: the launches of the cold start and step 0, step 0 against the
    port on the CPU in float64 from the same cold caps, 3 graphed steps;
    (b) warm_caps=False at 9 x 256: the stateless step (a cold 10-iteration
    cap solve) captured, COLD_STEPS replays against eager steps from the
    same state and generator state, TIMED_STEPS replays timed beside phase
    4's warm step; (c) `python -m ai2bmd_torch --no-solvent` on the
    solvated Chignolin box runs its protein in vacuum."""
    from ai2bmd_torch.host import load_protein
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import FragmentPotential
    from ai2bmd_torch.simulators import WARM_ITERS, ProteinSimulation, load_model
    from ai2bmd_torch.io.trajectory import read_dcd

    cpu = torch.device("cpu")
    sim_cfg = SimulationConfig(timestep_fs=USER_DT_FS, preeq_steps=0, record_per_steps=RECORD)
    tiny = ViSNetConfig(**TINY)
    for fused in (False, True):
        old = os.environ.pop("AI2BMD_FUSED_LAYER", None)
        if fused:
            os.environ["AI2BMD_FUSED_LAYER"] = "1"
        try:
            torch.cuda.synchronize()
            reset_launches()
            ps = ProteinSimulation.from_pdb("examples/chig.pdb", log_dir=os.path.join(
                root, f"tiny{'_fused' if fused else ''}"), model_cfg=tiny, sim_cfg=sim_cfg)
            state = ps.sim.initial_state(ps.prot.positions)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        finally:
            os.environ.pop("AI2BMD_FUSED_LAYER", None)
            if old is not None:
                os.environ["AI2BMD_FUSED_LAYER"] = old
        path, other = (LAYER_PATH, EDGE_PATH) if fused else (EDGE_PATH, LAYER_PATH)
        need(state.forces.is_cuda and ps.potential.cfg.fused_layer == fused,
             f"tiny preset on {state.forces.device}, fused_layer {ps.potential.cfg.fused_layer}")
        for name in (*path, "cap_grad"):
            need(launches[name] > 0, f"tiny preset: {name} was not launched")
        for name in (*other, "edge_bwd_msg_rc", "edge_bwd_upd_rc"):
            need(launches[name] == 0, f"tiny preset: {name} ran")
        params, _ = load_model(None, tiny)
        pot64 = FragmentPotential.build(ps.prot, ViSNet(tiny, params).to(torch.float64), tiny,
                                        device="cpu")
        P64 = torch.as_tensor(ps.prot.positions, dtype=torch.float64)
        _, f_ref, _ = pot64.stateful_energy_forces(
            P64, ps.sim._init_aux.to(cpu, torch.float64), warm_iters=WARM_ITERS)
        dF = float((state.forces.to(cpu, torch.float64) - f_ref).abs().max())
        s3 = ps.sim.advance(state, 3)
        need(ps.sim.graph.replays == 3 and bool(s3.positions.isfinite().all()
                                                 and s3.forces.isfinite().all()),
             "tiny preset: the graphed steps failed")
        ran = {n: launches[n] for n in (*path, "cap_grad")}
        print(f"  (a) tiny preset (2 x 32, 4 heads of 8 channels), "
              f"{'AI2BMD_FUSED_LAYER=1' if fused else 'default'}: cold start + step 0 launch "
              f"{ran} and no "
              f"{', '.join(other)}; step 0 vs CPU float64 plain max|dF| {dF:.3e} eV/A "
              f"(limit {FORCE_LIMIT}), max|F| {float(f_ref.abs().max()):.3f}; 3 graphed steps")
        need(dF <= FORCE_LIMIT, f"tiny preset: step-0 forces differ from float64 by {dF:.3e}")
        del ps, pot64

    ps = ProteinSimulation.from_pdb("examples/chig.pdb", log_dir=os.path.join(root, "cold"),
                                    model_cfg=ViSNetConfig(), sim_cfg=sim_cfg, warm_caps=False)
    sim = ps.sim
    need(sim._init_aux is None, "warm_caps=False carries cap offsets")
    state = sim.initial_state(ps.prot.positions)
    gen_state = sim.generator.get_state()
    t0 = time.perf_counter()
    got = sim.advance(state, COLD_STEPS)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    need(sim.graph is not None and sim.graph.replays == COLD_STEPS, "no graph captured")
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    ref = state
    for _ in range(COLD_STEPS):
        ref = L.langevin_step(sim.full_potential, sim.coeffs, sim.masses, ref, generator=g)
    dx = float((got.positions - ref.positions).abs().max())
    dF = float((got.forces - ref.forces).abs().max())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    final = sim.graph.run(TIMED_STEPS)
    end.record()
    torch.cuda.synchronize()
    cold_ms = start.elapsed_time(end) / TIMED_STEPS
    need(bool(final.positions.isfinite().all() and final.forces.isfinite().all()),
         "warm_caps=False: non-finite state")
    print(f"  (b) warm_caps=False, 9 x 256: the stateless step (cap solve of "
          f"{ps.potential.rt.opt_iters} L-BFGS iterations a step) captured as one CUDA graph "
          f"({t_first:.1f} s with warm-up and capture); {COLD_STEPS} replays vs eager steps from "
          f"the same state and generator state: max|dx| {dx:.3e} A, max|dF| {dF:.3e} eV/A "
          f"(limit {FORCE_LIMIT}); {cold_ms:.3f} ms/step (CUDA events, {TIMED_STEPS} replays) "
          f"against phase 4's warm {warm_ms:.3f} ({card})")
    need(dx <= FORCE_LIMIT and dF <= FORCE_LIMIT,
         f"warm_caps=False: replays differ from eager steps: dx {dx:.3e}, dF {dF:.3e}")
    del ps, sim, state, got, ref, final

    n_prot = len(load_protein(SOLVATED).protein_indices())
    d = os.path.join(root, "no_solvent")
    t0 = time.perf_counter()
    txt = _cli_wait("--no-solvent", _cli_start(_cli_cmd(
        d, "--preeq-steps", "0", "--sim-steps", "20", "--record-per-steps", "10", "--timestep",
        str(USER_DT_FS), prot_file=SOLVATED)))
    wall = time.perf_counter() - t0
    need("Simulation finished!" in txt, "the --no-solvent run did not finish")
    frames = read_dcd(os.path.join(d, "chig-preeq-traj.dcd"))
    need(frames.shape == (2, n_prot, 3) and bool(torch.as_tensor(frames).isfinite().all()),
         f"--no-solvent DCD {frames.shape}, expected (2, {n_prot}, 3)")
    print(f"  (c) python -m ai2bmd_torch --prot-file {SOLVATED} --no-solvent, 20 steps: exit 0 "
          f"in {wall:.1f} s; {cli_model_line(txt, 'edge-core kernels K1-K3')!r}; the DCD holds "
          f"the {n_prot} protein atoms of the box")
    return cold_ms


# Phase 9: the solvated slice.  The float32 subtractive combiner cancels two
# large MM sums on the protein atoms only to ~1e-2 eV/A in both packages (the
# JAX package's own float32 spread on this box, ROADMAP.md Queue 3): protein
# atoms are held to that spread, solvent atoms to FORCE_LIMIT.
PROTEIN_SPREAD = 2e-2         # eV/A
JAX_PROTEIN_F32 = 1.27e-2     # eV/A: the JAX package's float32 against float64 on this box
SOLV_DT_FS = 0.05             # random weights: short in simulated time, as phase 6
SOLV_STEPS = 5                # replays held against eager steps
SETTLE_LIMIT = 1e-4           # A: rigid-water constraint violation after the steps
SOLV_CLI_STEPS, SOLV_CLI_RECORD = 30, 10
WIDE_HEADS = dict(num_layers=2, hidden_channels=256, num_heads=4)   # 4 heads of 64 channels
OTHER_ACT = dict(num_layers=2, hidden_channels=256, activation="tanh")   # the plain route
EIGHT_HEADS = dict(num_layers=2, hidden_channels=256)   # 8 heads of 32: 9(d)'s yardstick
ROUTE_TIMED = 20
QM_NAMES = ("edge_", "cap_grad", "vislayer")


def solvated_reference(torch, ps, P, cfg, params, **qmmm_kw):
    """The port on the CPU in float64 at the card's state: QMMMPotential of
    the whole box (plain versions; ``qmmm_kw`` for its build), the QM side
    from the card's cold cap offsets with one warm iteration.  Returns (E, F,
    seconds)."""
    from ai2bmd_torch.models.visnet import ViSNet
    from ai2bmd_torch.physics.qmmm import QMMMPotential
    from ai2bmd_torch.potentials import FragmentPotential
    from ai2bmd_torch.simulators import WARM_ITERS

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    prot = ps.prot.select(ps.prot.protein_indices())
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    device="cpu")
    qmmm64 = QMMMPotential.build(
        ps.prot.atoms, qm_stateful=lambda Pq, a: pot64.stateful_energy_forces(
            Pq, a, warm_iters=WARM_ITERS),
        qm_init_aux=ps.sim._init_aux[1].to(cpu, torch.float64), device="cpu",
        dtype=torch.float64, **qmmm_kw)
    P64 = P.to(cpu, torch.float64)
    e, f, _ = qmmm64(P64, qmmm64.init_aux(P64))
    return e, f, time.perf_counter() - t0


def graph_ms(torch, fn, reps=10):
    """ms of fn() captured alone as a CUDA graph (after two eager calls on a
    side stream), by CUDA events over reps replays: the part's device time
    without the host's issue time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(torch, graph.replay, reps)
    del graph
    return ms


def run_pme_fragment(torch, dev, prot, card, mm_graphed_ms):
    """Phase 9a: FragmentPotential(longrange="pme") on Chignolin's CRYST1
    cell at 9 x 256: launches of one evaluation, step 0 against the CPU
    float64 run from the same cold caps, the graphed step (replays against
    eager steps), ms/step beside phase 4's "mm" long range."""
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.potentials import FragmentPotential

    cfg = ViSNetConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    pot = FragmentPotential.build(prot, ViSNet(cfg, params), cfg, longrange="pme", device=dev)
    need(pot.pme is not None and pot.nb is None, "longrange='pme' built no PME")
    P = torch.as_tensor(prot.positions, dtype=torch.float32, device=dev)
    aux0 = pot.init_cap_delta(P)
    torch.cuda.synchronize()
    reset_launches()
    e0, f0, aux1 = pot.stateful_energy_forces(P, aux0)
    torch.cuda.synchronize()
    launches = {n: LAUNCHES[n] for n in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad")}
    need(all(v > 0 for v in launches.values()), f"PME evaluation launches {launches}")
    cpu = torch.device("cpu")
    pot64 = FragmentPotential.build(prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    longrange="pme", device="cpu")
    e_ref, f_ref, _ = pot64.stateful_energy_forces(P.to(cpu, torch.float64),
                                                   aux0.to(cpu, torch.float64))
    dF = float((f0.to(cpu, torch.float64) - f_ref).abs().max())
    print(f"  (a) FragmentPotential(longrange='pme'), cell {prot.cell.tolist()}, mesh "
          f"{pot.pme.grid}: one evaluation launches {launches}; step 0 vs CPU float64 |dE| "
          f"{abs(float(e0) - float(e_ref)):.3e} eV, max|dF| {dF:.3e} eV/A (limit {FORCE_LIMIT})")
    need(dF <= FORCE_LIMIT, f"PME step-0 forces differ from float64 by {dF:.3e}")
    masses = torch.as_tensor(prot.masses, dtype=torch.float32, device=dev)
    coeffs = L.LangevinCoeffs.build(prot.masses, 1.0, 300.0, 0.001, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = L.MDState(P, L.maxwell_boltzmann_velocities(gen, prot.masses, 300.0), f0, e0,
                      aux=aux1)
    g = drive_graphed(torch, pot.stateful_energy_forces, coeffs, masses, state, gen, card,
                      ("cap_grad_kernel", *EDGE_KERNELS))
    print(f"  (a) graphed 'pme' {g['ms_step']:.3f} ms/step (events {g['ms_events']:.3f}) beside "
          f"phase 4's 'mm' {mm_graphed_ms:.3f} ({card})")
    return launches, g


def run_solvated_sim(torch, dev, card, root, rigid: bool):
    """Phase 9b: ProteinSimulation.from_pdb on the solvated Chignolin box at
    9 x 256 (rigid_water as given): build seconds, step 0 against the port on
    the CPU in float64 (solvent and protein atoms apart), SOLV_STEPS graphed
    replays against eager steps, TIMED_STEPS replays timed, a profiled
    window, the QM and MM parts' device ms alone, peak memory."""
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.physics import cellpair as CP
    from ai2bmd_torch.physics import mm as MM
    from ai2bmd_torch.simulators import ProteinSimulation, load_model

    tag = "rigid water" if rigid else "flexible water"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim_cfg = SimulationConfig(timestep_fs=SOLV_DT_FS, preeq_steps=0, record_per_steps=RECORD)
    ps = ProteinSimulation.from_pdb(SOLVATED, log_dir=os.path.join(root, "solvated"),
                                    model_cfg=ViSNetConfig(), sim_cfg=sim_cfg, rigid_water=rigid)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    sim, qmmm = ps.sim, ps.qmmm
    need(qmmm is not None and qmmm.backend == "cellpair",
         f"solvated build: backend {getattr(qmmm, 'backend', None)}")
    need((sim.constraint is not None) == rigid, "rigid_water did not set SETTLE")
    state = sim.initial_state(ps.prot.positions)
    torch.cuda.synchronize()
    prot_idx = qmmm.sel.cpu()
    solvent = torch.ones(qmmm.n_atoms, dtype=torch.bool)
    solvent[prot_idx] = False
    out = dict(build_s=t_build)
    print(f"  (b) {tag}: from_pdb {t_build:.1f} s: {qmmm.n_atoms} atoms, {len(prot_idx)} in the "
          f"QM region, cells {qmmm.cp.nc3} x occ {qmmm.cp.occ} ({qmmm.cp.n_cells} cells, "
          f"{CP.default_chunk(qmmm.cp, dev)} a chunk), PME mesh {qmmm.mm_full.grid}")
    if not rigid:
        cfg, params = ps.potential.cfg, load_model(None, ViSNetConfig())[0]
        e_ref, f_ref, secs = solvated_reference(torch, ps, state.positions, cfg, params)
        dF = (state.forces.cpu().double() - f_ref).abs().max(-1).values
        dF_solv, dF_prot = float(dF[solvent].max()), float(dF[~solvent].max())
        dE = abs(float(state.energy) - float(e_ref))
        print(f"  (b) step 0 vs the port on the CPU in float64 ({secs:.1f} s): solvent atoms "
              f"max|dF| {dF_solv:.3e} eV/A (limit {FORCE_LIMIT}); protein atoms max|dF| "
              f"{dF_prot:.3e} eV/A (limit {PROTEIN_SPREAD}, the float32 spread of the "
              f"subtractive combiner; the JAX package's own float32 figure on this box "
              f"{JAX_PROTEIN_F32}); |dE| {dE:.3e} eV of |E| {abs(float(e_ref)):.1f}; max|F| "
              f"{float(f_ref.abs().max()):.2f} eV/A")
        need(dF_solv <= FORCE_LIMIT, f"solvent forces differ from float64 by {dF_solv:.3e}")
        need(dF_prot <= PROTEIN_SPREAD, f"protein forces differ from float64 by {dF_prot:.3e}")
        out.update(dF_solvent=dF_solv, dF_protein=dF_prot, dE=dE, forces0=state.forces.cpu())
        P, (cs, qa) = state.positions, state.aux
        reset_launches()
        qmmm(P, state.aux)
        torch.cuda.synchronize()
        out["launches"] = {n: LAUNCHES[n] for n in ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd",
                                                    "cap_grad")}
        need(all(v > 0 for v in out["launches"].values()),
             f"solvated evaluation launches {out['launches']}")
        P_prot = P[qmmm.sel]
        parts = {name: graph_ms(torch, fn) for name, fn in {
            "QM (ViSNet fragments, caps)": lambda: qmmm.qm_energy_forces(P_prot, qa),
            "MM cell assign": lambda: CP.assign(qmmm.cp, P),
            "MM pairs": lambda: CP.pair_energy_forces(qmmm.cp, cs, P, qmmm.mm_full.charge,
                                                      qmmm.mm_full.sigma, qmmm.mm_full.eps,
                                                      qmmm.mm_full.beta),
            "MM PME + bonded + exclusions": lambda: MM.smooth_energy_forces(qmmm.mm_full, P),
            "MM protein alone": lambda: qmmm.mm_prot_energy_forces(P_prot),
        }.items()}
        out["parts_ms"] = parts
        print(f"  (b) one evaluation launches {out['launches']}; each part captured alone as a "
              f"CUDA graph, ms a replay (events): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in parts.items())
              + f"; QM {parts['QM (ViSNet fragments, caps)']:.3f}, MM "
              f"{sum(v for k, v in parts.items() if k.startswith('MM')):.3f}")
    gen_state = sim.generator.get_state()
    t0 = time.perf_counter()
    got = sim.advance(state, SOLV_STEPS)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    need(sim.graph is not None and sim.graph.replays == SOLV_STEPS, "no solvated graph")
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    ref = state
    for _ in range(SOLV_STEPS):
        ref = L.langevin_step(sim.full_potential, sim.coeffs, sim.masses, ref, generator=g,
                              constraint=sim.constraint)
    dx = float((got.positions - ref.positions).abs().max())
    dF = float((got.forces - ref.forces).abs().max())
    print(f"  (b) captured in {t_capture:.1f} s with warm-up; {SOLV_STEPS} replays vs eager steps "
          f"from the same state and generator state: max|dx| {dx:.3e} A, max|dF| {dF:.3e} eV/A "
          f"(limit {FORCE_LIMIT}; the PME spreading and the stitch sum with atomics)")
    need(dx <= FORCE_LIMIT and dF <= FORCE_LIMIT,
         f"solvated replays differ from eager steps: dx {dx:.3e}, dF {dF:.3e}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    final = sim.graph.run(TIMED_STEPS)
    end.record()
    torch.cuda.synchronize()
    out["ms_step"] = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    out["ms_events"] = start.elapsed_time(end) / TIMED_STEPS
    need(bool(final.positions.isfinite().all() and final.forces.isfinite().all()),
         "solvated run: non-finite state")
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"  (b) graphed {out['ms_step']:.3f} ms/step (host clock), {out['ms_events']:.3f} (CUDA "
          f"events) over {TIMED_STEPS} replays; peak device memory {out['peak_gib']:.2f} GiB "
          f"above the {base / 2 ** 30:.2f} held before (build, first forces, capture) ({card})")
    prof = profile_steps(torch, lambda _: sim.graph.run(1), None, label="replayed solvated steps")
    out.update(kernels_per_step=prof["kernels_per_step"], busy_share=prof["busy_share"])
    for name in ("cap_grad_kernel", *EDGE_KERNELS):
        need(any(name in n for n in prof["names"]), f"the solvated replay trace names no {name}")
    if rigid:
        viol = float(sim.constraint.max_violation(final.positions))
        out["settle_violation"] = viol
        print(f"  (b) SETTLE after {SOLV_STEPS + TIMED_STEPS + 1} steps: max constraint violation "
              f"{viol:.3e} A (limit {SETTLE_LIMIT})")
        need(viol <= SETTLE_LIMIT, f"SETTLE violation {viol:.3e}")
    return out


def run_solvated_cli(torch, root):
    """Phase 9c: `python -m ai2bmd_torch` on the solvated box, with and
    without --no-write-solvent, one after the other (side by side they
    would share the card): exit 0, the DCD's atoms, the steady ms/step of
    the metrics CSV."""
    from ai2bmd_torch.io.trajectory import read_dcd

    runs = {"solvent": [], "no-write-solvent": ["--no-write-solvent"]}
    t0 = time.perf_counter()
    outs = {name: _cli_wait(name, _cli_start([
        sys.executable, "-m", "ai2bmd_torch", "--prot-file", SOLVATED, "--log-dir",
        os.path.join(root, f"cli_{name}"), "--preeq-steps", "0", "--sim-steps",
        str(SOLV_CLI_STEPS), "--record-per-steps", str(SOLV_CLI_RECORD), "--timestep",
        str(SOLV_DT_FS), *extra])) for name, extra in runs.items()}
    wall = time.perf_counter() - t0
    steady = {}
    for name, want in (("solvent", 17882), ("no-write-solvent", 175)):
        d = os.path.join(root, f"cli_{name}")
        frames = read_dcd(os.path.join(d, "chig-preeq-traj.dcd"))
        need(frames.shape == (SOLV_CLI_STEPS // SOLV_CLI_RECORD, want, 3)
             and bool(torch.as_tensor(frames).isfinite().all()),
             f"CLI {name}: DCD {frames.shape}, expected {want} atoms")
        rows = _metrics(os.path.join(d, "chig-preeq-metrics.csv"))
        steady[name] = rows[-1]["ms_per_step"]
        qm_line = [ln for ln in outs[name].splitlines() if ln.startswith("QM/MM:")]
        need(qm_line, f"CLI {name} printed no QM/MM line")
        print(f"  (c) --prot-file {SOLVATED} {' '.join(runs[name])}: exit 0, "
              f"{frames.shape[0]} frames of {want} atoms; {qm_line[0]!r}; metrics ms/step "
              f"{[r['ms_per_step'] for r in rows]}")
    print(f"  (c) the two runs took {wall:.1f} s")
    return steady


def run_route(torch, card, root, name, kw, plain: bool):
    """Phase 9d: ProteinSimulation.from_pdb on Chignolin with ViSNetConfig(**kw)
    on the card: with ``plain``, the explicit plain route (its one log line,
    LAUNCHES["plain_edge_core"] > 0 and no edge or layer kernel), else the
    kernels K1-K3 (no log line, the counter 0); step 0 against the CPU
    float64 run, 3 graphed steps, then ROUTE_TIMED replays timed by CUDA
    events.  Returns (the launches of the cold start and step 0, ms a
    replay)."""
    import logging

    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.models.visnet import ViSNet, ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches, reset_plain_edge_core
    from ai2bmd_torch.potentials import FragmentPotential
    from ai2bmd_torch.simulators import WARM_ITERS, ProteinSimulation, load_model

    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logger = logging.getLogger("ai2bmd_torch.models.visnet")
    logger.addHandler(handler)
    cfg = ViSNetConfig(**kw)
    try:
        torch.cuda.synchronize()
        reset_launches()
        reset_plain_edge_core()
        ps = ProteinSimulation.from_pdb("examples/chig.pdb", log_dir=os.path.join(root, name),
                                        model_cfg=cfg, sim_cfg=SimulationConfig(
                                            timestep_fs=USER_DT_FS, preeq_steps=0,
                                            record_per_steps=RECORD))
        state = ps.sim.initial_state(ps.prot.positions)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        logger.removeHandler(handler)
    edge = ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd")
    other = ("vislayer_fwd", "vislayer_bwd", "edge_bwd_msg_rc", "edge_bwd_upd_rc")
    if plain:
        need(len(lines) == 1 and "plain PyTorch version" in lines[0], f"the route logged {lines}")
        need(ps.potential.cfg.plain_edge_core and not ps.potential.cfg.fused_layer,
             f"resolved config {ps.potential.cfg}")
        need(launches["plain_edge_core"] > 0, f"{name}: launches {launches}")
        for n in edge + other:
            need(launches[n] == 0, f"{name}: {n} ran")
    else:
        need(not lines and not ps.potential.cfg.plain_edge_core, f"{name}: logged {lines}")
        need(launches["plain_edge_core"] == 0 and all(launches[n] > 0 for n in edge),
             f"{name}: launches {launches}")
        for n in other:
            need(launches[n] == 0, f"{name}: {n} ran")
    need(launches["cap_grad"] > 0, f"{name}: launches {launches}")
    params, _ = load_model(None, cfg)
    pot64 = FragmentPotential.build(ps.prot, ViSNet(cfg, params).to(torch.float64), cfg,
                                    device="cpu")
    cpu = torch.device("cpu")
    _, f_ref, _ = pot64.stateful_energy_forces(
        torch.as_tensor(ps.prot.positions, dtype=torch.float64),
        ps.sim._init_aux.to(cpu, torch.float64), warm_iters=WARM_ITERS)
    dF = float((state.forces.to(cpu, torch.float64) - f_ref).abs().max())
    s3 = ps.sim.advance(state, 3)
    need(ps.sim.graph.replays == 3 and bool(s3.positions.isfinite().all()),
         f"{name}: the graphed steps failed")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ps.sim.advance(s3, ROUTE_TIMED)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / ROUTE_TIMED
    if lines:
        print(f"  (d) {kw}: logged {lines[0]!r}")
    print(f"  (d) {kw}: cold start + step 0 launches "
          f"{ {n: v for n, v in launches.items() if v} }; step 0 vs CPU float64 max|dF| "
          f"{dF:.3e} eV/A (limit {FORCE_LIMIT}); 3 graphed steps, then {ms:.3f} ms a replay "
          f"over {ROUTE_TIMED} ({card})")
    need(dF <= FORCE_LIMIT, f"{name}: step-0 forces differ from float64 by {dF:.3e}")
    if plain:
        reset_plain_edge_core()
    return launches, ms


def run_solvated(torch, dev, prot, card, root, mm_graphed_ms):
    """Phase 9: (a) PME in fragment mode, (b) the solvated box through
    ProteinSimulation (flexible, then rigid water), (c) the CLI on it, (d)
    the 64-channel-head model through the kernels and a tanh model through
    the plain route."""
    t_phase = time.perf_counter()
    pme_launches, pme = run_pme_fragment(torch, dev, prot, card, mm_graphed_ms)
    no_plain("9a")
    flex = run_solvated_sim(torch, dev, card, root, rigid=False)
    rigid = run_solvated_sim(torch, dev, card, root, rigid=True)
    no_plain("9b")
    cli = run_solvated_cli(torch, root)
    _, ms8 = run_route(torch, card, root, "heads8", EIGHT_HEADS, plain=False)
    _, ms64 = run_route(torch, card, root, "wide", WIDE_HEADS, plain=False)
    no_plain("9d, 64-channel heads")
    launches, ms_tanh = run_route(torch, card, root, "tanh", OTHER_ACT, plain=True)
    plain = launches["plain_edge_core"]
    print(f"  (d) 2 x 256 graphed: 8 heads of 32 channels {ms8:.3f} ms a replay, 4 heads of 64 "
          f"{ms64:.3f} (K1-K3 at DH = 64), tanh through the plain route {ms_tanh:.3f} ({card})")
    qm = flex["parts_ms"]["QM (ViSNet fragments, caps)"]
    mm = sum(v for k, v in flex["parts_ms"].items() if k.startswith("MM"))
    print(f"  solvated step (17,882 atoms, 9 x 256): graphed {flex['ms_step']:.3f} ms/step "
          f"(events {flex['ms_events']:.3f}; parts alone QM {qm:.3f} + MM {mm:.3f}), rigid "
          f"water {rigid['ms_step']:.3f}; step 0 vs CPU float64 max|dF| solvent "
          f"{flex['dF_solvent']:.3e}, protein {flex['dF_protein']:.3e} eV/A; CLI steady "
          f"{cli['solvent']:.3f} / {cli['no-write-solvent']:.3f} (--no-write-solvent); "
          f"{flex['kernels_per_step']:.0f} kernels a step, {100 * flex['busy_share']:.1f}% busy; "
          f"peak {flex['peak_gib']:.2f} GiB; phase 9 took {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    return dict(pme_launches=pme_launches, pme_ms=pme["ms_step"], flex=flex, rigid=rigid,
                cli=cli, plain_edge_core=plain)


# Phase 10: preprocessing and solvated replicas.
PRE_SHORT = dict(max_cyc=20, heat_stages=(50.0, 150.0, 300.0), heat_steps=20, nvt_steps=1,
                 npt_steps=20)        # nvt_steps=1 runs one whole chunk of 500, as JAX does
# The dense pair sum takes in the excluded (bonded) protein pairs' LJ, which
# the exclusion correction takes out again: in float32 the protein atoms'
# forces cancel only to a few 1e-2 eV/A (the JAX package's own float32
# figure at the short protocol's minimized positions, on the CPU: 3.28e-2;
# the port's 3.14e-2 there, 3.36e-2 and 4.36e-2 on the card at its own
# minimized positions; solvent atoms ~2e-5), and the pressure's two large
# virial terms, each ~1e6 times the pressure, to ~1e-7 of their size.  The
# residue changes at random with the last bits of the positions, so a step
# that starts from positions one ulp apart (the NPT scaling moves every atom
# by the pressure's rounding) ends ~1e-2 eV/A apart on protein atoms.
PRE_PROTEIN_SPREAD = 1e-1     # eV/A
PRESSURE_REL = 1e-6           # of the virial's scale (2K + |dU_smooth/ds| + |W|) / 3V
# one NPT step replayed against an eager one: the charge spreading's atomics
# move the pressure by its float32 rounding (1.6 bar, ~3e-8 of the virial's
# scale), and the Berendsen scaling moves every atom by ~1e-7 of the cell
# per bar of it: ~1e-5 A (7.6e-6 measured on an H100)
NPT_REPLAY_LIMIT = 1e-4       # A
CPU_TILE = 2048               # the CPU float64 reference's pair tile (rows a block)
N_SOLV_REPLICAS = 4
ENS_CHECK_STEPS = 5           # replica-steps held against a lone graphed run
ENS_POS_LIMIT = 1e-4          # A
ENS_TIMED_CALLS = 3
K1_K4 = ("edge_fwd", "edge_bwd_msg", "edge_bwd_upd", "cap_grad")
ENS_CLI_STEPS, ENS_CLI_RESTART_STEPS = 4, 8


def run_preprocess(torch, dev, card, root):
    """Phase 10a: Preprocessor on examples/chig.pdb at the default padding
    with short stages (PRE_SHORT), on the card: the box, the energy before
    and after the minimization, T after each heat stage, the NPT cell and
    <P>, each stage's ms per step (CUDA events, the stages being replays of
    captured steps); one dense MM evaluation at the minimized positions and
    the pressure of the final state against the port on the CPU in float64;
    replayed NPT steps against eager ones.  Returns its log directory and
    figures."""
    from ai2bmd_torch.data.protein_topology import build_topology
    from ai2bmd_torch.host import load_protein
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.md.graphed import GraphedStep
    from ai2bmd_torch.physics import mm as MM
    from ai2bmd_torch.preprocess import BAR_IN_EV_A3, Preprocessor, npt_body, solvate

    pre_dir = os.path.join(root, "preprocess")
    os.makedirs(pre_dir, exist_ok=True)
    pre = Preprocessor(log_dir=pre_dir, **PRE_SHORT)
    t0 = time.perf_counter()
    out = pre.run("examples/chig.pdb", log=lambda m: print(f"    {m}", flush=True))
    wall = time.perf_counter() - t0
    mm = pre.mm
    n = mm.n_atoms
    need(os.path.exists(out) and os.path.exists(out.replace("-preeq.pdb", "-preeq-nowat.pdb")),
         "preprocessing wrote no outputs")
    e0, e1 = pre.energies["minimize"]
    need(e1 < e0, f"minimization did not lower the energy: {e0} -> {e1}")
    need(all(math.isfinite(t) for t in pre.temperatures), f"heat temperatures {pre.temperatures}")
    need(bool(pre.state.positions.isfinite().all()), "non-finite preprocessed positions")
    need(math.isfinite(pre.last_npt_pressure_bar), "no NPT pressure")
    stage_ms = {k: v["ms"] / v["steps"] for k, v in pre.stages.items()}
    print(f"  (a) {n} atoms, cell {[round(c, 3) for c in mm.cell.tolist()]} -> NPT cell "
          f"{[round(c, 3) for c in pre.cell.tolist()]}, <P> per chunk {pre.npt_pressures_bar} bar; "
          f"E {e0:.2f} -> {e1:.2f} eV over {pre.max_cyc} cycles; T after the heat stages "
          f"{[round(t, 1) for t in pre.temperatures]} K; {wall:.1f} s in all")
    print(f"  (a) ms per step (evaluation for the minimization), CUDA events: " + ", ".join(
        f"{k} {v:.3f} ({pre.stages[k]['steps']})" for k, v in stage_ms.items()) + f" ({card})")

    # the port on the CPU in float64: the same box, built again from the seed
    box = solvate(load_protein("examples/chig.pdb").atoms, padding=pre.padding, seed=pre.seed)
    need(len(box) == n, f"the box rebuilt on the host has {len(box)} atoms, not {n}")
    top = build_topology(box)
    mm64 = MM.MMSystem.build(top, box.cell, cutoff=pre.cutoff, device="cpu", dtype=torch.float64)
    solvent = torch.ones(n, dtype=torch.bool)
    solvent[torch.as_tensor(top.protein_atoms)] = False
    dense_ms = cuda_ms(torch, lambda: MM.mm_energy_forces_dense(mm, pre.minimized), 3)
    e_c, f_c = MM.mm_energy_forces_dense(mm, pre.minimized)
    t0 = time.perf_counter()
    e_r, f_r = MM.mm_energy_forces_dense(mm64, pre.minimized.cpu().double(), tile=CPU_TILE)
    secs = time.perf_counter() - t0
    dF = (f_c.cpu().double() - f_r).abs().max(-1).values
    dF_solv, dF_prot = float(dF[solvent].max()), float(dF[~solvent].max())
    print(f"  (a) one dense MM evaluation at the minimized positions: {dense_ms:.3f} ms on the "
          f"card; against the CPU float64 ({secs:.1f} s): solvent atoms max|dF| {dF_solv:.3e} eV/A "
          f"(limit {FORCE_LIMIT}), protein atoms {dF_prot:.3e} (limit {PRE_PROTEIN_SPREAD}, the "
          f"float32 spread), |dE| {abs(float(e_c) - float(e_r)):.3e} eV of {float(e_r):.1f}")
    need(dF_solv <= FORCE_LIMIT, f"preprocessing MM: solvent forces differ by {dF_solv:.3e}")
    need(dF_prot <= PRE_PROTEIN_SPREAD, f"preprocessing MM: protein forces differ by {dF_prot:.3e}")

    P, cell = pre.state.positions, pre.cell
    ekin = L.kinetic_energy(top.masses, pre.state.velocities)
    p_c = float(MM.mm_pressure_dense(mm, P, cell, ekin)) / BAR_IN_EV_A3
    P64, cell64, ekin64 = P.cpu().double(), cell.cpu().double(), ekin.cpu().double()
    p_r = float(MM.mm_pressure_dense(mm64, P64, cell64, ekin64, tile=CPU_TILE)) / BAR_IN_EV_A3
    _, _, w = MM.dense_pair_energy_forces(mm64, P64, cell64, tile=CPU_TILE)
    du = MM.smooth_strain_derivative(mm64, P64, cell64)
    scale = float((2 * ekin64 + du.abs() + w.abs()) / (3 * cell64.prod())) / BAR_IN_EV_A3
    print(f"  (a) pressure of the final state: card {p_c:.3f} bar, CPU float64 {p_r:.3f} bar "
          f"(|dP| {abs(p_c - p_r):.3e} bar, limit {PRESSURE_REL} x the virial's scale "
          f"{scale:.1f} bar)")
    need(abs(p_c - p_r) <= PRESSURE_REL * scale, f"pressure differs by {abs(p_c - p_r):.3e} bar")

    # the stages are replays of captured steps: the NPT step's against eager
    # steps on the same noise, from the final state; after one step only the
    # charge spreading's atomics part them (NPT_REPLAY_LIMIT), after
    # GRAPH_CHECK_STEPS the float32 residue of the excluded pairs (above) has
    # grown as it does between two eager runs, which are reported beside them
    coeffs = L.LangevinCoeffs.build(top.masses, 1.0, pre.target_temp, 0.002, device=dev)
    body = npt_body(mm, coeffs, torch.as_tensor(top.masses, dtype=torch.float32, device=dev),
                    pre.taup_fs)
    st = pre.state
    bufs = tuple(t.clone() for t in (st.positions, st.velocities, st.forces, st.energy, P, P,
                                     cell, st.energy))
    graph = GraphedStep(body, bufs)
    ref, ref2 = (tuple(t.clone() for t in bufs) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(1)
    apart = []
    for _ in range(GRAPH_CHECK_STEPS):
        for out in bufs[4:6]:
            torch.randn(out.shape, generator=gen, out=out)
        for r in (ref, ref2):
            r[4].copy_(bufs[4])
            r[5].copy_(bufs[5])
            body(r)
        graph.replay()
        apart.append((float((bufs[0] - ref[0]).abs().max()), abs(float(bufs[7] - ref[7])),
                      float((ref2[0] - ref[0]).abs().max())))
    (dx1, dP1, _), (dx, dP, dx_eager) = apart[0], apart[-1]
    print(f"  (a) NPT steps replayed from the captured step against eager steps on the same "
          f"noise: after 1 step max|dx| {dx1:.3e} A, |dP| {dP1:.3e} bar (limits "
          f"{NPT_REPLAY_LIMIT} A, {PRESSURE_REL} x the scale); after {GRAPH_CHECK_STEPS} "
          f"max|dx| {dx:.3e} A, |dP| {dP:.3e} bar, two eager runs {dx_eager:.3e} A apart")
    need(dx1 <= NPT_REPLAY_LIMIT and dP1 <= PRESSURE_REL * scale,
         f"an NPT replay differs from an eager step: {dx1}, {dP1}")
    return pre_dir, dict(atoms=n, stage_ms=stage_ms, dense_ms=dense_ms, dF_solvent=dF_solv,
                         dF_protein=dF_prot, pressure_bar=p_c, wall_s=wall)


def run_preprocess_cli(root, pre_dir):
    """Phase 10b: `python -m ai2bmd_torch --prot-file examples/chig.pdb
    --solvent` with (a)'s outputs in --log-dir: the skip line, then 4
    solvated steps."""
    t0 = time.perf_counter()
    out = _cli_wait("solvent-preprocessed", _cli_start([
        sys.executable, "-m", "ai2bmd_torch", "--prot-file", "examples/chig.pdb", "--solvent",
        "--log-dir", pre_dir, "--preeq-steps", "0", "--sim-steps", "4", "--record-per-steps",
        "2", "--timestep", str(SOLV_DT_FS)]))
    skip = [ln for ln in out.splitlines() if ln.startswith("preprocessing outputs exist")]
    qm = [ln for ln in out.splitlines() if ln.startswith("QM/MM:")]
    need(skip and qm, f"the --solvent run printed no skip or QM/MM line:\n{out[-2000:]}")
    need("Simulation finished!" in out, "the --solvent run did not finish")
    print(f"  (b) --prot-file examples/chig.pdb --solvent: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; {skip[0]!r}; {qm[0]!r}")


def kernel_counts(torch, fn):
    """Launches of K1-K4's device kernels by name in a profiled call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(k in e.name for k in QM_NAMES):
            counts[short_name(e.name)] = counts.get(short_name(e.name), 0) + 1
    return counts


def run_solvated_replicas(torch, dev, card, lone):
    """Phase 10c: SolvatedReplicaEnsemble of N_SOLV_REPLICAS replicas of the
    solvated Chignolin box at 9 x 256 with phase 4's weights: the route;
    every replica's step-0 forces against the lone solvated step's (phase
    9b); launches of the first call (the capture) per evaluation against
    phase 9b's one evaluation; replica r's first ENS_CHECK_STEPS steps
    against a lone GraphedLangevin run on replica r's generator; the
    replicas diverge; kernel launches per replica-step (trace) equal the
    lone replay's; ms per replica-step, aggregate ns/day, peak memory."""
    from ai2bmd_torch.host import normalize_atom_order, read_pdb
    from ai2bmd_torch.md import GraphedLangevin
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.md.graphed import WARMUP_STEPS
    from ai2bmd_torch.models.params import init_params
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.parallel import SolvatedReplicaEnsemble, replica_generators

    R = N_SOLV_REPLICAS
    atoms = normalize_atom_order(read_pdb(SOLVATED))
    cfg = ViSNetConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ens = SolvatedReplicaEnsemble.build(atoms, params, cfg, n_replicas=R, timestep_fs=SOLV_DT_FS)
    state0 = ens.initial_state(atoms.positions, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    need(ens.qmmm.backend == "cellpair", f"the ensemble's pair route is {ens.qmmm.backend}")
    dF0 = float((state0.forces.cpu() - lone["forces0"]).abs().max())
    print(f"  (c) {R} replicas of {len(atoms)} atoms, {ens.qmmm.backend} pairs: build and first "
          f"forces {t_build:.1f} s; step-0 forces of every replica vs the lone solvated step "
          f"(phase 9b): max|dF| {dF0:.3e} eV/A (limit 1e-4)")
    need(dF0 <= 1e-4, f"replica step-0 forces differ from the lone step by {dF0:.3e}")

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = ens.run(state0, ENS_CHECK_STEPS)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in KERNELS}
    per_eval = {k: v / (WARMUP_STEPS + 1) for k, v in launches.items()}
    print(f"  (c) first run ({ENS_CHECK_STEPS} steps a replica, the capture with its "
          f"{WARMUP_STEPS} warm-up steps) {t_first:.1f} s; launches {launches}, per evaluation "
          f"{per_eval} against phase 9b's {lone['launches']}")
    need(all(per_eval[k] == (lone["launches"][k] if k in K1_K4 else 0) for k in KERNELS)
         and all(per_eval[k] > 0 for k in K1_K4),
         f"replica launches per evaluation {per_eval}, lone {lone['launches']}")
    need(ens.graph is not None and ens.graph.replays == R * ENS_CHECK_STEPS,
         "the ensemble did not replay its captured step")

    gens = replica_generators(0, R, dev)
    masses = ens.masses.cpu().numpy()
    for g in gens:
        L.maxwell_boltzmann_velocities(g, masses, 300.0)
    graph = GraphedLangevin(ens.qmmm, ens.coeffs, ens.masses, ens.replica(state0, 0), gens[0])
    dx = dF = 0.0
    for r in range(R):
        graph.load(ens.replica(state0, r), gens[r])
        s = graph.run(ENS_CHECK_STEPS)
        dx = max(dx, float((got.positions[r] - s.positions).abs().max()))
        dF = max(dF, float((got.forces[r] - s.forces).abs().max()))
    spread = float((got.positions[0] - got.positions[1]).abs().max())
    print(f"  (c) replica r's first {ENS_CHECK_STEPS} steps vs a lone GraphedLangevin on its "
          f"generator: max|dx| {dx:.3e} A (limit {ENS_POS_LIMIT}), max|dF| {dF:.3e} eV/A (limit "
          f"{FORCE_LIMIT}); replicas 0 and 1 apart by {spread:.3e} A")
    need(dx <= ENS_POS_LIMIT and dF <= FORCE_LIMIT, f"replicas differ from lone runs: {dx}, {dF}")
    need(spread > 1e-6, "the replicas did not diverge")

    ens_counts = kernel_counts(torch, lambda: ens.run(got, 1))
    lone_counts = kernel_counts(torch, lambda: graph.run(1))
    per_step = {k: v / R for k, v in ens_counts.items()}
    print(f"  (c) device kernels of K1-K4 per replica-step (trace) {per_step}; the lone replay's "
          f"{lone_counts}")
    need(per_step == lone_counts and lone_counts, "replica-steps launch other kernels than the "
                                                  "lone step")
    del graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    final = ens.run(got, ENS_TIMED_CALLS)
    end.record()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (R * ENS_TIMED_CALLS)
    ms_ev = start.elapsed_time(end) / (R * ENS_TIMED_CALLS)
    need(bool(final.positions.isfinite().all() and final.forces.isfinite().all()),
         "non-finite replica state")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"  (c) {ms:.3f} ms per replica-step (host clock), {ms_ev:.3f} (CUDA events) over "
          f"{R} x {ENS_TIMED_CALLS}; aggregate {86.4 / ms:.4f} ns/day at 1 fs; peak device memory "
          f"{peak:.2f} GiB above the {base / 2 ** 30:.2f} held before ({card})")
    return dict(launches_per_eval=per_eval, ms=ms, ms_events=ms_ev, peak_gib=peak, dF0=dF0,
                dx=dx)


def run_replicas_cli(root):
    """Phase 10d: `python -m ai2bmd_torch --replicas 2` on the solvated box:
    ENS_CLI_STEPS steps, then --restart to ENS_CLI_RESTART_STEPS: exit 0,
    the per-replica DCDs, the resume line."""
    import numpy as np

    from ai2bmd_torch.io.trajectory import read_dcd

    d = os.path.join(root, "cli_replicas")
    cmd = [sys.executable, "-m", "ai2bmd_torch", "--prot-file", SOLVATED, "--log-dir", d,
           "--replicas", "2", "--record-per-steps", "2", "--timestep", str(SOLV_DT_FS)]
    t0 = time.perf_counter()
    out = _cli_wait("replicas", _cli_start([*cmd, "--sim-steps", str(ENS_CLI_STEPS)]))
    again = _cli_wait("replicas-restart", _cli_start(
        [*cmd, "--sim-steps", str(ENS_CLI_RESTART_STEPS), "--restart"]))
    wall = time.perf_counter() - t0
    need(any(ln.startswith("QM/MM:") for ln in out.splitlines()), "no QM/MM line")
    need("resumed ensemble" in again, f"the restart printed no resume line:\n{again[-2000:]}")
    for r in range(2):
        for suffix, frames in (("", ENS_CLI_STEPS // 2),
                               ("-restart", (ENS_CLI_RESTART_STEPS - ENS_CLI_STEPS) // 2)):
            f = read_dcd(os.path.join(d, f"chig-preeq-r{r:03d}-traj{suffix}.dcd"))
            need(f.shape == (frames, 17882, 3) and bool(np.isfinite(f).all()),
                 f"replica {r} DCD{suffix}: {f.shape}")
    print(f"  (d) --replicas 2 on {SOLVATED}: {ENS_CLI_STEPS} steps, then --restart to "
          f"{ENS_CLI_RESTART_STEPS}: exit 0 twice, 2 DCDs each, "
          f"{[ln for ln in again.splitlines() if 'resumed ensemble' in ln][0]!r} ({wall:.1f} s)")


def run_preprocessing_and_replicas(torch, dev, card, root, lone):
    """Phase 10: (a) preprocessing on the card, (b) the CLI's --solvent route
    on (a)'s outputs, (c) SolvatedReplicaEnsemble, (d) the CLI's --replicas
    route on the box and its restart."""
    t_phase = time.perf_counter()
    pre_dir, pre = run_preprocess(torch, dev, card, root)
    run_preprocess_cli(root, pre_dir)
    no_plain("10a-b")
    ens = run_solvated_replicas(torch, dev, card, lone)
    run_replicas_cli(root)
    no_plain("10c-d")
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(pre=pre, ens=ens)


def run_preprocess_full(torch, card, root):
    """`--preprocess-full`: Preprocessor() with the JAX package's default
    stages on examples/chig.pdb, each stage's wall seconds and ms per step."""
    from ai2bmd_torch.preprocess import Preprocessor

    d = os.path.join(root, "preprocess_full")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    pre = Preprocessor(log_dir=d)
    t0 = time.perf_counter()
    pre.run("examples/chig.pdb", log=lambda m: print(f"    {m}", flush=True))
    wall = time.perf_counter() - t0
    print(f"  Preprocessor() on examples/chig.pdb ({pre.mm.n_atoms} atoms): {wall:.1f} s in all; "
          + ", ".join(f"{k} {v['ms'] / 1e3:.1f} s ({v['steps']} steps, "
                      f"{v['ms'] / v['steps']:.3f} ms each)" for k, v in pre.stages.items())
          + f"; final-half <P> {pre.last_npt_pressure_bar:.1f} bar ({card})")
    print("  the AMOEBA protocol (Preprocessor(method=\"AMOEBA\"), JAX's default 100 cycles):")
    res, _ = run_amoeba_preprocess(torch, card, root, 100)
    print(f"  Preprocessor(method=\"AMOEBA\") on examples/chig.pdb ({res['atoms']} atoms): "
          f"{res['wall_s']:.1f} s in all, {res['stage_ms'] / 100:.3f} ms a cycle in the stage "
          f"(the capture included), {res['cycle_ms']:.3f} ms a captured cycle replayed; peak "
          f"{res['peak_gib']:.2f} GiB ({card})")



KERNELS = {   # name: (source, the TPU kernel's pallas_call it replaces)
    "edge_fwd": ("ai2bmd_torch/ops/csrc/edge_fwd.cu", "ai2bmd_tpu/ops/pallas/vismp.py:543"),
    "edge_bwd_msg": ("ai2bmd_torch/ops/csrc/edge_bwd_msg.cu",
                     "ai2bmd_tpu/ops/pallas/vismp.py:909"),
    "edge_bwd_upd": ("ai2bmd_torch/ops/csrc/edge_bwd_upd.cu",
                     "ai2bmd_tpu/ops/pallas/vismp.py:959"),
    "cap_grad": ("ai2bmd_torch/ops/csrc/cap_grad.cu", "ai2bmd_tpu/ops/pallas/caps.py:326"),
    "vislayer_fwd": ("ai2bmd_torch/ops/csrc/vislayer_fwd.cu",
                     "ai2bmd_tpu/ops/pallas/vislayer.py:457"),
    "vislayer_bwd": ("ai2bmd_torch/ops/csrc/vislayer_bwd.cu",
                     "ai2bmd_tpu/ops/pallas/vislayer.py:518"),
    "edge_bwd_msg_rc": ("ai2bmd_torch/ops/csrc/edge_bwd_msg.cu",
                        "ai2bmd_tpu/ops/pallas/vismp.py:1018"),
    "edge_bwd_upd_rc": ("ai2bmd_torch/ops/csrc/edge_bwd_upd.cu",
                        "ai2bmd_tpu/ops/pallas/vismp.py:1086"),
}


T_START = time.perf_counter()


# Phase 11: the polarizable routes.
# The JAX package's own float32 against float64 of its AMOEBA QM/MM step on
# tests/test_qmmm_amoeba.py's synthetic solvated Chignolin (247 atoms), QM
# term at zero: tools/amoeba_f32_spread.py on the CPU (the builder's run)
AMOEBA_JAX_SPREAD = dict(solvent=7.15e-5, protein=2.59e-5)     # eV/A
POL_STEPS = 5                 # replays held against eager steps, then without overflow
POL_TIMED = 10                # replays timed
POL_TOP = 8                   # kernels named in the MM part's trace
POL_CLI_STEPS = 3


def synthetic_amoeba_box():
    """tests/test_qmmm_amoeba.py's synthetic box with the port's modules:
    Chignolin centred in a periodic cell 6 A wider on each side, a 3 x 3 x 3
    lattice of AMOEBA waters, those closer than 2.4 A to the protein left
    out.  Returns (PDBAtoms, protein atom count)."""
    import numpy as np

    from ai2bmd_torch.host import example_pdb, normalize_atom_order, read_pdb
    from ai2bmd_torch.io.pdb import PDBAtoms
    from ai2bmd_torch.physics.amoeba import ideal_water

    prot = normalize_atom_order(read_pdb(example_pdb("chig")))
    P = prot.positions - prot.positions.mean(axis=0)
    cell = P.max(axis=0) - P.min(axis=0) + 12.0
    P = P + cell / 2
    wats = [w for w in (ideal_water(origin=(np.array(ijk) + 0.5) * cell / 3)
                        for ijk in np.ndindex(3, 3, 3))
            if np.min(np.linalg.norm(P[:, None, :] - w[None, :, :], axis=-1)) > 2.4]
    W = len(wats)
    return PDBAtoms(
        positions=np.concatenate([P, *wats]),
        numbers=np.concatenate([prot.numbers, np.tile([8, 1, 1], W)]).astype(np.int32),
        atom_names=np.concatenate([prot.atom_names, np.array(["O", "H1", "H2"] * W)]),
        residue_names=np.concatenate([prot.residue_names, np.array(["WAT"] * (3 * W))]),
        residue_numbers=np.concatenate([prot.residue_numbers, np.repeat(np.arange(W), 3)
                                        + prot.residue_numbers.max() + 1]).astype(np.int32),
        cell=cell), len(P)


def amoeba_mm_spread(torch, dev, atoms, label, limits):
    """QMMMPotential(mm_backend="amoeba") with the QM term at zero, float32
    against float64, both on the card (no kernel lies on the MM side): max|dF|
    on solvent and protein atoms within ``limits``, |dE|; the float32 call's
    peak device memory."""
    import numpy as np

    from ai2bmd_torch.physics.qmmm import QMMMPotential

    zero = lambda P: (P.sum() * 0, torch.zeros_like(P))
    out = {}
    for dt in (torch.float64, torch.float32):
        q = QMMMPotential.build(atoms, zero, mm_backend="amoeba", device=dev, dtype=dt)
        P = torch.as_tensor(atoms.positions, dtype=dt, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        e, f, _ = q(P, q.init_aux(P))
        torch.cuda.synchronize()
        out[dt] = (float(e), f.double().cpu(), (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        del q, P, f
        torch.cuda.empty_cache()
    prot = np.isin(np.asarray(atoms.residue_names), ("WAT", "HOH", "Na+", "Cl-", "NA", "CL"),
                   invert=True)
    dF = (out[torch.float32][1] - out[torch.float64][1]).abs().max(-1).values
    d_solv, d_prot = float(dF[~torch.as_tensor(prot)].max()), float(dF[prot].max())
    dE = abs(out[torch.float32][0] - out[torch.float64][0])
    print(f"  (c) AMOEBA MM of {label} ({len(atoms.positions)} atoms), QM at zero, float32 vs "
          f"float64 on the card: solvent max|dF| {d_solv:.3e} (limit {limits['solvent']:.2e}), "
          f"protein {d_prot:.3e} (limit {limits['protein']:.2e}) eV/A; |dE| {dE:.3e} eV of "
          f"|E| {abs(out[torch.float64][0]):.3f}; peak {out[torch.float32][2]:.2f} GiB (float32), "
          f"{out[torch.float64][2]:.2f} GiB (float64)")
    need(d_solv <= limits["solvent"], f"{label}: AMOEBA solvent forces part by {d_solv:.3e}")
    need(d_prot <= limits["protein"], f"{label}: AMOEBA protein forces part by {d_prot:.3e}")
    return dict(dF_solvent=d_solv, dF_protein=d_prot, dE=dE, peak_gib_f32=out[torch.float32][2],
                peak_gib_f64=out[torch.float64][2])


def run_polarizable_route(torch, dev, card, root, name, kw, flex):
    """Phase 11 (a)-(c), one route of the solvated box through
    ProteinSimulation.from_pdb(**kw) at 9 x 256: build, step 0 (against
    phase 9b's cellpair forces for ``nl``, against the port on the CPU in
    float64 but for AMOEBA), the launches of one evaluation, each part
    captured alone (QM, the list build, the full box's MM, the protein's MM),
    POL_STEPS graphed replays against eager steps, POL_TIMED replays timed,
    no overflow, peak memory."""
    from ai2bmd_torch.md import langevin as L
    from ai2bmd_torch.md.simulation import SimulationConfig
    from ai2bmd_torch.models.visnet import ViSNetConfig
    from ai2bmd_torch.ops import LAUNCHES, reset_launches
    from ai2bmd_torch.simulators import ProteinSimulation, load_model

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim_cfg = SimulationConfig(timestep_fs=SOLV_DT_FS, preeq_steps=0, record_per_steps=RECORD)
    ps = ProteinSimulation.from_pdb(SOLVATED, log_dir=os.path.join(root, f"pol_{name}"),
                                    model_cfg=ViSNetConfig(), sim_cfg=sim_cfg, **kw)
    sim, qmmm = ps.sim, ps.qmmm
    state = sim.initial_state(ps.prot.positions)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    need(qmmm.backend == "nl" and qmmm.nl_grid is not None,
         f"{name}: pair route {qmmm.backend}, list grid {qmmm.nl_grid}")
    need((qmmm.amoeba is not None) == (kw.get("mm_backend") == "amoeba"), f"{name}: MM engine")
    prot_idx = qmmm.sel.cpu()
    solvent = torch.ones(qmmm.n_atoms, dtype=torch.bool)
    solvent[prot_idx] = False
    out = dict(build_s=t_build)
    print(f"  ({name}) from_pdb({kw}) + step 0 {t_build:.1f} s: {qmmm.engine} MM, nl pairs "
          f"(K = {qmmm.k_neighbors}, list cells {qmmm.nl_grid}), mesh {qmmm.mesh}")
    f0 = state.forces.cpu().double()
    if "forces0" in flex and kw.get("pair_backend") == "nl":
        dF = (f0 - flex["forces0"].double()).abs().max(-1).values
        d_solv, d_prot = float(dF[solvent].max()), float(dF[~solvent].max())
        print(f"  ({name}) step 0 vs phase 9b's cellpair route: solvent max|dF| {d_solv:.3e} "
              f"(limit {FORCE_LIMIT}), protein {d_prot:.3e} (limit {PROTEIN_SPREAD}) eV/A")
        need(d_solv <= FORCE_LIMIT and d_prot <= PROTEIN_SPREAD,
             f"{name}: step 0 parts from the cellpair route: {d_solv:.3e} / {d_prot:.3e}")
        out.update(dF_cellpair_solvent=d_solv, dF_cellpair_protein=d_prot)
    if qmmm.amoeba is None:
        cfg, params = ps.potential.cfg, load_model(None, ViSNetConfig())[0]
        ref_kw = {k: v for k, v in kw.items() if k == "pair_backend"}
        if kw.get("polarizable_mm"):
            ref_kw["polarizable"] = True
        e_ref, f_ref, secs = solvated_reference(torch, ps, state.positions, cfg, params,
                                                **ref_kw)
        dF = (f0 - f_ref).abs().max(-1).values
        d_solv, d_prot = float(dF[solvent].max()), float(dF[~solvent].max())
        print(f"  ({name}) step 0 vs the port on the CPU in float64 ({secs:.1f} s): solvent "
              f"max|dF| {d_solv:.3e} (limit {FORCE_LIMIT}), protein {d_prot:.3e} (limit "
              f"{PROTEIN_SPREAD}) eV/A; |dE| {abs(float(state.energy) - float(e_ref)):.3e} eV")
        need(d_solv <= FORCE_LIMIT, f"{name}: solvent forces part from float64 by {d_solv:.3e}")
        need(d_prot <= PROTEIN_SPREAD, f"{name}: protein forces part from float64 by {d_prot:.3e}")
        out.update(dF_solvent=d_solv, dF_protein=d_prot)
    P, aux = state.positions, state.aux
    reset_launches()
    qmmm(P, aux)
    torch.cuda.synchronize()
    out["launches"] = {n: LAUNCHES[n] for n in K1_K4}
    need(all(v > 0 for v in out["launches"].values()), f"{name}: launches {out['launches']}")
    nl, qa = aux[0], aux[1]
    carry = aux[2] if len(aux) > 2 else (None, None)
    P_prot = P[qmmm.sel]
    parts = {"QM (ViSNet fragments, caps)": lambda: qmmm.qm_energy_forces(P_prot, qa),
             "list build": lambda: qmmm._build_nl(P),
             "MM full box": lambda: qmmm.mm_full_energy_forces(P, nl, carry[0]),
             "MM protein alone": lambda: qmmm.mm_prot_energy_forces(P_prot, carry[1])}
    out["parts_ms"] = {k: graph_ms(torch, fn) for k, fn in parts.items()}
    print(f"  ({name}) one evaluation launches {out['launches']}; each part captured alone, ms a "
          f"replay (events): " + ", ".join(f"{k} {v:.3f}" for k, v in out["parts_ms"].items()))
    trace = _trace(torch, parts["MM full box"], 1)
    top = sorted(trace.items(), key=lambda kv: -kv[1][1])[:POL_TOP]
    out["mm_kernels"] = sum(c for c, _ in trace.values())
    out["mm_top"] = [(short_name(n), c, us / 1e3) for n, (c, us) in top]
    print(f"  ({name}) the full box's MM, one eager call traced: {out['mm_kernels']} kernels, "
          f"{sum(us for _, us in trace.values()) / 1e3:.1f} device ms; the top {POL_TOP} (name "
          f"x launches: ms): " + "; ".join(f"{n} x{c}: {ms:.1f}" for n, c, ms in out["mm_top"]))
    gen_state = sim.generator.get_state()
    t0 = time.perf_counter()
    got = sim.advance(state, POL_STEPS)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    need(sim.graph is not None and sim.graph.replays == POL_STEPS, f"{name}: no graph")
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    ref = state
    for _ in range(POL_STEPS):
        ref = L.langevin_step(sim.full_potential, sim.coeffs, sim.masses, ref, generator=g)
    dx = float((got.positions - ref.positions).abs().max())
    dF = (got.forces - ref.forces).abs().max(-1).values.cpu()
    d_solv, d_prot = float(dF[solvent].max()), float(dF[~solvent].max())
    print(f"  ({name}) captured in {t_capture:.1f} s with warm-up; {POL_STEPS} replays vs eager "
          f"steps from the same state and generator state: max|dx| {dx:.3e} A (limit "
          f"{FORCE_LIMIT}), max|dF| solvent {d_solv:.3e} (limit {FORCE_LIMIT}), protein "
          f"{d_prot:.3e} eV/A (limit {PROTEIN_SPREAD}: the gathers' backward and the mesh sum "
          f"with atomics, and protein atoms carry the combiner's float32 cancellation)")
    need(dx <= FORCE_LIMIT and d_solv <= FORCE_LIMIT and d_prot <= PROTEIN_SPREAD,
         f"{name}: replays differ from eager steps: dx {dx:.3e}, dF {d_solv:.3e} / {d_prot:.3e}")
    out.update(replay_dF_solvent=d_solv, replay_dF_protein=d_prot)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    final = sim.graph.run(POL_TIMED)
    end.record()
    torch.cuda.synchronize()
    out["ms_step"] = (time.perf_counter() - t0) * 1e3 / POL_TIMED
    out["ms_events"] = start.elapsed_time(end) / POL_TIMED
    need(bool(final.positions.isfinite().all() and final.forces.isfinite().all()),
         f"{name}: non-finite state")
    need(not bool(final.aux[0].overflow), f"{name}: the neighbour list overflowed")
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"  ({name}) graphed {out['ms_step']:.3f} ms/step (host clock), {out['ms_events']:.3f} "
          f"(CUDA events) over {POL_TIMED} replays, no overflow, finite; peak device memory "
          f"{out['peak_gib']:.2f} GiB above the {base / 2 ** 30:.2f} held before ({card})")
    del ps, sim, qmmm, state, got, ref, final, parts
    torch.cuda.empty_cache()
    return out


def run_polarizable_cli(torch, root):
    """Phase 11(d): `python -m ai2bmd_torch` on the solvated box with
    --mm-method amoeba, then with --polarizable-mm, POL_CLI_STEPS steps
    each: exit 0, the QM/MM line naming the route and the engine, the DCD."""
    from ai2bmd_torch.io.trajectory import read_dcd

    runs = {"amoeba": (["--mm-method", "amoeba"], "AMOEBA"),
            "polarizable": (["--polarizable-mm"], "ff19SB + induced dipoles")}
    out = {}
    for name, (extra, engine) in runs.items():
        t0 = time.perf_counter()
        d = os.path.join(root, f"cli_pol_{name}")
        txt = _cli_wait(name, _cli_start([
            sys.executable, "-m", "ai2bmd_torch", "--prot-file", SOLVATED, "--log-dir", d,
            "--preeq-steps", "0", "--sim-steps", str(POL_CLI_STEPS), "--record-per-steps", "1",
            "--timestep", str(SOLV_DT_FS), *extra]))
        frames = read_dcd(os.path.join(d, "chig-preeq-traj.dcd"))
        need(frames.shape == (POL_CLI_STEPS, 17882, 3)
             and bool(torch.as_tensor(frames).isfinite().all()), f"CLI {name}: DCD {frames.shape}")
        line = [ln for ln in txt.splitlines() if ln.startswith("QM/MM:")]
        need(line and f"nl pairs, {engine} MM" in line[0], f"CLI {name}: QM/MM line {line}")
        rows = _metrics(os.path.join(d, "chig-preeq-metrics.csv"))
        out[name] = [r["ms_per_step"] for r in rows]
        print(f"  (d) {' '.join(extra)}: exit 0 in {time.perf_counter() - t0:.1f} s, "
              f"{frames.shape[0]} frames of 17882 atoms; {line[0]!r}; metrics ms/step "
              f"{out[name]}")
    return out


def run_polarizable(torch, dev, card, root, flex):
    """Phase 11: the nl pair route, the induced-dipole hybrid and AMOEBA QM/MM
    on the solvated box at 9 x 256, each one captured step; AMOEBA's MM
    float32 against float64; the CLI's two flags."""
    t_phase = time.perf_counter()
    out = {}
    out["nl"] = run_polarizable_route(torch, dev, card, root, "a", dict(pair_backend="nl"), flex)
    nl_ms = out["nl"]["parts_ms"]["list build"]
    from ai2bmd_torch.ops.neighbors import CELL_CHUNK

    print(f"  (a) the list build alone (the cell build, {CELL_CHUNK} cells a pass): {nl_ms:.3f} "
          f"ms ({card})")
    no_plain("11a")
    out["pol"] = run_polarizable_route(torch, dev, card, root, "b", dict(polarizable_mm=True),
                                       flex)
    no_plain("11b")
    syn, _ = synthetic_amoeba_box()
    out["spread_syn"] = amoeba_mm_spread(torch, dev, syn, "the synthetic box",
                                         {k: 2 * v for k, v in AMOEBA_JAX_SPREAD.items()})
    from ai2bmd_torch.host import load_protein

    out["spread_box"] = amoeba_mm_spread(torch, dev, load_protein(SOLVATED).atoms,
                                         "the solvated box",
                                         dict(solvent=FORCE_LIMIT, protein=PROTEIN_SPREAD))
    out["amoeba"] = run_polarizable_route(torch, dev, card, root, "c", dict(mm_backend="amoeba"),
                                          flex)
    no_plain("11c")
    out["cli"] = run_polarizable_cli(torch, root)
    no_plain("11d")
    print(f"  polarizable routes (17,882 atoms, 9 x 256), graphed ms/step (events): nl "
          f"{out['nl']['ms_events']:.3f}, hybrid {out['pol']['ms_events']:.3f}, AMOEBA "
          f"{out['amoeba']['ms_events']:.3f}; peak GiB nl {out['nl']['peak_gib']:.2f}, hybrid "
          f"{out['pol']['peak_gib']:.2f}, AMOEBA {out['amoeba']['peak_gib']:.2f}; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# Phase 12: AMOEBA preprocessing and pure-AMOEBA MD on examples/chig.pdb.
# The JAX package's own float32 against float64 of AmoebaMD's energy and
# forces on its solvate(build_polyalanine(2), padding=4) box (251 atoms,
# cutoff 5 A, positions moved by N(0, 0.02 A) from seed 0):
# tools/amoeba_md_f32_spread.py on the CPU (the builder's run)
AMOEBA_MD_JAX_SPREAD = dict(solvent=5.89e-5, protein=1.05e-4)     # eV/A
AMOEBA_MAX_CYC = 20           # 12(a)'s descent cycles (JAX's default protocol: 100)
AMOEBA_CHECK_CYCLES = 5       # captured cycles held against eager ones (12c)
AMOEBA_MD_STEPS = 10          # GraphedLangevin steps at 1 fs, 300 K (12d)
AMOEBA_CLI_CYC = 10           # the CLI's --max-cyc (12e)


def run_amoeba_preprocess(torch, card, root, max_cyc):
    """Phase 12(a), and --preprocess-full's AMOEBA protocol:
    Preprocessor(method="AMOEBA", max_cyc) on examples/chig.pdb at the
    default 10 A padding, on the card: the box, the list and the mesh, each
    chunk's E and RMS |F| (E must not rise), the stage's wall seconds and
    device ms, the ms of one captured descent cycle (CUDA events over 5
    replays), peak device memory, no overflow, both PDBs."""
    from ai2bmd_torch.io.pdb import read_pdb
    from ai2bmd_torch.preprocess import Preprocessor

    d = os.path.join(root, f"amoeba_pre_{max_cyc}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pre = Preprocessor(log_dir=d, max_cyc=max_cyc, method="AMOEBA")
    t0 = time.perf_counter()
    out = pre.run("examples/chig.pdb", log=lambda m: print(f"    {m}", flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    md = pre.md
    nowat = out.replace("-preeq.pdb", "-preeq-nowat.pdb")
    need(os.path.exists(out) and os.path.exists(nowat), "AMOEBA preprocessing wrote no outputs")
    box, prot = read_pdb(out), read_pdb(nowat)
    need(len(box) == md.sys.n_atoms and 0 < len(prot) < len(box)
         and bool(torch.as_tensor(box.positions).isfinite().all()),
         f"AMOEBA preprocessing outputs: {len(box)} / {len(prot)} atoms")
    e0, e1 = pre.energies["minimize"]
    chunk_e = [e for _, e, _ in pre.chunks]
    need(e1 < e0 and all(b <= a for a, b in zip(chunk_e, chunk_e[1:])),
         f"the AMOEBA minimization's energy rose: {e0} -> {chunk_e}")
    b, cycle = md._descent
    need(not bool(b[3].overflow), "the AMOEBA list overflowed")
    stage = pre.stages["AMOEBA minimize"]
    cycle_ms = cuda_ms(torch, cycle, 5)
    trace = _trace(torch, cycle, 1)
    n_kernels = sum(c for c, _ in trace.values())
    busy_ms = sum(us for _, us in trace.values()) / 1e3
    top = sorted(trace.items(), key=lambda kv: -kv[1][1])[:POL_TOP]
    res = dict(atoms=len(box), cell=[round(c, 3) for c in box.cell.tolist()],
               mesh=md.sys.pme.grid, k=md.k_max, list_cells=md.nl_grid, cutoff=md.cutoff,
               chunks=pre.chunks, e_start=e0, wall_s=wall, stage_ms=stage["ms"],
               cycle_ms=cycle_ms, cycle_kernels=n_kernels, cycle_busy_ms=busy_ms,
               peak_gib=peak, out=out)
    print(f"  {len(box)} atoms ({len(prot)} protein), cell {res['cell']}, cutoff "
          f"{md.cutoff:.2f} A + skin {md.skin}, K = {md.k_max}, list cells {md.nl_grid}, mesh "
          f"{md.sys.pme.grid}, {md.cg_iters} PCG iterations; E {e0:.3f} eV at the first cycle, "
          f"then (cycles, E eV, RMS |F| kcal/mol/A) {pre.chunks}; {max_cyc} cycles in "
          f"{wall:.2f} s wall ({stage['ms'] / 1e3:.2f} s of device time in the stage, the "
          f"capture included); one captured descent cycle {cycle_ms:.3f} ms (events, 5 "
          f"replays); peak device memory {peak:.2f} GiB; no overflow; wrote both PDBs ({card})")
    print(f"  one replayed cycle traced: {n_kernels} kernels, {busy_ms:.1f} device ms "
          f"({100 * busy_ms / cycle_ms:.0f}% of the cycle's {cycle_ms:.1f} ms); the top "
          f"{POL_TOP} (name x launches: ms): " + "; ".join(
              f"{short_name(n)} x{c}: {us / 1e3:.1f}" for n, (c, us) in top))
    return res, pre


def amoeba_md_spread(torch, dev, atoms, label, limits, n_prot, cutoff=9.0):
    """AmoebaMD's energy and forces in float32 against float64 on the card,
    the same float32 tables and one list (no kernel lies on this path):
    max|dF| on solvent and protein atoms within ``limits``, |dE|."""
    import numpy as np

    from ai2bmd_torch.physics.amoeba_md import AmoebaMD

    out, nl = {}, None
    for dt in (torch.float64, torch.float32):
        md = AmoebaMD.build(atoms, cutoff=cutoff, device=dev, dtype=dt, table_dtype=np.float32)
        P = torch.as_tensor(atoms.positions, dtype=dt, device=dev)
        nl = md.init_aux(P) if nl is None else nl
        e, f = md.energy_forces(P, nl)
        out[dt] = (float(e), f.double().cpu())
        del md, P, f
    dF = (out[torch.float32][1] - out[torch.float64][1]).abs().max(-1).values
    d_solv, d_prot = float(dF[n_prot:].max()), float(dF[:n_prot].max())
    dE = abs(out[torch.float32][0] - out[torch.float64][0])
    print(f"  (b) AmoebaMD on {label} ({len(atoms.positions)} atoms), float32 vs float64 on the "
          f"card: solvent max|dF| {d_solv:.3e} (limit {limits['solvent']:.2e}), protein "
          f"{d_prot:.3e} (limit {limits['protein']:.2e}) eV/A; |dE| {dE:.3e} eV of |E| "
          f"{abs(out[torch.float64][0]):.3f}; max|F| "
          f"{float(out[torch.float64][1].abs().max()):.3f}")
    need(d_solv <= limits["solvent"], f"{label}: AmoebaMD solvent forces part by {d_solv:.3e}")
    need(d_prot <= limits["protein"], f"{label}: AmoebaMD protein forces part by {d_prot:.3e}")
    return dict(dF_solvent=d_solv, dF_protein=d_prot, dE=dE)


def run_amoeba(torch, dev, card, root):
    """Phase 12: AMOEBA preprocessing of Chignolin and pure-AMOEBA MD on the
    box, on the card: (a) the Preprocessor, (b) float32 against float64, (c)
    captured descent cycles against eager ones, (d) GraphedLangevin steps,
    (e) the CLI's --preprocess-method AMOEBA."""
    import numpy as np

    from ai2bmd_torch.io import build as B
    from ai2bmd_torch.io.pdb import read_pdb
    from ai2bmd_torch.preprocess import solvate
    from ai2bmd_torch.utils.tree import tree_clone, tree_copy_

    t_phase = time.perf_counter()
    res, pre = run_amoeba_preprocess(torch, card, root, AMOEBA_MAX_CYC)
    md = pre.md
    box = read_pdb(res["out"])
    n_prot = len(read_pdb(res["out"].replace("-preeq.pdb", "-preeq-nowat.pdb")))
    small = solvate(B.build_polyalanine(2), padding=4.0, seed=0)      # the tool's box
    small.positions = small.positions + np.random.default_rng(0).normal(
        0.0, 0.02, small.positions.shape)
    res["spread_small"] = amoeba_md_spread(torch, dev, small, "the ala2 box", {
        k: 2 * v for k, v in AMOEBA_MD_JAX_SPREAD.items()}, 32, cutoff=5.0)
    res["spread_box"] = amoeba_md_spread(torch, dev, box, "the minimized Chignolin box", dict(
        solvent=FORCE_LIMIT, protein=FORCE_LIMIT), n_prot)

    # (c) captured descent cycles against eager cycles from the same state
    b, cycle = md._descent
    P0 = torch.as_tensor(box.positions, dtype=torch.float32, device=dev)
    nl0 = md.init_aux(P0)
    lr = 1e-3
    b[0].copy_(P0)
    b[1].fill_(lr)
    tree_copy_(b[3], nl0)
    eager = tree_clone(b)
    steps_g, steps_e, e_g, e_e = [], [], [], []
    for _ in range(AMOEBA_CHECK_CYCLES):
        cycle()
        md.descent_cycle(eager)
        steps_g.append(float(b[1]))
        steps_e.append(float(eager[1]))
        e_g.append(float(b[2]))
        e_e.append(float(eager[2]))
    dx = float((b[0] - eager[0]).abs().max())
    de = max(abs(x - y) for x, y in zip(e_g, e_e))
    print(f"  (c) {AMOEBA_CHECK_CYCLES} captured descent cycles vs eager ones from the minimized "
          f"box: step sizes {steps_g} / {steps_e}, max|dx| {dx:.3e} A (limit {FORCE_LIMIT}), "
          f"max|dE| {de:.3e} eV of {abs(e_e[-1]):.3f}")
    need(steps_g == steps_e, "captured and eager cycles took other decisions")
    need(dx <= FORCE_LIMIT, f"captured descent cycles part from eager ones by {dx:.3e} A")
    res.update(replay_dx=dx, replay_de=de)

    # (d) Langevin steps at 1 fs and 300 K, replays of one captured step
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    state = md.initial_state(box.positions, gen, temp_K=300.0)
    graph = md.make_step_fn(state, gen, timestep_fs=1.0, temp_K=300.0)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    energies = []
    start.record()
    for _ in range(AMOEBA_MD_STEPS):
        final = graph.run(1)
        energies.append(final.energy.clone())
    end.record()
    torch.cuda.synchronize()
    res["md_ms"] = start.elapsed_time(end) / AMOEBA_MD_STEPS
    energies = torch.stack(energies).cpu()
    need(bool(final.positions.isfinite().all() and energies.isfinite().all()),
         "AMOEBA MD: non-finite positions or energies")
    need(not bool(final.aux.overflow), "AMOEBA MD: the list overflowed")
    print(f"  (d) AmoebaMD: initial state + capture (3 warm-up steps) {t_capture:.1f} s; "
          f"{AMOEBA_MD_STEPS} GraphedLangevin steps at 1 fs, 300 K: {res['md_ms']:.3f} ms/step "
          f"(events); E {float(energies[0]):.3f} -> {float(energies[-1]):.3f} eV, finite, no "
          f"overflow ({card})")
    del graph, state, final, eager
    torch.cuda.empty_cache()

    # (e) the CLI
    t0 = time.perf_counter()
    d = os.path.join(root, "amoeba_cli")
    shutil.rmtree(d, ignore_errors=True)
    txt = _cli_wait("amoeba-preprocess", _cli_start([
        sys.executable, "-m", "ai2bmd_torch", "--prot-file", "examples/chig.pdb", "--log-dir", d,
        "--preprocess", "--preprocess-method", "AMOEBA", "--max-cyc", str(AMOEBA_CLI_CYC),
        "--preeq-steps", "0", "--sim-steps", "2", "--record-per-steps", "1", "--timestep",
        str(SOLV_DT_FS)]))
    lines = [ln for ln in txt.splitlines() if "AMOEBA minimization" in ln or "RMS |F|" in ln]
    need(len(lines) == 2 and f"[{AMOEBA_CLI_CYC}/{AMOEBA_CLI_CYC}]" in lines[1],
         f"the CLI's AMOEBA lines: {lines}")
    need(all(os.path.exists(os.path.join(d, f"chig-preeq{s}.pdb")) for s in ("", "-nowat")),
         "the CLI wrote no -preeq pair")
    need("Simulation finished!" in txt, "the CLI run did not finish")
    print(f"  (e) --preprocess --preprocess-method AMOEBA --max-cyc {AMOEBA_CLI_CYC}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, the pair written; {lines[1].strip()!r}")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  AMOEBA preprocessing ({res['atoms']} atoms, {AMOEBA_MAX_CYC} cycles): "
          f"{res['wall_s']:.2f} s wall, {res['cycle_ms']:.3f} ms a captured cycle, peak "
          f"{res['peak_gib']:.2f} GiB; AmoebaMD {res['md_ms']:.3f} ms/step; phase 12 took "
          f"{res['phase_s']:.1f} s ({card})")
    return res


def no_plain(phase):
    """Every phase but 9d's plain route must keep LAUNCHES["plain_edge_core"]
    at 0; reset_launches() leaves it alone, so it counts the whole phase."""
    from ai2bmd_torch.ops import LAUNCHES

    n = LAUNCHES["plain_edge_core"]
    print(f"  phase {phase}: plain_edge_core {n}")
    need(n == 0, f"phase {phase}: {n} edge cores took the plain route")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stop-after", type=int, choices=(2, 3),
                    help="end after this phase, without the final line")
    ap.add_argument("--cap-hash", action="store_true",
                    help="print only K4's output hashes and device times on phase 3's "
                         "inputs, without the final line (to compare K4 across commits)")
    ap.add_argument("--edge-hash", action="store_true",
                    help="print only K1, K2, K3, K7 and K8's output hashes on phase 3's "
                         "fragment-shape inputs, without the final line (to compare them "
                         "across commits)")
    ap.add_argument("--layer-hash", action="store_true",
                    help="print only K5 and K6's output hashes and device times on phase 3's "
                         "fragment-shape inputs, without the final line (to compare them "
                         "across commits)")
    ap.add_argument("--solvated-only", action="store_true",
                    help="after the build, run only phases 9 and 10 (the solvated slices: QM/MM, "
                         "preprocessing, solvated replicas), without the final line")
    ap.add_argument("--polarizable-only", action="store_true",
                    help="after the build, run only phase 11 (the nl route, the induced-dipole "
                         "hybrid and AMOEBA QM/MM on the solvated box), without the final line")
    ap.add_argument("--amoeba-only", action="store_true",
                    help="after the build, run only phase 12 (AMOEBA preprocessing and "
                         "pure-AMOEBA MD of Chignolin's box), without the final line")
    ap.add_argument("--preprocess-full", action="store_true",
                    help="after the build, run only Preprocessor() with its default stages on "
                         "examples/chig.pdb and then the AMOEBA protocol (100 cycles), and print "
                         "each one's wall seconds, without the final line")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ai2bmd_torch.host import example_pdb, load_protein
    from ai2bmd_torch.ops import _build
    from ai2bmd_torch.utils.device import require_cuda

    print("== 1. environment")
    print(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}")
    dev = require_cuda()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    card = nvidia_smi()
    print(f"  nvcc: {nvcc}\n  triton {triton_version}\n  device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}; nvidia-smi: {card}")
    print(f"  tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    print("== 2. build")
    t0 = time.perf_counter()
    _build.library()
    print(f"  built {_build.BUILD_INFO['path']} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_INFO['seconds']:.1f} s, cached {_build.BUILD_INFO['cached']})")
    for line in _build.BUILD_INFO.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    if args.stop_after == 2:
        return
    if args.cap_hash:
        cap_hashes(torch, dev, load_protein(example_pdb("chig")), timed=True)
        return
    if args.edge_hash:
        edge_hashes(torch, dev)
        return
    if args.layer_hash:
        layer_hashes(torch, dev, timed=True)
        return
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_user")
    if args.preprocess_full:
        print("== preprocessing with the default stages")
        run_preprocess_full(torch, card, root)
        return
    if args.amoeba_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 12. AMOEBA preprocessing and pure-AMOEBA MD (alone)")
        run_amoeba(torch, dev, card, root)
        return
    if args.polarizable_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 11. the polarizable routes (alone)")
        run_polarizable(torch, dev, card, root, {})
        return
    if args.solvated_only:
        shutil.rmtree(root, ignore_errors=True)
        print("== 9. the solvated slice (alone)")
        solv = run_solvated(torch, dev, load_protein(example_pdb("chig")), card, root,
                            float("nan"))
        print("== 10. preprocessing and solvated replicas")
        run_preprocessing_and_replicas(torch, dev, card, root, solv["flex"])
        return

    print("== 3. kernels against their plain versions")
    results = {n: {"max_abs_err": 0.0} for n in KERNELS}
    check_tf32x3(torch, dev)
    check_layer_kernels(torch, dev, results)
    check_edge_kernels(torch, dev, results)
    prot = load_protein(example_pdb("chig"))
    check_cap_kernel(torch, dev, prot, results)
    # on the H100 the profiler's device times fail for the rest of the
    # process from K7 at A = 752 on: K4 and K5/K6 at the whole-molecule
    # shapes are timed before it
    whole = {A: {} for _, A in WHOLE_SHAPES}
    check_whole_layer_kernels(torch, dev, whole)
    check_whole_molecule_kernels(torch, dev, whole)
    check_head_widths(torch, dev, results)
    report_occupancy(torch, results, whole)
    cublas_yardstick(torch, dev, results)
    if args.stop_after == 3:
        return

    print("== 4. the slice: Chignolin, ViSNet 9 x 256, fragment MD, edge-core kernels K1-K3")
    launches, ms_step, graphed, ref = run_slice(torch, dev, prot, card)
    no_plain("4")
    print("== 4b. the same slice through the full-layer kernels K5/K6")
    launches_fl, ms_step_fl, graphed_fl = run_fused_slice(torch, dev, prot, card, ref)
    no_plain("4b")
    print("== 5. the replica ensemble: 64 Chignolin replicas, 9 x 256, remat=True (K1, K7, K8)")
    launches_ens = run_ensemble(torch, dev, prot, card, ref)
    no_plain("5")
    print("== 6. the user-facing path: ProteinSimulation and the CLI (python -m ai2bmd_torch)")
    shutil.rmtree(root, ignore_errors=True)
    run_user_library(torch, dev, root, ref)
    cli_ms = run_user_cli(torch, root, graphed["ms_step"], card)
    no_plain("6")
    print("== 7. whole-molecule mode: converted checkpoint, Chignolin (A = 176) and abd "
          "(A = 752) as one molecule, 9 x 256")
    wm = run_whole_molecule(torch, dev, prot, card, root)
    no_plain("7")
    print("== 8. the repaired faults: the tiny preset on the card, warm_caps=False, "
          "--no-solvent on a solvated input")
    cold_ms = run_faults(torch, dev, card, root, graphed["ms_step"])
    no_plain("8")
    print("== 9. the solvated slice: PME in fragment mode, QM/MM of the solvated Chignolin box "
          "(17,882 atoms) at 9 x 256, the CLI on it, 64-channel heads and the plain route")
    solv = run_solvated(torch, dev, prot, card, root, graphed["ms_step"])
    print("== 10. preprocessing (solvate, minimize, heat, NVT, NPT) of Chignolin on the card, the "
          "CLI's --solvent route, SolvatedReplicaEnsemble (4 replicas of the box, 9 x 256), the "
          "CLI's --replicas route on the box")
    p10 = run_preprocessing_and_replicas(torch, dev, card, root, solv["flex"])
    print("== 11. the polarizable routes on the solvated box at 9 x 256: the nl pair route with "
          "its list built inside the captured step, the induced-dipole hybrid, AMOEBA QM/MM; the "
          "CLI's --mm-method amoeba and --polarizable-mm")
    p11 = run_polarizable(torch, dev, card, root, solv["flex"])
    print("== 12. AMOEBA preprocessing of Chignolin (Preprocessor(method=\"AMOEBA\"), 3,615 "
          "atoms) and pure-AMOEBA MD on the box: float32 vs float64, captured descent cycles vs "
          "eager, GraphedLangevin steps, the CLI's --preprocess-method AMOEBA")
    from ai2bmd_torch.ops import LAUNCHES, reset_launches

    reset_launches()
    p12 = run_amoeba(torch, dev, card, root)
    amoeba_launches = dict(LAUNCHES)
    no_plain("12")
    need(not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "JAX was imported")
    need(not any(m.startswith("ai2bmd_tpu") for m in sys.modules), "ai2bmd_tpu was imported")

    for n in ("vislayer_fwd", "vislayer_bwd"):
        launches[n] = launches_fl[n]
    for n in ("edge_bwd_msg_rc", "edge_bwd_upd_rc"):
        launches[n] = launches_ens[n]
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "bound_peak": BOUND_PEAK[n], **finish(results[n])}
               for n, (src, rep) in KERNELS.items()]
    for k in kernels:      # the whole-molecule path's launches and shapes (phases 7 and 3)
        if k["name"] in EDGE_NAMES or k["name"] in LAYER_PATH:
            launched = (wm["fused_launches"] if k["name"] in LAYER_PATH else
                        wm["abd_launches"][True] if k["name"].endswith("_rc") else wm["launches"])
            k["whole_molecule"] = {
                "launches": launched[k["name"]],
                **{f"A={A}": finish(res[k["name"]]) for A, res in whole.items()}}
    for k in kernels:      # the solvated path's launches (phase 9b, one evaluation)
        if k["name"] in solv["flex"]["launches"]:
            k["solvated_launches"] = solv["flex"]["launches"][k["name"]]
            k["pme_fragment_launches"] = solv["pme_launches"][k["name"]]
    for k in kernels:      # phase 10c: per replica-step of the solvated ensemble
        k["solvated_replica_launches"] = p10["ens"]["launches_per_eval"][k["name"]]
    for k in kernels:      # phase 11: one evaluation on each polarizable route
        k["polarizable_launches"] = {route: p11[key]["launches"].get(k["name"], 0)
                                     for route, key in (("nl", "nl"), ("hybrid", "pol"),
                                                        ("amoeba", "amoeba"))}
    for k in kernels:      # phase 12: AMOEBA preprocessing and MD evaluate no ViSNet
        k["amoeba_md_launches"] = amoeba_launches.get(k["name"], 0)
        need(k["amoeba_md_launches"] == 0, f"phase 12 launched {k['name']}")
    print("== 13. results")
    print(f"  ms/step eager {ms_step:.3f} (K1-K3), {ms_step_fl:.3f} (K5/K6); graphed "
          f"{graphed['ms_step']:.3f} (K1-K3), {graphed_fl['ms_step']:.3f} (K5/K6); CLI steady "
          f"{cli_ms:.3f} (K1-K3) (smoke); whole molecule (A = 176) graphed "
          f"{wm['graphed']['ms_step']:.3f} (events {wm['graphed']['ms_events']:.3f}) K1-K3, "
          f"{wm['fused_graphed']['ms_step']:.3f} (events {wm['fused_graphed']['ms_events']:.3f}) "
          f"K5/K6; CLI steady {wm['cli_ms']:.3f} K1-K3, {wm['fused_cli_ms']:.3f} K5/K6; abd peak "
          f"GiB {wm['abd_peak_gib']}; warm_caps=False graphed {cold_ms:.3f}; 'pme' graphed "
          f"{solv['pme_ms']:.3f}; solvated graphed {solv['flex']['ms_step']:.3f} (events "
          f"{solv['flex']['ms_events']:.3f}), rigid water {solv['rigid']['ms_step']:.3f}; "
          f"preprocessing ms per step {p10['pre']['stage_ms']}; solvated replica-step "
          f"{p10['ens']['ms']:.3f} ({N_SOLV_REPLICAS} replicas); polarizable routes graphed "
          f"(events) nl {p11['nl']['ms_events']:.3f}, hybrid {p11['pol']['ms_events']:.3f}, "
          f"AMOEBA {p11['amoeba']['ms_events']:.3f}; AMOEBA preprocessing "
          f"{p12['wall_s']:.2f} s ({AMOEBA_MAX_CYC} cycles, {p12['cycle_ms']:.3f} ms a captured "
          f"cycle), AmoebaMD {p12['md_ms']:.3f} ms/step; "
          f"{time.perf_counter() - T_START:.0f} s since start")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
